"""The reference's streaming tracker: frames in, one result a frame after
the two warm-up frames, with the state the reference carries
(``ParallelVideoPyr.cpp:794-841``): the previous gray frame and the
previous diff, which with ``faithful_prev_diff`` is the warped diff of the
last flow step. Pyramids are rebuilt for every pair; the program reuses
them, which gives the same values.

The configuration is the ``video`` object of a configuration file under
``oft_bench/configs/``: every field of the port's ``VideoConfig`` by name.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from oft_bench.reference import plain


class StreamReference:
    """``push`` frame by frame; ``None`` for the two warm-up frames."""

    def __init__(self, video: Dict, device, precision: str = "ieee"):
        self.pre = video["preprocess"]
        self.flow = video["flow"]
        self.gesture = video["gesture"]
        self.feedback = bool(video["faithful_prev_diff"])
        self.device = torch.device(device)
        self.precision = precision
        self._resizers: Dict[Tuple[int, int], plain.ResizeBlur] = {}
        self.reset()

    def reset(self) -> None:
        self.prev_gray = None
        self.prev_diff = None

    def preprocess(self, frame: torch.Tensor) -> torch.Tensor:
        pre, size = self.pre, tuple(self.pre["size"])
        if pre["faithful_uint8"]:
            x = plain.resize_cubic(frame, size, self.precision)
            x = plain.gaussian_blur(x, pre["blur_ksize"], pre["blur_sigma"])
            return plain.bgr_to_gray(x)
        x = plain.bgr_to_gray(frame.to(torch.float32))
        key = tuple(x.shape[-2:])
        if key not in self._resizers:
            self._resizers[key] = plain.ResizeBlur(
                key, size, pre["blur_ksize"], pre["blur_sigma"], self.device, self.precision)
        return self._resizers[key](x)

    def push(self, frame) -> Optional[Tuple[torch.Tensor, torch.Tensor, plain.Gesture]]:
        frame = torch.as_tensor(np.asarray(frame)).to(self.device)
        gray = self.preprocess(frame)
        if self.prev_gray is None:
            self.prev_gray = gray
            return None
        diff = plain.diff_features(gray, self.prev_gray, self.pre)
        self.prev_gray = gray
        if self.prev_diff is None:
            self.prev_diff = diff
            return None
        levels = self.flow["levels"] or plain.max_pyramid_levels(*diff.shape[-2:])
        pyr1 = plain.gaussian_pyramid(self.prev_diff, levels)
        pyr2 = plain.gaussian_pyramid(diff, levels)
        u, v, _, warped = plain.coarse_to_fine(pyr1, pyr2, self.flow, need_images=self.feedback)
        self.prev_diff = warped if self.feedback else diff
        return u, v, plain.detect_gesture(u, v, self.gesture)


def history(video: Dict) -> Optional[int]:
    """How many frames up to and including a frame its result depends on:
    3 without the warped-diff feedback (two grays and two diffs), else
    every frame since the reset (None)."""
    return None if video["faithful_prev_diff"] else 3


def results_at(video: Dict, frame_at, wanted: Iterable[int], device,
               precision: str = "ieee") -> Iterator[Tuple[int, tuple]]:
    """(j, result) for each frame index j in ``wanted``: the reference
    replays the frames that j's result depends on, ``frame_at(i)`` giving
    frame i, counted from the reset before j's result (from 2 on) where
    the whole history counts, else from any frame on (``i`` may then be
    below 0)."""
    wanted = sorted(set(wanted))
    ref = StreamReference(video, device, precision)
    span = history(video)
    if span is None:
        ref.reset()
        out = None
        i = 0
        for j in wanted:
            while i <= j:
                out = ref.push(frame_at(i))
                i += 1
            yield j, out
        return
    for j in wanted:
        ref.reset()
        out = None
        for i in range(j - span + 1, j + 1):
            out = ref.push(frame_at(i))
        yield j, out
