"""Video gesture-tracking pipeline (reference flagship,
ParallelVideoPyr.cpp:730-905; port of optical_flow_tpu/pipeline/video.py).

Streaming: ``push`` one frame at a time, preserving the reference's
sequential state. With ``faithful_prev_diff=False`` (the fast preset) each
frame's Gaussian pyramid is built once and reused for its two pairs
((t-1, t) and (t, t+1)). Batched: ``run_batched`` solves N-2 pairs from N
frames in one pass. Everything runs on the pipeline's ``device``; the
kernels are used there by the config's ``impl``/``pyr_impl`` choices.

With a ``mesh`` (parallel/mesh.py) every flow step goes through the
mesh-sharded controller (parallel/sharded_flow.py), where the JAX
pipeline sends it; the pipeline's device is the mesh's home device, where
preprocessing, the pyramids and the gesture run.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from optical_flow_tpu_torch.config import VideoConfig
from optical_flow_tpu_torch.flow.coarse_to_fine import (
    coarse_to_fine_pyramids,
    coarse_to_fine_with_images,
)
from optical_flow_tpu_torch.ops.pyramid import gaussian_pyramid, max_pyramid_levels
from optical_flow_tpu_torch.parallel.mesh import canonical_device
from optical_flow_tpu_torch.parallel.sharded_flow import (
    sharded_coarse_to_fine,
    sharded_coarse_to_fine_pyramids,
    sharded_coarse_to_fine_with_images,
)
from optical_flow_tpu_torch.pipeline.gesture import GestureResult, detect_gesture
from optical_flow_tpu_torch.pipeline.preprocess import (
    ResizeBlur,
    diff_features,
    gray_f32,
    preprocess_frame,
)


class FrameResult(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    gesture: GestureResult


class VideoPipeline:
    """Gesture tracking over a frame stream on one device, or with the flow
    tiled over a mesh whose home device is ``device``.

    ``device`` is the card (``"cuda"``) unless the caller names another;
    without a card it raises rather than run on the CPU. The preprocess
    head follows ``config.preprocess.faithful_uint8``: the reference's uint8
    chain, or the float ``ResizeBlur`` head.

    Usage:
        pipe = VideoPipeline(VideoConfig.fast())                # on the card
        pipe = VideoPipeline(VideoConfig(), device="cpu")       # plain, on the CPU
        for result in pipe.run(frames):   # frames: iterable of HxWx3 uint8
            if bool(result.gesture.detected): ...
    """

    def __init__(self, config: VideoConfig = VideoConfig(), device="cuda", mesh=None):
        self.config = config
        self.device = canonical_device(device)
        if mesh is not None and mesh.home != self.device:
            raise ValueError(
                f"the pipeline's device {self.device} is not the mesh's home device {mesh.home}"
            )
        self.mesh = mesh
        # one resize+blur operator (its factors on the device) per input size
        self._resizers: Dict[Tuple[int, int], ResizeBlur] = {}
        self._reuse_pyramids = not config.faithful_prev_diff
        self.reset()

    def reset(self) -> None:
        self._prev_gray = None
        self._prev_diff = None
        self._prev_pyr = None
        self._frame_idx = 0

    # --- checkpoint / resume ----------------------------------------------

    def state(self) -> dict:
        """Resumable streaming state: the previous gray frame and diff
        (ParallelVideoPyr.cpp:794-822) and the frame index."""
        return {
            "prev_gray": None if self._prev_gray is None else self._prev_gray.clone(),
            "prev_diff": None if self._prev_diff is None else self._prev_diff.clone(),
            "frame_idx": self._frame_idx,
        }

    def restore(self, state: dict) -> None:
        """Resume from ``state()`` (or ``convert.pipeline_state_from_jax``)."""

        def dev(x):
            return None if x is None else torch.as_tensor(x).to(self.device)

        self._prev_gray = dev(state["prev_gray"])
        self._prev_diff = dev(state["prev_diff"])
        # the cached pyramid is derived state: rebuild it (deterministic)
        self._prev_pyr = (
            self._build_pyr(self._prev_diff)
            if (self._reuse_pyramids and self._prev_diff is not None)
            else None
        )
        self._frame_idx = int(state["frame_idx"])

    # --- stages -------------------------------------------------------------

    def _preprocess(self, frame) -> torch.Tensor:
        frame = torch.as_tensor(frame).to(self.device)
        if self.config.preprocess.faithful_uint8:
            return preprocess_frame(frame, self.config.preprocess)
        x = gray_f32(frame)
        key = tuple(x.shape[-2:])
        if key not in self._resizers:
            self._resizers[key] = ResizeBlur(key, self.config.preprocess).to(self.device)
        return self._resizers[key](x)

    def _diff(self, cur_gray, prev_gray):
        return diff_features(cur_gray, prev_gray, self.config.preprocess)

    def _build_pyr(self, diff):
        return tuple(
            gaussian_pyramid(
                diff, max_pyramid_levels(diff.shape), impl=self.config.flow.pyr_impl
            )
        )

    def _result(self, u, v) -> FrameResult:
        return FrameResult(u, v, detect_gesture(u, v, self.config.gesture))

    def _flow_step(self, prev_diff, diff):
        levels = max_pyramid_levels(diff.shape)
        need = self.config.faithful_prev_diff
        if self.mesh is not None:
            u, v, _, warped_diff = sharded_coarse_to_fine_with_images(
                prev_diff, diff, self.mesh, levels, config=self.config.flow, _need_images=need,
            )
        else:
            u, v, _, warped_diff = coarse_to_fine_with_images(
                prev_diff, diff, levels, config=self.config.flow, _need_images=need,
            )
        next_prev = warped_diff if need else diff
        return self._result(u, v), next_prev

    def _flow_step_pyr(self, prev_pyr, pyr):
        if self.mesh is not None:
            u, v, _, _ = sharded_coarse_to_fine_pyramids(
                prev_pyr, pyr, self.mesh, config=self.config.flow
            )
        else:
            u, v, _, _ = coarse_to_fine_pyramids(prev_pyr, pyr, config=self.config.flow)
        return self._result(u, v)

    # --- host loops -----------------------------------------------------------

    def push(self, frame) -> Optional[FrameResult]:
        """Feed one frame; returns a FrameResult once warmed up (two warm-up
        frames: one for prevFrame, one for prevDiff)."""
        gray = self._preprocess(frame)
        self._frame_idx += 1
        if self._prev_gray is None:
            self._prev_gray = gray
            return None
        diff = self._diff(gray, self._prev_gray)
        self._prev_gray = gray
        if self._reuse_pyramids:
            pyr = self._build_pyr(diff)
            if self._prev_diff is None:
                self._prev_diff, self._prev_pyr = diff, pyr
                return None
            result = self._flow_step_pyr(self._prev_pyr, pyr)
            self._prev_diff, self._prev_pyr = diff, pyr
            return result
        if self._prev_diff is None:
            self._prev_diff = diff
            return None
        result, self._prev_diff = self._flow_step(self._prev_diff, diff)
        return result

    def run(self, frames: Iterable[np.ndarray]) -> Iterator[FrameResult]:
        """Streaming mode over an iterable of frames (resets first)."""
        self.reset()
        for frame in frames:
            result = self.push(frame)
            if result is not None:
                yield result

    def run_batched(self, frames) -> FrameResult:
        """Batched mode: frames (N, H, W, 3) -> FrameResult with a leading
        N-2 batch axis; one pyramid per diff, the pairs are batch slices.
        Requires faithful_prev_diff=False."""
        if self.config.faithful_prev_diff:
            raise ValueError(
                "batched mode needs faithful_prev_diff=False (the warped-diff "
                "feedback is a sequential dependency)"
            )
        grays = self._preprocess(frames)
        diffs = self._diff(grays[1:], grays[:-1])
        if self.mesh is not None:
            u, v = sharded_coarse_to_fine(
                diffs[:-1], diffs[1:], self.mesh, max_pyramid_levels(diffs.shape),
                config=self.config.flow,
            )
            return self._result(u, v)
        pyr = self._build_pyr(diffs)
        prev = tuple(p[:-1] for p in pyr)
        cur = tuple(p[1:] for p in pyr)
        return self._flow_step_pyr(prev, cur)
