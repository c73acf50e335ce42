"""Video gesture-tracking pipeline (reference flagship,
ParallelVideoPyr.cpp:730-905; port of optical_flow_tpu/pipeline/video.py).

Streaming: ``push`` one frame at a time, preserving the reference's
sequential state. With ``faithful_prev_diff=False`` (the fast preset) each
frame's Gaussian pyramid is built once and reused for its two pairs
((t-1, t) and (t, t+1)). ``run`` feeds ``push`` from a background prefetcher
(io/prefetch.py). Chunked: ``run_chunked`` solves a chunk of frames per
step, with the last gray frame and diff pyramid carried across chunks.
Batched: ``run_batched`` solves N-2 pairs from N frames in one pass.
Everything runs on the pipeline's ``device``; the kernels are used there by
the config's ``impl``/``pyr_impl`` choices.

On a card without a mesh, the steady ``push`` step and the steady chunk
step are captured once per input shape into CUDA graphs and replayed
(pipeline/graphs.py), the counterpart of the JAX package's jitted stages;
the warm-up frames and the first frame (or chunk) of a shape run eagerly.
``graph=False`` keeps every step eager. A frame from the host reaches the
card through pinned memory without blocking the host.

With a ``mesh`` (parallel/mesh.py) every flow step goes through the
mesh-sharded controller (parallel/sharded_flow.py), where the JAX
pipeline sends it; the pipeline's device is the mesh's home device, where
preprocessing, the pyramids and the gesture run. Mesh and CPU pipelines
stay eager.
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
from optical_flow_tpu_torch.io.prefetch import (
    pinned_copy,
    prefetch_chunks_to_device,
    prefetch_to_device,
)
from optical_flow_tpu_torch.io.video_reader import read_frames
from optical_flow_tpu_torch.ops.pyramid import gaussian_pyramid, max_pyramid_levels
from optical_flow_tpu_torch.parallel.mesh import canonical_device
from optical_flow_tpu_torch.parallel.sharded_flow import (
    sharded_coarse_to_fine,
    sharded_coarse_to_fine_pyramids,
    sharded_coarse_to_fine_with_images,
)
from optical_flow_tpu_torch.pipeline.gesture import GestureResult, detect_gesture
from optical_flow_tpu_torch.pipeline.graphs import StepGraph, run_on_side_stream
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


def _inline_chunks(frames: Iterable, chunk_size: int) -> Iterator[torch.Tensor]:
    """Frames stacked into (chunk_size, ...) host batches, the last maybe
    shorter: ``run_chunked`` without a prefetcher."""
    buf: list = []
    for f in frames:
        buf.append(np.asarray(f))
        if len(buf) == chunk_size:
            yield torch.from_numpy(np.stack(buf))
            buf = []
    if buf:
        yield torch.from_numpy(np.stack(buf))


class VideoPipeline:
    """Gesture tracking over a frame stream on one device, or with the flow
    tiled over a mesh whose home device is ``device``.

    ``device`` is the card (``"cuda"``) unless the caller names another;
    without a card it raises rather than run on the CPU. The preprocess
    head follows ``config.preprocess.faithful_uint8``: the reference's uint8
    chain, or the float ``ResizeBlur`` head. ``graph`` (default True)
    replays the steady steps as CUDA graphs on a card without a mesh; the
    results are the eager steps' bit for bit.

    Usage:
        pipe = VideoPipeline(VideoConfig.fast())                # on the card
        pipe = VideoPipeline(VideoConfig(), device="cpu")       # plain, on the CPU
        for result in pipe.run(frames):   # frames: iterable of HxWx3 uint8
            if bool(result.gesture.detected): ...
    """

    def __init__(self, config: VideoConfig = VideoConfig(), device="cuda", mesh=None,
                 graph: bool = True):
        self.config = config
        self.device = canonical_device(device)
        if mesh is not None and mesh.home != self.device:
            raise ValueError(
                f"the pipeline's device {self.device} is not the mesh's home device {mesh.home}"
            )
        self.mesh = mesh
        self.graph = bool(graph) and self.device.type == "cuda" and mesh is None
        # one resize+blur operator (its factors on the device) per input size
        self._resizers: Dict[Tuple[int, int], ResizeBlur] = {}
        # the captured steady steps, by step and shapes of input and state
        self._graphs: Dict[tuple, StepGraph] = {}
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

    def _carried(self) -> tuple:
        """The state a steady step takes: (gray, *diff pyramid) with pyramid
        reuse, else (gray, diff)."""
        if self._reuse_pyramids:
            return (self._prev_gray, *self._prev_pyr)
        return (self._prev_gray, self._prev_diff)

    def _carry(self, state) -> None:
        """Keep a steady step's new state (``_carried``'s layout)."""
        self._prev_gray = state[0]
        self._prev_diff = state[1]
        if self._reuse_pyramids:
            self._prev_pyr = tuple(state[1:])

    # --- stages -------------------------------------------------------------

    def _upload(self, frame) -> torch.Tensor:
        """A frame (or a batch) as a tensor on the pipeline's device. From the
        host to a card it is staged in pinned memory and copied without
        blocking the host. A read-only host array (``np.frombuffer`` of a
        socket payload) is copied, never wrapped in place."""
        if isinstance(frame, torch.Tensor) and frame.device == self.device:
            return frame
        if self.device.type == "cuda" and not (isinstance(frame, torch.Tensor) and frame.is_cuda):
            return pinned_copy(frame).to(self.device, non_blocking=True)
        if not isinstance(frame, torch.Tensor):
            a = np.asarray(frame)
            if not (a.flags.writeable and a.flags.c_contiguous):
                a = np.array(a, order="C")
            frame = torch.from_numpy(a)
        return frame.to(self.device)

    def _preprocess(self, frame) -> torch.Tensor:
        frame = self._upload(frame)
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

    def _flow_from_pyr_pairs(self, prev_pyr, pyr):
        """Flow and gesture of the pairs (prev_pyr[k], pyr[k]): one frame pair,
        or a batch of them as the pyramids' leading axis."""
        if self.mesh is not None:
            u, v, _, _ = sharded_coarse_to_fine_pyramids(
                prev_pyr, pyr, self.mesh, config=self.config.flow
            )
        else:
            u, v, _, _ = coarse_to_fine_pyramids(prev_pyr, pyr, config=self.config.flow)
        return self._result(u, v)

    # --- steady steps: step(x, *state) -> (result, new state) ----------------

    def _step_pyr(self, frame, prev_gray, *prev_pyr):
        """One frame with pyramid reuse; the state is (gray, *diff pyramid)."""
        gray = self._preprocess(frame)
        diff = self._diff(gray, prev_gray)
        pyr = self._build_pyr(diff)
        return self._flow_from_pyr_pairs(prev_pyr, pyr), (gray, *pyr)

    def _step_images(self, frame, prev_gray, prev_diff):
        """One frame without reuse (the warped diff may be fed back); the
        state is (gray, diff)."""
        gray = self._preprocess(frame)
        diff = self._diff(gray, prev_gray)
        result, next_prev = self._flow_step(prev_diff, diff)
        return result, (gray, next_prev)

    def _chunk_first(self, frames):
        """First chunk: N raw frames -> N-2 results + carry (gray, *diff
        pyramid), with no prior state: the streaming warm-up (two frames
        consumed before the first result, ParallelVideoPyr.cpp:794-822)."""
        grays = self._preprocess(frames)
        diffs = self._diff(grays[1:], grays[:-1])
        pyr = self._build_pyr(diffs)
        prev = tuple(p[:-1] for p in pyr)
        cur = tuple(p[1:] for p in pyr)
        return self._flow_from_pyr_pairs(prev, cur), (grays[-1], *(p[-1] for p in pyr))

    def _chunk_step(self, frames, prev_gray, *prev_pyr):
        """Steady chunk: N raw frames and the carry -> N results + new carry.
        The results are the pair sequence ``push`` produces, with one step
        per chunk instead of one per frame."""
        grays = self._preprocess(frames)
        all_grays = torch.cat([prev_gray[None], grays], dim=0)
        diffs = self._diff(all_grays[1:], all_grays[:-1])
        pyr = self._build_pyr(diffs)
        prev = tuple(torch.cat([pp[None], p[:-1]], dim=0) for pp, p in zip(prev_pyr, pyr))
        return self._flow_from_pyr_pairs(prev, pyr), (grays[-1], *(p[-1] for p in pyr))

    def _run_step(self, step, x, state):
        """``step(x, *state)``: eager, or through its CUDA graph for these
        shapes (captured after an eager warm-up on this first call)."""
        if not self.graph:
            return step(self._upload(x), *state)
        if not (isinstance(x, torch.Tensor) and x.is_cuda):
            x = pinned_copy(x)  # a host frame: copied to the card without blocking
        key = (step.__name__, tuple(x.shape), x.dtype,
               tuple((tuple(s.shape), s.dtype) for s in state))
        g = self._graphs.get(key)
        if g is None:
            x = x.to(self.device, non_blocking=True)
            result, new = run_on_side_stream(step, x, *state, device=self.device)
            self._graphs[key] = StepGraph(step, x, new)
            return result, new
        return g.replay(x, state)

    # --- host loops -----------------------------------------------------------

    def push(self, frame) -> Optional[FrameResult]:
        """Feed one frame; returns a FrameResult once warmed up (two warm-up
        frames: one for prevFrame, one for prevDiff)."""
        self._frame_idx += 1
        if self._prev_gray is None:
            self._prev_gray = self._preprocess(frame)
            return None
        if self._prev_diff is None:
            gray = self._preprocess(frame)
            self._prev_diff = self._diff(gray, self._prev_gray)
            self._prev_gray = gray
            if self._reuse_pyramids:
                self._prev_pyr = self._build_pyr(self._prev_diff)
            return None
        step = self._step_pyr if self._reuse_pyramids else self._step_images
        result, state = self._run_step(step, frame, self._carried())
        self._carry(state)
        return result

    def run(self, frames: Iterable[np.ndarray], prefetch: int = 2) -> Iterator[FrameResult]:
        """Streaming mode over an iterable of frames (resets first).

        prefetch > 0 stages the next frames on the device from a background
        thread, so decode and the upload overlap the steps; 0 feeds the
        frames inline."""
        self.reset()
        source = prefetch_to_device(frames, depth=prefetch, device=self.device) if prefetch > 0 \
            else iter(frames)
        try:
            for frame in source:
                result = self.push(frame)
                if result is not None:
                    yield result
        finally:
            if prefetch > 0:
                source.close()

    def run_chunked(
        self, frames: Iterable[np.ndarray], chunk_size: int = 16, prefetch: int = 2,
    ) -> Iterator[FrameResult]:
        """Streaming over chunks: yields one FrameResult of ``chunk_size``
        frames (leading batch axis) per step, the same pair sequence as
        ``run``. Requires faithful_prev_diff=False (the warped-diff feedback
        is per-frame sequential). A short tail (< chunk_size frames) goes
        through ``push`` and is yielded as single-frame results (no batch
        axis), so one chunk shape is ever captured. prefetch > 0 stacks and
        stages chunks from a background thread; 0 stacks them inline."""
        if self.config.faithful_prev_diff:
            raise ValueError(
                "chunked mode needs faithful_prev_diff=False (the warped-diff "
                "feedback is a sequential dependency)"
            )
        self.reset()
        chunks = (
            prefetch_chunks_to_device(frames, chunk_size=chunk_size, depth=prefetch,
                                      device=self.device)
            if prefetch > 0 else _inline_chunks(frames, chunk_size)
        )
        tail = None
        try:
            for chunk in chunks:
                if chunk.shape[0] < chunk_size:
                    tail = chunk
                    break
                if self._prev_gray is None:
                    result, carry = self._chunk_first(chunk)
                else:
                    result, carry = self._run_step(self._chunk_step, chunk, self._carried())
                self._frame_idx += int(chunk.shape[0])
                # seed the streaming state from the carry on EVERY chunk,
                # before the yield: state() and a later push() continue the
                # pair sequence, also after the consumer exits early
                self._carry(carry)
                yield result
        finally:
            chunks.close()
        if tail is not None:
            for frame in tail:
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
        return self._flow_from_pyr_pairs(prev, cur)


def replay_video(path, config: Optional[VideoConfig] = None, max_frames: Optional[int] = None,
                 device="cuda"):
    """Run the pipeline over a video file or rawvideo pipe (the reference
    demo's flow, file-fed instead of VideoCapture(0)); returns the list of
    results. On the card unless another device is named."""
    pipe = VideoPipeline(config or VideoConfig(), device=device)
    return list(pipe.run(read_frames(path, max_frames=max_frames)))
