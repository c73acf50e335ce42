"""CUDA graphs of the pipeline's steady steps: the port's counterpart of the
JAX package's jitted stages (optical_flow_tpu/pipeline/video.py:57-65).

A step is ``step(x, *state) -> (result, new_state)``: one frame (or one
chunk of frames) and the carried state in, a ``FrameResult`` and the next
state out, ``new_state`` shaped like ``state``. ``StepGraph`` captures it
once into a ``torch.cuda.CUDAGraph`` over static tensors: an input buffer,
the state buffers and, at the graph's end, a copy of the new state into
the state buffers (the graph reads the old state before it overwrites
it). ``replay`` lands the input in its buffer, copies in a state that is
not the graph's own (after the eager warm-up, ``restore()`` or another
graph), replays, and hands back clones of the outputs: a result the caller
keeps does not change at the next replay.

Launches captured into the graph are counted once per replay, not at the
capture (``kernels/_lib.captured_launches``); captures, replays and replays
that copied in a foreign state are counted in ``utils/profiling.counters``.
With the program's tracing on, a replay is the span ``graph.replay`` over
``graph.copy_in``, ``graph.launch`` and ``graph.clone_out``, the capture
is ``graph.capture``, and a graph captured then holds its step's stage
events: each replay times its stages, read before the next replay
(``profiling.poll_stages``) while tracing stays on. Such a graph keeps its
event-record nodes after tracing goes off (the card still records them at
every replay); nothing reads them then. The capture runs in
``thread_local`` mode: the prefetch worker may allocate pinned memory and
issue copies on its own stream meanwhile. A capture that fails raises;
nothing falls back to the eager step.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from optical_flow_tpu_torch.kernels import _lib
from optical_flow_tpu_torch.utils import profiling
from optical_flow_tpu_torch.utils.profiling import span


def clone_result(tree):
    """Clone every tensor of a (nested) NamedTuple of tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*(clone_result(t) for t in tree))


def _record_stream(tree, stream) -> None:
    if isinstance(tree, torch.Tensor):
        tree.record_stream(stream)
    else:
        for t in tree:
            _record_stream(t, stream)


def run_on_side_stream(fn: Callable, *args, device: torch.device):
    """``fn(*args)`` on a side stream ordered after the current stream's
    work, with the current stream waiting for it after: the warm-up before
    a capture. What it returns is marked as used by the current stream, so
    its memory is not reused while the current stream's work is queued."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = fn(*args)
    current.wait_stream(side)
    _record_stream(out, current)
    return out


class StepGraph:
    """One step captured over static tensors shaped like ``x`` and ``state``.

    The caller has run ``step`` eagerly on these shapes first, so every
    lazily made object (the resize operator of this frame size, its cached
    matrices, the kernel library, cuBLAS's handle) exists before the
    capture: an allocation of pageable memory or a synchronising call
    inside the capture makes it fail.
    """

    def __init__(self, step: Callable, x: torch.Tensor, state: Sequence[torch.Tensor],
                 frames: int = 1):
        """``frames``: the frames a step's result covers (its stage times
        are counted against them)."""
        self.x = torch.empty_like(x)
        self.state = tuple(torch.empty_like(s) for s in state)
        self.graph = torch.cuda.CUDAGraph()
        with span("graph.capture"), _lib.captured_launches() as tally, \
                profiling.stage_marks(frames, queue=False) as marks:
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                out, new = step(self.x, *self.state)
                for s, n in zip(self.state, new):
                    s.copy_(n)
        profiling.counters["graph.captures"] += 1
        self.out = out
        self.launches = {name: n for name, n in tally.items() if n}
        self.marks = marks if marks is not None and marks.events else None

    def replay(self, x: torch.Tensor, state: Sequence[torch.Tensor], ident=None):
        """(clone of the result, the graph's state buffers, now holding the
        new state). ``x``: a tensor on the card or in pinned host memory,
        copied into the input buffer without blocking the host. ``ident``:
        the frame index the spans carry."""
        tracing = profiling.tracing()
        with span("graph.replay", ident):
            if tracing:
                profiling.poll_stages(self.marks)
            with span("graph.copy_in", ident):
                self.x.copy_(x, non_blocking=True)
                foreign = False
                for static, s in zip(self.state, state):
                    if s is not static:
                        static.copy_(s)
                        foreign = True
            with span("graph.launch", ident):
                self.graph.replay()
            if tracing and self.marks is not None:
                profiling.queue_stages(self.marks)
            with span("graph.clone_out", ident):
                out = clone_result(self.out)
                _lib.add_launches(self.launches)
        profiling.counters["graph.replays"] += 1
        profiling.counters["graph.state_copy_ins"] += foreign
        return out, self.state
