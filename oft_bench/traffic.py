"""The one general driver of every traffic mix. A mix is a data file,
``traffic/<name>.json``, whose ``loop`` names one of the loops here and
whose other keys are its parameters:

- ``stream``: one stream, closed loop, ``VideoPipeline.push`` frame by
  frame and each result's gesture scalars read on the host before the next
  push. A frame's latency runs from its hand-off to ``push`` to its scalars
  on the host. The pipeline is reset at the window's start and, where
  ``reset`` is true, at the start of every segment of ``segment_frames``
  frames (a new clip); otherwise it runs as one stream.
- ``chunked``: one recording, one ``VideoPipeline.run_chunked(frames,
  chunk_size, prefetch)`` call over the whole window, each chunk's gesture
  scalars read on the host.

Frame ``g`` of the window's stream is ``ring[g % len(ring)]``, so the
motion is continuous over the ring's wrap. ``segment_frames`` is also the
unit the check draws its sample in (``oft_bench/check.py``). A loop runs
until ``seconds`` have passed at the end of a frame (or chunk), then waits
for the device.
"""

from __future__ import annotations

import itertools
import time
from contextlib import nullcontext
from typing import Callable, Dict, List, Sequence

import torch


def read_scalars(gesture) -> torch.Tensor:
    """The gesture's detected, cx, cy and votes on the host, one row a frame."""
    g = gesture
    return torch.stack((g.detected.to(torch.float32), g.cx.to(torch.float32),
                        g.cy.to(torch.float32), g.votes.to(torch.float32)), dim=-1).cpu()


def _frames(ring: Sequence, start: int = 0, count: int = None):
    n = len(ring)
    idx = itertools.count(start) if count is None else range(start, start + count)
    return (ring[g % n] for g in idx)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def stream(pipe, ring, mix: Dict, seconds: float, keeper=None, span: Callable = None) -> Dict:
    span = span or (lambda name: nullcontext())
    seg, reset = int(mix["segment_frames"]), bool(mix["reset"])
    n = len(ring)
    lat: List[float] = []
    done = g = 0
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while True:
        if g == 0 or (reset and g % seg == 0):
            pipe.reset()
        t = time.perf_counter()
        with span("push"):
            r = pipe.push(ring[g % n])
        if r is not None:
            with span("read"):
                s = read_scalars(r.gesture)
            lat.append(time.perf_counter() - t)
            done += 1
            slot = keeper.slot(g) if keeper is not None else None
            if slot is not None:
                with span("keep"):
                    keeper.put(slot, r.u, r.v, r.gesture.magnitude, s.tolist())
        g += 1
        if time.perf_counter() >= t_end:
            break
    _sync(pipe.device)
    return {"frames": done, "seconds": time.perf_counter() - t0, "latencies_s": lat,
            "pushed": g}


def chunked(pipe, ring, mix: Dict, seconds: float, keeper=None, span: Callable = None) -> Dict:
    span = span or (lambda name: nullcontext())
    chunk, prefetch = int(mix["chunk_size"]), int(mix["prefetch"])
    done = 0
    g = 2  # frame of the next result: two frames warm the stream up
    t0 = time.perf_counter()
    t_end = t0 + seconds
    gen = pipe.run_chunked(_frames(ring), chunk_size=chunk, prefetch=prefetch)
    try:
        while True:
            with span("next_chunk"):
                r = next(gen)
            with span("read"):
                s = read_scalars(r.gesture)
            m = int(r.u.shape[0])  # an endless stream yields whole chunks only
            for b in range(m):
                slot = keeper.slot(g + b) if keeper is not None else None
                if slot is not None:
                    with span("keep"):
                        keeper.put(slot, r.u[b], r.v[b], r.gesture.magnitude[b], s[b].tolist())
            g += m
            done += m
            if time.perf_counter() >= t_end:
                break
    finally:
        gen.close()
    _sync(pipe.device)
    return {"frames": done, "seconds": time.perf_counter() - t0, "pushed": g}


LOOPS = {"stream": stream, "chunked": chunked}


def warm(pipe, ring, mix: Dict) -> None:
    """Every shape and path the mix's window takes, once: the eager
    warm-up frames, the graph capture and its replay, a reset and the
    eager frames after it (stream); the eager first chunk, the captured
    and the replayed steady chunk, a second call (chunked)."""
    loop = mix["loop"]
    if loop == "stream":
        for k in range(2):
            pipe.reset()
            for frame in _frames(ring, 6 * k, 6):
                r = pipe.push(frame)
                if r is not None:
                    read_scalars(r.gesture)
    elif loop == "chunked":
        n = 4 * int(mix["chunk_size"])
        for k in range(2):
            for r in pipe.run_chunked(_frames(ring, n * k, n), chunk_size=int(mix["chunk_size"]),
                                      prefetch=int(mix["prefetch"])):
                read_scalars(r.gesture)
    else:
        raise ValueError(f"unknown loop {loop!r} (have {', '.join(LOOPS)})")
    _sync(pipe.device)
