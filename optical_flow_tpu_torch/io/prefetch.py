"""Asynchronous host-to-device frame prefetching (port of
optical_flow_tpu/io/prefetch.py).

The reference frame loop is strictly sequential: decode blocks compute
(ParallelVideoPyr.cpp:769-903). Here a background thread decodes and
stages the next frame(s) on the device while the current step runs.

On a CUDA device the worker copies each frame (or stacked chunk) into
pinned (page-locked) host memory and sends it with a ``non_blocking``
host-to-device copy on a copy stream of its own; it hands the device
tensor over with the copy's event. Before the tensor is yielded, the
consumer's current stream waits on that event, and the tensor is marked as
used by that stream (``record_stream``), so its memory is not handed out
again while the consumer's work is queued. The pinned block is reused only
after its copy has completed (PyTorch's caching host allocator records the
copy's event). Nothing falls back to a pageable or synchronous copy, and
nothing here waits for a copy to complete.

With the program's tracing on (``utils/profiling.set_tracing``) the worker
draws ``prefetch.pull`` (frames pulled from upstream), ``upload.pin`` (the
host copy into pinned memory; also ``pinned_copy`` on any thread) and
``upload.stage`` (the copy enqueued and its event), and the consumer
``prefetch.wait`` (blocked on the queue), each with the index of its first
frame; the copy itself is the device trace's HtoD interval.

Failure semantics (the JAX package's round-5 contracts): an exception in
the upstream iterable (a missing file, a mid-stream decode error) is
forwarded to the consumer and re-raised there, never read as a clean end
of stream; a consumer that exits early (break, exception) closes the
generator, which unblocks the worker within a bounded time; the worker
starts on the first ``next()``, not when the generator is made.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from optical_flow_tpu_torch.parallel.mesh import canonical_device
from optical_flow_tpu_torch.utils.profiling import span

_STOP = object()


class _UpstreamError:
    """Queue envelope carrying an exception from the worker thread."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _run_prefetch(q, closed, produce) -> None:
    """Worker body: enqueue items from produce() with closed-aware puts;
    forward any upstream exception; always terminate the stream."""

    def emit(item) -> bool:
        while not closed.is_set():
            try:
                q.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    try:
        for item in produce():
            if not emit(item):
                return  # consumer gone: drop everything, exit promptly
        emit(_STOP)
    except BaseException as e:  # noqa: BLE001 — forwarded, not swallowed
        emit(_UpstreamError(e))


def _consume(q, closed, produce, deliver, frames_per_item: int = 1):
    """Generator over the prefetched stream; ``deliver`` turns a queued item
    into the tensor yielded. The worker thread starts on the FIRST next(),
    not at construction: a generator abandoned before iteration never runs
    its finally, so an eagerly started worker could never be signalled."""
    t = threading.Thread(target=_run_prefetch, args=(q, closed, produce), daemon=True)
    t.start()
    try:
        for k in itertools.count():
            with span("prefetch.wait", k * frames_per_item):
                item = q.get()
            if item is _STOP:
                break
            if isinstance(item, _UpstreamError):
                raise item.exc
            yield deliver(item)
    finally:
        closed.set()
        t.join(timeout=10)


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def pinned_empty(shape, dtype) -> torch.Tensor:
    """An uninitialised pinned host tensor; ``dtype`` numpy's or torch's."""
    if not isinstance(dtype, torch.dtype):
        dtype = _torch_dtype(np.dtype(dtype))
    return torch.empty(tuple(shape), dtype=dtype, pin_memory=True)


def pinned_copy(frame, ident: Optional[int] = None) -> torch.Tensor:
    """A copy of a host frame (numpy array or CPU tensor) in pinned memory;
    ``ident``: the frame's index, for its ``upload.pin`` span."""
    with span("upload.pin", ident):
        if isinstance(frame, torch.Tensor):
            out = pinned_empty(frame.shape, frame.dtype)
            out.copy_(frame)
            return out
        a = np.asarray(frame)
        out = pinned_empty(a.shape, a.dtype)
        np.copyto(out.numpy(), a)
        return out


class _Stager:
    """Host frames -> tensors on ``device``. ``stage`` runs on the worker
    thread and returns a queue item; ``deliver`` runs on the consumer's
    thread and returns the tensor."""

    def __init__(self, device: torch.device):
        self.device = device
        self._stream = None

    def stage(self, host: torch.Tensor, ident: Optional[int] = None):
        with span("upload.stage", ident):
            if self.device.type != "cuda":
                return host.to(self.device)
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._stream):
                out = torch.empty(host.shape, dtype=host.dtype, device=self.device)
                out.copy_(host, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._stream)
            return out, done

    def deliver(self, item):
        if self.device.type != "cuda":
            return item
        out, done = item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(done)
        out.record_stream(stream)
        return out


def _host_frame(frame, pinned: bool, ident: int) -> torch.Tensor:
    """One frame as a host tensor that the caller owns: pinned for a copy
    to a card, else a plain copy (decoders hand out read-only buffers)."""
    if pinned:
        return pinned_copy(frame, ident)
    if isinstance(frame, torch.Tensor):
        return frame.clone()
    return torch.from_numpy(np.array(frame))


def prefetch_to_device(
    frames: Iterable[np.ndarray], depth: int = 2, device="cuda",
) -> Iterator[torch.Tensor]:
    """Yield frames as tensors on ``device``, decoding and copying ``depth``
    ahead. ``device`` is the card unless another is named; without a card
    it raises here, when called."""
    stager = _Stager(canonical_device(device))
    pinned = stager.device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    closed = threading.Event()

    def produce():
        upstream = iter(frames)
        for i in itertools.count():
            with span("prefetch.pull", i):
                f = next(upstream, _STOP)
            if f is _STOP:
                return
            yield stager.stage(_host_frame(f, pinned, i), i)

    return _consume(q, closed, produce, stager.deliver)


def prefetch_chunks_to_device(
    frames: Iterable[np.ndarray],
    chunk_size: int,
    depth: int = 2,
    device="cuda",
) -> Iterator[torch.Tensor]:
    """Stack frames into (chunk_size, ...) batches and stage them on
    ``device`` from a background thread; the final batch may be shorter.
    One copy per chunk instead of one per frame. ``device`` is the card
    unless another is named; without a card it raises here, when called."""
    stager = _Stager(canonical_device(device))
    pinned = stager.device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    closed = threading.Event()

    def put(buf, first):
        with span("upload.pin", first):
            if pinned:  # stacked straight into pinned memory: one host copy
                host = pinned_empty((len(buf),) + buf[0].shape, buf[0].dtype)
                for dst, f in zip(host.numpy(), buf):
                    np.copyto(dst, f)
            else:
                host = torch.from_numpy(np.stack(buf))
        return stager.stage(host, first)

    def produce():
        upstream = iter(frames)
        for first in itertools.count(0, chunk_size):
            with span("prefetch.pull", first):
                buf = [np.asarray(f) for f in itertools.islice(upstream, chunk_size)]
            if buf:
                yield put(buf, first)
            if len(buf) < chunk_size:
                return

    return _consume(q, closed, produce, stager.deliver, chunk_size)
