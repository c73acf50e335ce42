"""Timing, tracing and rooflines on the card (port of
optical_flow_tpu/utils/profiling.py).

- ``Timer``: wall-clock segment timers; ``segment(name, sync=tensors)``
  synchronises the tensors' devices at the segment's end, so the segment
  covers completed device work (without it, the enqueue only).
- ``time_use_once``: device ms per call from CUDA events over many
  back-to-back launches, each on inputs used once. The launches are queued
  behind a device sleep, so the device runs them without waiting on the
  host even where one call is shorter than a launch's host cost.
  ``device_loop_time`` is the JAX package's name for it: seconds per call
  on perturbed copies of the first input.
- ``trace``: a ``torch.profiler`` trace of every thread written as a Chrome
  trace file, with the program's spans on (``set_tracing``);
  ``device_seconds_from_trace`` sums the device spans of the kernels of a
  name in it (None when the trace missed calls).
- ``span(name, ident)``: one of the program's spans, a profiler range named
  ``name`` or, with ``ident`` (a frame index), ``name#ident``, while
  tracing is on (``set_tracing``), else one shared no-op context. The
  spans share the profiler's clock with the device trace, on every thread
  the profiler records (``profiler_config``).
- ``stage(name, device)``: a pipeline stage of a step; with tracing on, a
  span and, on a card, a pair of CUDA timing events on the current stream.
  A step collects its stages' events (``stage_marks``); in a graph capture
  they are external events, so every replay times its own stages. The
  elapsed times are read lazily, once a recording's last event has
  completed (``poll_stages`` before each step, ``flush_stages`` for what is
  left), into device ms and frames by stage (``stage_totals``).
- ``counters``: the program's counts by name, a dict of ints incremented
  where the work happens, always on (``read_counters``,
  ``reset_counters``); the kernels' launches are
  ``kernels.launch_counts()``.
- ``kernel_cost``: the bytes and operations of one call of a kernel, from
  its tensors and shapes. Each input byte is counted read once and each
  output byte written once; the operations are counted from the kernel's
  source, per output position (``OPS_PER_OUTPUT``). ``colsum_cost`` counts
  only the inputs S3's window reads.
- ``stage_roofline``: the least time the card could take for that work, the
  larger of bytes over the memory rate and operations over the rate for
  their type, against the H100's published peaks (``H100``); where given,
  also the time at the rates the probes sustained on the card (S2's copy
  rate, S4's float32 elementwise rate, both at a size that fills the card).
  ``flow_roofline`` is the same bound for one dense LK level (K1) of an
  h x w frame.

A timing without a card raises: no number of this module comes from the
CPU.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Sequence

import torch

# NVIDIA H100 SXM, dense, at the 700 W power limit: the HBM3 rate (data
# sheet) and the rates outside the tensor cores by operand type (data sheet
# for float32; H100 architecture white paper for bfloat16).
H100 = {"bytes_per_s": 3.35e12, "ops_per_s": {torch.float32: 67e12, torch.bfloat16: 133.8e12}}

# Operations per output position, counted from each kernel's source (every
# multiply, add, compare, clip, floor, rint and divide is one).
OPS_PER_OUTPUT = {
    # 2x2 gradients of two frames 21, five products 5, five 3x3 sums 40,
    # the Cramer solve 11; per (u, v) position
    "lk": 77,
    # vertical 5-tap at the kept rows (two input columns per output) 18,
    # horizontal 5-tap 9
    "pyrdown": 27,
    # the same per output of every level below the input: cost a pyramid as
    # kernel_cost("pyramid", [input], levels, outputs_counted=<their sum>),
    # the input read once and each level written once (what the function
    # needs, whether or not a kernel reads a level back)
    "pyramid": 27,
    # per output value of one plane: the row pass (8 per coarse pixel and
    # column) and the column pass (16), over 4 outputs per coarse pixel
    "pyrup": 6,
    # per fine (u, v) position: pyrUp of two planes 12, doubling 2, clip,
    # negate and 1/32 quantization of two planes 16, the 2-tap separable
    # warp of two frames 24, LK 77, the accumulation 2
    "pyrup_warp_lk": 133,
    # clip, negate and quantization 18, warp 24, LK 77
    "warp_lk": 119,
    # per output position of both frames (W1): the half-flow 2; per frame
    # the map 2, two fixed-point coordinates 10, the border tests 8, the
    # taps' +1 2, the lerp 9
    "remap": 64,
    # per output of F1 (diff_features, radius 2): the diff 2, the threshold 1,
    # Sobel x + y 13 (two smoothings of 4, two differences of 2, their sum),
    # the 5x5 max and min as separable passes of 4 each, 16
    "features": 32,
    "copy": 0,
    "interleave": 0,
    # 12 taps, a multiply and an add each, per windowed output
    "colsum": 24,
}


class Cost(NamedTuple):
    bytes: float
    ops: float


def io_bytes(tensors: Iterable[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_cost(kind: str, inputs: Sequence[torch.Tensor], outputs: Sequence[torch.Tensor], *,
                outputs_counted: Optional[int] = None) -> Cost:
    """Bytes and operations of one call of kernel ``kind``. The operations
    are ``OPS_PER_OUTPUT[kind]`` per element of the first output, or per
    ``outputs_counted`` positions where that differs (every level of a
    pyramid)."""
    n = outputs[0].numel() if outputs_counted is None else outputs_counted
    return Cost(float(io_bytes(list(inputs) + list(outputs))), float(OPS_PER_OUTPUT[kind]) * n)


def colsum_cost(shape: Sequence[int], win: int) -> Cost:
    """Bytes and operations of one S3 call on a float32 input of ``shape``:
    only the window's inputs, ``x[..., 1 : win + 12]``, are read; every
    output is written."""
    W = shape[-1]
    rows = 1
    for n in shape[:-1]:
        rows *= n
    read = win + 11 if win else 0
    return Cost(4.0 * rows * (read + W), float(OPS_PER_OUTPUT["colsum"]) * rows * win)


def stage_roofline(cost: Cost, ms: Optional[float] = None, *, dtype: torch.dtype = torch.float32,
                   rates: Optional[Dict[str, object]] = None) -> Dict[str, object]:
    """The least time the card could take for ``cost``, whose operations
    are on ``dtype``, and what bounds it, against the published peaks. With
    ``rates`` (``bytes_per_s`` and ``ops_per_s`` by type, as the probes
    sustained them), the time at those rates (``sustained_ms``). With ``ms``
    (a measured device time), the share of that time each one is."""
    out: Dict[str, object] = {"bytes": cost.bytes, "ops": cost.ops}
    for tag, r in (("bound", H100), ("sustained", rates)):
        if r is None:
            continue
        t_bytes = cost.bytes / r["bytes_per_s"] * 1e3
        t_ops = cost.ops / r["ops_per_s"][dtype] * 1e3
        out[f"{tag}_ms"] = max(t_bytes, t_ops)
        out[f"{tag}_by"] = "bytes" if t_bytes >= t_ops else "operations"
        if ms:
            out[f"share_of_{tag}"] = max(t_bytes, t_ops) / ms
    return out


def _need_card(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"device timing needs a CUDA device, got {device}")
    return device


def time_use_once(fn: Callable, arg_sets: Sequence[tuple], device="cuda") -> float:
    """Device ms per call of ``fn(*args)``: one warm-up call on the first
    entry of ``arg_sets``, then one timed call on each of the others (make
    each entry fresh: use-once inputs).

    The device is held by a sleep while the host queues the timed calls
    between two CUDA events, so the events time the calls back to back. If
    the sleep ended before the host had queued them all (the device would
    have waited on the host between calls), the measurement is taken again
    with a sleep twice as long. The card's launch queue holds about a
    thousand launches and the host waits once it is full, so keep the timed
    calls' launches below that.
    """
    device = _need_card(device)
    with torch.cuda.device(device):
        fn(*arg_sets[0])
        torch.cuda.synchronize()
        timed = arg_sets[1:]
        if not timed:
            raise ValueError("time_use_once needs a warm-up entry and at least one timed entry")
        sleep_ms = max(5.0, 0.1 * len(timed))
        # the SM clock in kHz = cycles per ms (the retries cover a wrong guess)
        cycles_per_ms = getattr(torch.cuda.get_device_properties(device), "clock_rate", 0) or 2e6
        for _ in range(6):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            woke = torch.cuda.Event()
            torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
            woke.record()
            start.record()
            t0 = time.perf_counter()
            for args in timed:
                fn(*args)
            end.record()
            queued_ms = (time.perf_counter() - t0) * 1e3
            held = not woke.query()
            end.synchronize()
            if held:
                return start.elapsed_time(end) / len(timed)
            sleep_ms = 2 * max(sleep_ms, queued_ms)
    raise RuntimeError("time_use_once: the host never queued the calls within the device sleep "
                       "(more launches than the launch queue holds?)")


def flow_roofline(h: int, w: int, *, bytes_per_s: float = H100["bytes_per_s"],
                  ops_per_s: float = H100["ops_per_s"][torch.float32]) -> Dict[str, object]:
    """The least time of one dense LK level (kernel K1) on an h x w float32
    pair, costed as the kernel table costs K1 (``kernel_cost('lk')`` through
    ``stage_roofline``) and keyed as the JAX package keys it; the H100's
    published peaks unless other rates are given."""
    a = torch.empty(h, w, device="meta")
    cost = kernel_cost("lk", [a, a], [a, a])
    r = stage_roofline(cost, rates={"bytes_per_s": bytes_per_s,
                                    "ops_per_s": {torch.float32: ops_per_s}})
    return {
        "bytes": cost.bytes,
        "flops": cost.ops,
        "t_mem_us": 1e6 * cost.bytes / bytes_per_s,
        "t_compute_us": 1e6 * cost.ops / ops_per_s,
        "sol_us": 1e3 * r["sustained_ms"],
        "sol_fps": 1e3 / r["sustained_ms"],
        "bound": "memory" if r["sustained_by"] == "bytes" else "compute",
    }


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in a (nested) tuple, list or dict."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_cuda_devices(t) for t in tree))
    return set()


@dataclass
class Timer:
    """Named segment timers: ``with t.segment('solve', sync=out): ...``."""

    segments: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def segment(self, name: str, sync=None):
        """Time the block; ``sync`` (tensors, or a tuple, list or dict of
        them) waits for their CUDA devices before the clock is read."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for d in _cuda_devices(sync):
                torch.cuda.synchronize(d)
            dt = time.perf_counter() - t0
            self.segments[name] = self.segments.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.segments.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {1e3 * total:9.3f} ms total  {1e3 * total / n:9.3f} ms/call x{n}")
        return "\n".join(lines)


def device_loop_time(fn: Callable, args: Sequence, iters: int = 30) -> float:
    """Seconds per call of ``fn(*args)`` on the card: ``time_use_once`` over
    ``iters`` calls, each on a copy of the first argument (a floating
    tensor on the card) perturbed by ``i * 1e-7``, so no two calls read the
    same input."""
    x, rest = args[0], tuple(args[1:])
    sets = [(x + i * 1e-7, *rest) for i in range(iters + 1)]
    return time_use_once(fn, sets, device=x.device) / 1e3


# ----------------------------------------------- the program's spans and counters

_tracing = False
_OFF = contextlib.nullcontext()

# The program's counts: graphs captured and replayed, replays that copied in
# a state not the graph's own, steps run eagerly, replays whose stage times
# were recorded over before they were read.
counters: Dict[str, int] = dict.fromkeys(
    ("graph.captures", "graph.replays", "graph.state_copy_ins", "step.eager", "stage.unread"), 0)


def set_tracing(on: bool) -> bool:
    """Turn the program's spans and stage timings on or off; returns the
    setting before. A graph captured while tracing is off holds no stage
    events, so turn it on before the pipeline's first steps. Turning it off
    drops the stage recordings not read yet (``flush_stages`` first keeps
    them); a graph captured while it was on keeps its event-record nodes,
    which nothing reads until tracing is on again."""
    global _tracing
    before, _tracing = _tracing, bool(on)
    if not _tracing:
        with _stage_lock:
            _unread.clear()
    return before


def tracing() -> bool:
    return _tracing


def _range(name: str):
    # record_function's range goes through the dispatcher and costs about
    # 13 us of host time a span; this one 1-2 us
    return torch._C._profiler._RecordFunctionFast(name)


def span(name: str, ident: Optional[int] = None):
    """The program's span ``name`` over a block while tracing is on, named
    ``name#ident`` where ``ident`` (the frame index of a push, the first
    frame of a chunk) is given: a profiler keeps a range's arguments only
    where it records inputs, and never on a thread other than its own.
    While tracing is off, a shared no-op context."""
    if not _tracing:
        return _OFF
    return _range(name if ident is None else f"{name}#{ident}")


def profiler_config():
    """The profiler's settings that record every thread's ranges (the
    prefetch worker's among them), or None where this torch has none: by
    default a profiler records only the thread that started it."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


def read_counters() -> Dict[str, int]:
    return dict(counters)


def reset_counters() -> None:
    for name in counters:
        counters[name] = 0


_stage_ms: Dict[str, float] = {}
_stage_frames: Dict[str, int] = {}
_unread: list = []  # StageMarks recorded and not read yet
_stage_lock = threading.Lock()
_open = threading.local()  # .marks: the StageMarks of the step this thread runs


class StageMarks:
    """The stage events of one step, (stage, start, end) in order, and the
    frames its result covers. An eager step records them once; a captured
    step's are event-record nodes of its graph, which every replay records
    again."""

    def __init__(self, frames: int):
        self.frames = int(frames)
        self.events: list = []

    def done(self) -> bool:
        return self.events[-1][2].query()

    def read(self) -> None:
        for name, start, end in self.events:
            _stage_ms[name] = _stage_ms.get(name, 0.0) + start.elapsed_time(end)
        for name in {e[0] for e in self.events}:
            _stage_frames[name] = _stage_frames.get(name, 0) + self.frames


def poll_stages(recording_over: Optional[StageMarks] = None) -> None:
    """Read the stage times of every recording whose last event has
    completed. ``recording_over``: a graph's marks about to be recorded
    again by its next replay; if its last replay has not completed, that
    replay's times are dropped and counted in ``stage.unread``."""
    if not _unread:
        return
    with _stage_lock:
        keep = []
        for m in _unread:
            if m.done():
                m.read()
            elif m is recording_over:
                counters["stage.unread"] += 1
            else:
                keep.append(m)
        _unread[:] = keep


def queue_stages(marks: StageMarks) -> None:
    """A recording of ``marks`` was made (an eager step ran, a graph was
    replayed): read it once it has completed."""
    with _stage_lock:
        _unread.append(marks)


def flush_stages() -> None:
    """Wait for every recording not read yet and read it."""
    with _stage_lock:
        for m in _unread:
            m.events[-1][2].synchronize()
            m.read()
        _unread.clear()


def stage_totals() -> Dict[str, Dict[str, float]]:
    """Device ms by stage, and the frames the read steps cover."""
    return {n: {"ms": ms, "frames": _stage_frames.get(n, 0)} for n, ms in _stage_ms.items()}


def reset_stages() -> None:
    with _stage_lock:
        _stage_ms.clear()
        _stage_frames.clear()
        _unread.clear()


@contextlib.contextmanager
def stage_marks(frames: int, queue: bool = True):
    """Collect the stage events of one step on this thread; yields its
    ``StageMarks`` (None while tracing is off). ``queue``: read them once
    they complete (an eager step); a graph keeps its own and queues them at
    each replay. Reads what earlier steps left first."""
    if not _tracing:
        yield None
        return
    poll_stages()
    marks, outer = StageMarks(frames), getattr(_open, "marks", None)
    _open.marks = marks
    try:
        yield marks
    finally:
        _open.marks = outer
    if queue and marks.events:
        queue_stages(marks)


class _Stage:
    def __init__(self, name: str, device: torch.device):
        self.name, self.device = name, device
        self.range = _range(name)

    def __enter__(self):
        self.range.__enter__()
        marks = getattr(_open, "marks", None)
        self.marks = marks if self.device.type == "cuda" else None
        if self.marks is not None:
            self.stream = torch.cuda.current_stream(self.device)
            self.start = self._event()
        return self

    def _event(self):
        # inside a capture an external event becomes an event-record node
        e = torch.cuda.Event(enable_timing=True,
                             external=torch.cuda.is_current_stream_capturing())
        e.record(self.stream)
        return e

    def __exit__(self, *exc):
        if self.marks is not None:
            self.marks.events.append((self.name, self.start, self._event()))
        return self.range.__exit__(*exc)


def stage(name: str, device) -> contextlib.AbstractContextManager:
    """Pipeline stage ``name`` of a step on ``device``: while tracing is on,
    a span and, on a card inside ``stage_marks``, a pair of timing events
    on the current stream around the stage's work."""
    if not _tracing:
        return _OFF
    return _Stage(name, torch.device(device))


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` over the block (CPU activity of every thread, and
    CUDA where a card is present), with the program's spans on, written on
    exit as a Chrome trace, ``log_dir/trace.json`` (a new temporary
    directory if none is given); yields ``log_dir``. A CUDA graph captured
    inside the block holds its stages' timing events, and keeps them as
    event-record nodes after it."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or tempfile.mkdtemp(prefix="optical_flow_trace_")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    before = set_tracing(True)
    try:
        with profile(activities=activities, experimental_config=profiler_config()) as prof:
            yield log_dir
    finally:
        set_tracing(before)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# Chrome-trace categories of spans that ran on the device
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_seconds_from_trace(trace_dir: str, fn_name: str,
                              expected_calls: int) -> Optional[float]:
    """Sum of the device spans whose name contains ``fn_name`` (a kernel's
    name) in the Chrome traces under ``trace_dir`` (``trace``'s files);
    None if the trace is unusable or holds fewer than ``expected_calls``
    such spans (a CPU trace holds none)."""
    import glob
    import gzip
    import json

    files = glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True) + glob.glob(
        os.path.join(trace_dir, "**", "*.json.gz"), recursive=True)
    if not files:
        return None
    total_us, calls = 0.0, 0
    for path in files:
        opener = gzip.open if path.endswith(".gz") else open
        try:
            with opener(path, "rt") as f:
                tr = json.load(f)
        except (OSError, ValueError):
            return None
        events = tr.get("traceEvents", []) if isinstance(tr, dict) else tr
        for e in events:
            if (e.get("ph") == "X" and e.get("cat") in _DEVICE_CATEGORIES
                    and fn_name in e.get("name", "")):
                total_us += float(e.get("dur", 0))
                calls += 1
    if calls < expected_calls:  # the trace missed executions
        return None
    return total_us / 1e6
