"""The program's own spans and counters over a traced window: what the
per-layer readers in ``metrics/`` that read ``summary["program"]`` read.

A traced run that reports them turns the program's tracing on
(``optical_flow_tpu_torch.utils.profiling.set_tracing``) before set-up, so
the graphs it captures hold their stages' timing events; profiles the
window on every thread (``profiling.profiler_config()``); takes
``snapshot()`` at the window's ends; and sets ``summary["program"] =
summarize(events, before, after)``, passing ``benchmark_events(events)``
to ``trace.summarize``. ``summarize`` reduces the profiler's events of the
window (the benchmark's ``window`` span) to:

- ``spans``: each of the program's spans (``PROGRAM_SPANS``, the name
  before its ``#frame``), on every thread: ``total_s`` and ``self_s``
  (its time less that of the program's spans nested in it on its thread),
  clipped to the window, and ``calls``;
- ``idle``: seconds of the window in which no device operation ran, by the
  innermost program span open on the window's thread when each stretch
  began (``-`` where none was);
- ``counters``: each counter's change between two ``snapshot()`` taken at
  the window's ends: the program's counters, ``launches.<entry point>``,
  and ``host_memory.<key>`` of the caching host allocator's pinned pool;
- ``stages``: each stage's device ms and the frames its readings cover,
  over the window.

A program without a counter or span gives none (``snapshot`` and the
readers take what is there): an older checkout of the program has no
tracing, and its readers return None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.autograd import DeviceType

from oft_bench import trace

PROGRAM_SPANS = (
    "upload.pin", "upload.stage", "prefetch.pull", "prefetch.wait",
    "graph.replay", "graph.copy_in", "graph.launch", "graph.clone_out", "graph.capture",
    "step.eager",
    "stage.preprocess", "stage.features", "stage.pyramid", "stage.flow", "stage.gesture",
)
HOST_MEMORY_KEYS = ("num_host_alloc", "host_alloc_time.total")


def span_name(event_name: str) -> str:
    """A program span's name without its ``#frame``."""
    return event_name.partition("#")[0]


def _profiling():
    """The program's profiling module, or None where it has no tracing."""
    from optical_flow_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "set_tracing") else None


def snapshot() -> Dict[str, Dict]:
    """The counters and the stage totals now (the stages' pending readings
    read first): ``{"counters": {...}, "stages": {...}}``."""
    from optical_flow_tpu_torch import kernels

    counters: Dict[str, float] = {f"launches.{k}": v for k, v in kernels.launch_counts().items()}
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is not None and torch.cuda.is_available():
        mem = stats()
        counters.update({f"host_memory.{k}": mem[k] for k in HOST_MEMORY_KEYS if k in mem})
    stages: Dict[str, Dict] = {}
    p = _profiling()
    if p is not None:
        counters.update(p.read_counters())
        p.flush_stages()
        stages = p.stage_totals()
    return {"counters": counters, "stages": stages}


def benchmark_events(events) -> list:
    """The events as ``trace.summarize`` reads them: the program's ranges
    that a profiler draws on the device's timeline left out, since
    ``trace._is_device``'s fallback (a torch without ``activity_type``)
    would take them for device work."""
    return [e for e in events
            if not (e.device_type() == DeviceType.CUDA and span_name(e.name()) in PROGRAM_SPANS)]


def _is_device(e, name: str) -> bool:
    """A kernel, copy or set on the card: not a range of the benchmark's or
    of the program's drawn on the device's timeline, on either of
    ``trace._is_device``'s paths."""
    return trace._is_device(e, name) and span_name(name) not in PROGRAM_SPANS


def _self_times(spans: Sequence[Tuple[int, int, str]], t0: int, t1: int):
    """{name: [total ns, self ns, calls]} of one thread's nested spans
    (start, end, name), clipped to [t0, t1]."""
    out: Dict[str, List] = {}
    stack: List[List] = []  # [end, name, clipped ns, children's clipped ns]

    def close(top):
        r = out.setdefault(top[1], [0, 0, 0])
        r[0] += top[2]
        r[1] += top[2] - top[3]
        r[2] += 1

    for s, e, n in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            close(stack.pop())
        clipped = max(0, min(e, t1) - max(s, t0))
        if stack:
            stack[-1][3] += clipped
        stack.append([e, n, clipped, 0])
    while stack:
        close(stack.pop())
    return out


def _innermost(points: Sequence[int], spans: Sequence[Tuple[int, int, str]],
               default: str) -> List[str]:
    """For each of the sorted ``points``, the name of the innermost of the
    nested ``spans`` (start, end, name) open at it, else ``default``."""
    spans = sorted(spans, key=lambda x: (x[0], -x[1]))
    out, stack, i = [], [], 0
    for t in points:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else default)
    return out


def summarize(events, before: Dict, after: Dict) -> Dict:
    """``summary["program"]`` of one traced window from the profiler's
    events and the snapshots at its ends."""
    window: Optional[Tuple[int, int, int]] = None
    device: List[Tuple[int, int]] = []
    by_thread: Dict[int, List[Tuple[int, int, str]]] = {}
    for e in events:
        name = e.name()
        if _is_device(e, name):
            device.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.device_type() == DeviceType.CPU:
            if name == trace.WINDOW:
                window = (e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
            elif span_name(name) in PROGRAM_SPANS:
                by_thread.setdefault(e.start_thread_id(), []).append(
                    (e.start_ns(), e.start_ns() + e.duration_ns(), span_name(name)))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    t0, t1, thread = window
    spans: Dict[str, Dict] = {}
    for th, ss in by_thread.items():
        ss = [x for x in ss if x[1] > t0 and x[0] < t1]
        for n, (tot, own, calls) in _self_times(ss, t0, t1).items():
            r = spans.setdefault(n, {"total_s": 0.0, "self_s": 0.0, "calls": 0})
            r["total_s"] += tot / 1e9
            r["self_s"] += own / 1e9
            r["calls"] += calls
    intervals = [(max(s, t0), min(e, t1)) for s, e in device if e > t0 and s < t1]
    gaps = trace._gaps(intervals, t0, t1)
    idle: Dict[str, float] = {}
    for name, (_, g) in zip(_innermost([s for s, _ in gaps], by_thread.get(thread, []), "-"),
                            gaps):
        idle[name] = idle.get(name, 0.0) + g / 1e9
    counters = {k: v - before["counters"].get(k, 0) for k, v in after["counters"].items()}
    stages = {}
    for n, r in after["stages"].items():
        b = before["stages"].get(n, {"ms": 0.0, "frames": 0})
        if r["frames"] > b["frames"]:
            stages[n] = {"ms": r["ms"] - b["ms"], "frames": r["frames"] - b["frames"]}
    return {"spans": spans, "idle": idle, "counters": counters, "stages": stages}
