"""The traced run's summary: what ``torch.profiler`` saw over the window,
reduced to what the per-layer readers (``oft_bench/metrics/``) read.

Device busy time is the length of the union of the device intervals
(kernels, copies, sets; ``chip_smoke.py``'s ``_busy_ms`` arithmetic), cut
to the window, which is the benchmark's own ``window`` span. Device time
by name sums each operation's intervals inside the window. Host spans are
the benchmark's ``record_function`` spans (``SPANS``) on the thread that
drives the window. An idle gap is a stretch of the window in which no
device operation ran, named by the innermost benchmark span open on that
thread when it began (``loop`` where none was); the breakdown gives the
idle seconds summed by that name (``all:<span>``), then the longest single
gaps (``longest:<span>``), ten entries at most.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from torch.autograd import DeviceType

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "window"
SPANS = ("push", "read", "next_chunk", "keep")


def union_s(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    busy, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _gaps(intervals: Sequence[Tuple[float, float]], t0: float, t1: float):
    """(start, length) of the stretches of [t0, t1] no interval covers."""
    out, cur = [], t0
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, s - cur))
        cur = max(cur, e)
    if t1 > cur:
        out.append((cur, t1 - cur))
    return out


def raw_events(prof) -> list:
    """The profiler's events without building its per-event objects: a
    window holds millions of them."""
    return prof.profiler.kineto_results.events()


def _is_device(e, name: str) -> bool:
    """A kernel, copy or set on the card (not a range the benchmark's spans
    draw on the device's timeline)."""
    kind = e.activity_type() if hasattr(e, "activity_type") else None
    if kind is not None:
        return kind in DEVICE_ACTIVITIES
    return e.device_type() == DeviceType.CUDA and name != WINDOW and name not in SPANS


def summarize(events, *, frames: int, video: Dict, top: int = 10) -> Dict:
    """The summary of one traced window (times in seconds)."""
    window: Optional[Tuple[int, int, int]] = None
    device: List[Tuple[str, int, int]] = []
    spans: List[Tuple[str, int, int, int]] = []
    for e in events:
        name = e.name()
        if _is_device(e, name):
            device.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.device_type() == DeviceType.CPU and (name == WINDOW or name in SPANS):
            if name == WINDOW:
                window = (e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
            else:
                spans.append((name, e.start_ns(), e.start_ns() + e.duration_ns(),
                              e.start_thread_id()))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    t0, t1, thread = window
    clipped = [(n, max(s, t0), min(e, t1)) for n, s, e in device if e > t0 and s < t1]
    intervals = [(s, e) for _, s, e in clipped]
    ops: Dict[str, List[float]] = {}
    for n, s, e in clipped:
        r = ops.setdefault(n, [0, 0.0])
        r[0] += 1
        r[1] += (e - s) / 1e9
    host: Dict[str, float] = {}
    main = sorted((s, e, n) for n, s, e, th in spans if th == thread and e > t0 and s < t1)
    for s, e, n in main:
        host[n] = host.get(n, 0.0) + (min(e, t1) - max(s, t0)) / 1e9
    starts = [s for s, _, _ in main]

    def open_span(t: float) -> str:
        i = bisect.bisect_right(starts, t)
        best, best_start = "loop", -1
        for s, e, n in main[max(0, i - 16) : i]:
            if s <= t < e and s >= best_start:
                best, best_start = n, s
        return best

    gaps = [(open_span(s), g) for s, g in _gaps(intervals, t0, t1)]
    by_span: Dict[str, float] = {}
    for name, g in gaps:
        by_span[name] = by_span.get(name, 0.0) + g
    idle = sorted(([f"all:{n}", g / 1e9] for n, g in by_span.items()), key=lambda x: -x[1])
    longest = sorted(gaps, key=lambda x: -x[1])[: max(0, top - len(idle))]
    return {
        "window_s": (t1 - t0) / 1e9,
        "busy_s": union_s(intervals) / 1e9,
        "frames": int(frames),
        "video": video,
        "device_ops": {n: {"calls": c, "s": s} for n, (c, s) in ops.items()},
        "host_spans": host,
        "idle_gaps": idle + [[f"longest:{n}", g / 1e9] for n, g in longest],
        "device_events": len(clipped),
    }


def top_ops(summary: Dict, n: int = 10) -> List[List]:
    ops = sorted(summary["device_ops"].items(), key=lambda kv: -kv[1]["s"])[:n]
    return [[name[:120], r["s"]] for name, r in ops]
