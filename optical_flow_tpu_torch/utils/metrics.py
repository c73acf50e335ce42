"""Structured metrics / observability (a copy of
optical_flow_tpu/utils/metrics.py; host-only. Reference: printf + imshow
only, SURVEY.md section 5).

A dependency-free metrics registry for streaming jobs: counters, gauges and
latency histograms, snapshotted as JSON lines (one object per emit) so a
supervisor or log scraper can track throughput, detection rates, and guard
trips. Used by the CLI/examples; libraries never emit on their own.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, IO, List, Optional


@dataclass
class Histogram:
    buckets_ms: List[float] = field(
        default_factory=lambda: [1, 2, 5, 10, 20, 50, 100, 200, 500, 1000]
    )
    counts: List[int] = field(default_factory=list)
    total: float = 0.0
    n: int = 0

    def __post_init__(self):
        if not self.counts:
            self.counts = [0] * (len(self.buckets_ms) + 1)

    def observe(self, value_ms: float) -> None:
        self.total += value_ms
        self.n += 1
        for i, edge in enumerate(self.buckets_ms):
            if value_ms <= edge:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def summary(self) -> Dict:
        return {
            "count": self.n,
            "mean_ms": self.total / self.n if self.n else 0.0,
            "buckets_ms": self.buckets_ms,
            "counts": self.counts,
        }


class Metrics:
    """counter/gauge/time registry with JSONL emission."""

    def __init__(self, sink: Optional[IO] = None):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}
        self._sink = sink
        self._t0 = time.time()

    def count(self, name: str, inc: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + inc

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe_ms(self, name: str, value_ms: float) -> None:
        self.histograms.setdefault(name, Histogram()).observe(value_ms)

    def timer(self, name: str):
        m = self

        class _T:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                m.observe_ms(name, 1e3 * (time.perf_counter() - self.t0))

        return _T()

    def snapshot(self) -> Dict:
        return {
            "uptime_s": round(time.time() - self._t0, 3),
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {k: h.summary() for k, h in self.histograms.items()},
        }

    def emit(self) -> None:
        if self._sink is not None:
            self._sink.write(json.dumps(self.snapshot()) + "\n")
            self._sink.flush()
