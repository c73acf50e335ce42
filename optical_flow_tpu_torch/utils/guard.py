"""Failure detection for streaming jobs (port of optical_flow_tpu/utils/guard.py;
reference: none, SURVEY.md section 5 lists only NULL-frame checks,
OpticalFlowDemo.cpp:90-95).

Long-running video/tracking pipelines fail in two ways worth catching
early: numerical blowup (NaN/Inf escaping a solve) and stalled progress
(decoder hang, device wedge). `FlowGuard` checks per-frame results with one
finiteness reduction on the tensors' device and a wall-clock watchdog;
failures raise structured exceptions so a supervisor can checkpoint and
restart (utils/checkpoint.py)."""

from __future__ import annotations

import time
from typing import Optional

import torch


class NumericalFailure(RuntimeError):
    """NaN/Inf detected in a monitored output."""


class StallFailure(RuntimeError):
    """No frame completed within the watchdog interval."""


def _finite_fraction(*arrays) -> float:
    """Share of non-finite values over all ``arrays``: one reduction on the
    device of the first tensor among them (host arrays are sent there), and
    one scalar to the host, which waits for the device once. Host arrays
    alone are checked on the host."""
    tensors = [a for a in arrays if isinstance(a, torch.Tensor)]
    device = tensors[0].device if tensors else torch.device("cpu")
    total = 0
    bad = torch.zeros((), dtype=torch.float32, device=device)
    for a in arrays:
        t = torch.as_tensor(a, device=device)
        total += t.numel()
        bad = bad + (~torch.isfinite(t.float())).sum(dtype=torch.float32)
    return float(bad) / total if total else 0.0


class FlowGuard:
    """check() validates outputs; heartbeat() arms the stall watchdog."""

    def __init__(self, stall_timeout_s: Optional[float] = None):
        self.stall_timeout_s = stall_timeout_s
        self._last_beat = time.monotonic()
        self.frames_checked = 0

    def heartbeat(self) -> None:
        self._last_beat = time.monotonic()

    def start_watchdog(self, poll_s: float = 5.0):
        """Background stall watchdog: interrupts the main thread
        (KeyboardInterrupt) when no heartbeat arrives within
        stall_timeout_s. Returns a stop() callable. Only catches
        Python-level stalls — a main thread blocked inside native code
        won't see the interrupt until it returns."""
        import threading
        import _thread

        stop_evt = threading.Event()

        def poll():
            while not stop_evt.wait(poll_s):
                try:
                    self.check_stalled()
                except StallFailure as e:
                    import sys

                    print(f"FlowGuard watchdog: {e}", file=sys.stderr, flush=True)
                    _thread.interrupt_main()
                    return

        t = threading.Thread(target=poll, daemon=True)
        t.start()
        return stop_evt.set

    def check_stalled(self) -> None:
        if (
            self.stall_timeout_s is not None
            and time.monotonic() - self._last_beat > self.stall_timeout_s
        ):
            raise StallFailure(
                f"no progress for {time.monotonic() - self._last_beat:.1f}s "
                f"(limit {self.stall_timeout_s}s) after {self.frames_checked} frames"
            )

    def check(self, *arrays, context: str = "") -> None:
        """Raise NumericalFailure if any array contains NaN/Inf.

        One reduction on the tensors' device; only the scalar crosses to the
        host (on a card: one synchronisation a call).
        """
        frac = _finite_fraction(*arrays)
        self.frames_checked += 1
        self.heartbeat()
        if frac > 0:
            raise NumericalFailure(
                f"{frac:.2%} non-finite values in monitored outputs"
                + (f" at {context}" if context else "")
            )
