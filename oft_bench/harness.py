"""One run of one cell: set-up, the measured window, the check, the
traced summary. ``oft_bench/run.py`` is the command; the CPU tests drive
``run_cell`` with ``device="cpu"`` at small sizes.

Set-up (``setup_s``) runs from the start of the command to the window:
importing torch and the port, the CUDA context, the kernel library
(built into ``build/kernels/`` of the checkout on the first run, loaded
after), the seeded ring of frames, the pipeline, every shape and path of
the mix warmed once (``traffic.warm``), the reservoir's buffers and, for a
traced run, the profiler started once before.
"""

from __future__ import annotations

import gc
import statistics
import sys
import time
from contextlib import contextmanager
from typing import Dict, Optional

import torch

from oft_bench import check, frames, spec, trace, traffic
from oft_bench.reference.stream import history

FORBIDDEN = ("jax", "jaxlib", "flax", "optical_flow_tpu")
# A traced run's window is at most this long: a window holds some hundred
# thousand device operations a second, and reading the trace of 30 s took
# the whole run 160-250 s of its 360.
TRACE_WINDOW_S = 10.0


def forbidden_modules() -> list:
    """Modules loaded whose top-level name, compared whole, is JAX's, a
    JAX library's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def video_config(video: Dict):
    """The port's ``VideoConfig`` of a configuration file's ``video``."""
    from optical_flow_tpu_torch.config import (FlowConfig, GestureConfig, PreprocessConfig,
                                               VideoConfig)

    pre = dict(video["preprocess"], size=tuple(video["preprocess"]["size"]))
    return VideoConfig(preprocess=PreprocessConfig(**pre), flow=FlowConfig(**video["flow"]),
                       gesture=GestureConfig(**video["gesture"]),
                       faithful_prev_diff=video["faithful_prev_diff"], batch=video["batch"])


def p95(values) -> float:
    """The 95th percentile (``statistics.quantiles``, inclusive)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[18]


class Setup:
    """What set-up makes: the pipeline, the ring and the reservoir."""

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device, pipe=None):
        from optical_flow_tpu_torch.pipeline.video import VideoPipeline

        self.cfg, self.mix, self.device = cfg, mix, torch.device(device)
        if self.device.type == "cuda":
            from optical_flow_tpu_torch.kernels import _lib

            _lib.library()
        self.ring = frames.ring(seed, tuple(cfg["frame_hw"]))
        self.pipe = pipe if pipe is not None else VideoPipeline(
            video_config(cfg["video"]), device=self.device)
        reset = bool(mix.get("reset", False))
        if history(cfg["video"]) is None and not reset:
            raise ValueError(f"{cfg['name']} feeds its state back, so the check replays a "
                             f"result's segment from a reset: its mix has to reset")
        traffic.warm(self.pipe, self.ring, mix)
        c = cfg["check"]
        self.keeper = check.Keeper(seed, c["segments"], c["per_segment"], mix["segment_frames"],
                                   reset, cfg["video"]["preprocess"]["size"], self.device)


@contextmanager
def _profile(on: bool):
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


def _span(name: str):
    return torch.profiler.record_function(name)


def warm_profiler(device) -> None:
    """Start and stop the profiler once, so its own start-up is set-up."""
    with _profile(True):
        with _span(trace.WINDOW):
            torch.ones(8, device=device).sum().item()


def window(s: Setup, seconds: float, traced: bool):
    """(loop stats, profiler or None) of the measured window."""
    loop = traffic.LOOPS[s.mix["loop"]]
    with _profile(traced) as prof:
        with _span(trace.WINDOW):
            stats = loop(s.pipe, s.ring, s.mix, seconds, s.keeper,
                         span=_span if traced else None)
    return stats, prof


def end_to_end(stats: Dict, setup_s: float, wanted) -> Dict:
    values = {
        "frames_per_s": (stats["frames"] / stats["seconds"], "frames/s"),
        "setup_s": (setup_s, "s"),
    }
    if stats.get("latencies_s"):
        values["frame_p95_ms"] = (1e3 * p95(stats["latencies_s"]), "ms")
    return {m["name"]: {"value": values[m["name"]][0], "unit": m["unit"]}
            for m in wanted if m["name"] in values}


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool, device, *,
             t_start: Optional[float] = None, bench: Optional[Dict] = None,
             cfg: Optional[Dict] = None, mix: Optional[Dict] = None,
             setup: Optional[Setup] = None) -> Dict:
    """The result line of one run (as a dict, ``check`` last): the
    window lasts ``seconds``, a traced one at most ``TRACE_WINDOW_S``; with
    ``forbidden`` beside it: modules of JAX or the JAX package loaded once
    the window closed. ``cfg``/``mix`` replace the cell's files (the CPU
    tests run small ones); ``setup`` reuses one (the calibration)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or spec.load_benchmark()
    cell = spec.cell(bench, cell_name)
    cfg = cfg or spec.config(cell["config"])
    mix = mix or spec.traffic(cell["traffic"])
    device = torch.device(device)
    s = setup or Setup(cfg, mix, seed, device)
    if traced:
        warm_profiler(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    stats, prof = window(s, min(seconds, TRACE_WINDOW_S) if traced else seconds, traced)
    forbidden = forbidden_modules()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    summary = None
    if prof is not None:
        summary = trace.summarize(trace.raw_events(prof), frames=stats["frames"],
                                  video=cfg["video"])
        del prof
    # the program's state goes before the reference runs on the card
    if setup is None:
        s.pipe = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    judged, rows, failed = check.check(cfg["video"], s.ring, mix["segment_frames"], s.keeper,
                                       cfg["check"]["limits"], device)
    ok = check.passed(judged)
    check_s = time.perf_counter() - t_check
    if traced:
        metrics = {}
        for m in spec.per_layer(bench, cell_name):
            v = spec.metric_reader(m["name"])(summary)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = end_to_end(stats, setup_s, spec.end_to_end(bench, cell_name))
    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(peak),
    }
    out = {"correct": bool(ok), "attempted": int(stats["frames"]), "failed": int(failed),
           "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": trace.top_ops(summary),
                            "idle_gaps": summary["idle_gaps"]}
    out["check"] = judged
    return {"line": out, "forbidden": forbidden, "rows": rows, "stats": stats,
            "summary": summary, "setup": s, "check_s": check_s}
