"""``BENCHMARK.json`` and every piece it names, loaded by name: each cell's
configuration, mix and metric files; names, units and text within the
contract's characters and lengths; each traffic driver run a few frames
against the port with ``device="cpu"``; the command refusing to run
without a card."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from oft_bench import harness, spec, trace, traffic

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["oft_bench"]
    assert all(_line(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["source"].startswith("https://")
        assert c["file"] == f"oft_bench/configs/{c['name']}.json"
        assert c["reduced"] == spec.config(c["name"])["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}" and NAME.match(w["name"])
        assert w["chips"] == 1 and _line(w["why"])
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.add(m["layer"])
    perf = (spec.ROOT / "PERF.md").read_text()
    assert all(layer in perf for layer in layers)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_its_pieces_by_name(cell):
    w = spec.cell(BENCH, cell)
    cfg, mix = spec.config(w["config"]), spec.traffic(w["traffic"])
    assert cfg["name"] == w["config"] and mix["name"] == w["traffic"]
    assert mix["loop"] in traffic.LOOPS
    assert set(cfg["check"]["limits"]) == set(("compared",) + tuple(
        k for k in cfg["check"]["limits"] if k != "compared"))
    harness.video_config(cfg["video"])
    e2e = {m["name"] for m in spec.end_to_end(BENCH, cell)}
    assert "setup_s" in e2e and "frames_per_s" in e2e
    layer = spec.per_layer(BENCH, cell)
    assert layer
    for m in layer:
        assert callable(spec.metric_reader(m["name"]))
    for path in Path(spec.HERE).rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(spec.HERE).as_posix()
            assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel


def test_presets_are_the_ports():
    from optical_flow_tpu_torch.config import VideoConfig

    assert harness.video_config(spec.config("fast_1080")["video"]) == VideoConfig.fast()
    assert harness.video_config(spec.config("faithful_1080")["video"]) == VideoConfig()


@pytest.mark.parametrize("cell", CELLS)
def test_each_driver_runs_a_few_frames_on_the_cpu(cell, small):
    """The whole run but the chip: set-up, the window, the check against
    the reference, and a traced run's summary with every per-layer reader
    run on it (on the CPU there is no device time, so the device readers
    find nothing to read)."""
    cfg, mix = small(cell)
    out = harness.run_cell(cell, 2 ** 31 + 5, 2.0, False, "cpu", cfg=cfg, mix=mix)
    line = out["line"]
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "check"
    want = {m["name"] for m in spec.end_to_end(BENCH, cell)}
    assert set(line["metrics"]) == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert out["forbidden"] == []
    traced = harness.run_cell(cell, 3, 1.0, True, "cpu", cfg=cfg, mix=mix)
    s = traced["summary"]
    assert s["window_s"] > 0 and s["busy_s"] == 0 and s["frames"] > 0
    assert set(traced["line"]["metrics"]) <= {m["name"] for m in spec.per_layer(BENCH, cell)}
    assert traced["line"]["metrics"]
    assert set(s["host_spans"]) <= set(trace.SPANS)


def test_command_refuses_without_a_card_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "oft_bench.run", "--workload", CELLS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=spec.ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_trace_arithmetic():
    assert trace.union_s([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace._gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 2), (5, 1)]


class _Event:
    """A profiler event of the older API: no ``activity_type``."""

    def __init__(self, name, device, start, dur, thread=1):
        self._n, self._d, self._s, self._t, self._th = name, device, start, dur, thread

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t

    def start_thread_id(self):
        return self._th


def test_summary_from_events_without_an_activity_type():
    """Device operations are the CUDA events that are not the benchmark's
    own spans drawn on the device's timeline; the window cuts them; a gap
    is named by the span open when it began."""
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        _Event("window", cpu, 100, 1000),
        _Event("push", cpu, 100, 300),
        _Event("read", cpu, 400, 600),
        _Event("aten::copy_", cpu, 150, 10),
        _Event("push", cuda, 120, 900),  # the span as the device's timeline draws it
        _Event("lk_strip_kernel<2, 1, false>", cuda, 50, 100),  # starts before the window
        _Event("Memcpy HtoD (Pinned -> Device)", cuda, 500, 100),
        _Event("Memcpy DtoD (Device -> Device)", cuda, 550, 100),
    ]
    s = trace.summarize(events, frames=2, video={})
    assert s["window_s"] == 1000e-9
    assert s["busy_s"] == pytest.approx((50 + 150) * 1e-9)
    assert s["device_ops"]["lk_strip_kernel<2, 1, false>"] == {"calls": 1, "s": 50e-9}
    assert set(s["device_ops"]) == {"lk_strip_kernel<2, 1, false>",
                                    "Memcpy HtoD (Pinned -> Device)",
                                    "Memcpy DtoD (Device -> Device)"}
    assert s["host_spans"] == {"push": 300e-9, "read": 600e-9}
    assert [g[0] for g in s["idle_gaps"]] == ["all:read", "all:push", "longest:read",
                                              "longest:push"]
    assert [g[1] for g in s["idle_gaps"]] == pytest.approx([450e-9, 350e-9] * 2)
