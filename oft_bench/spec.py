"""``BENCHMARK.json`` and the pieces it names, found by name:

- a cell (``workloads`` entry) ``<config>.<traffic>``;
- ``configs/<config>.json``: the configuration as it is run (every field
  of the port's ``VideoConfig`` under ``video``, the frame size, where the
  configuration comes from, the guarantee and the limits of the check);
- ``traffic/<traffic>.json``: the mix's parameters, read by the one
  general driver (``oft_bench/traffic.py``);
- ``metrics/<metric>.py``: one reader a per-layer metric, ``read(summary)``
  returning a number or None (``oft_bench/trace.py`` makes the summary).

A new configuration, mix or metric is a new file and a new entry.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_benchmark(path: Optional[Path] = None) -> Dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(have {', '.join(w['name'] for w in bench['workloads'])})")


def _json(kind: str, name: str) -> Dict:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def config(name: str) -> Dict:
    return _json("configs", name)


def traffic(name: str) -> Dict:
    return _json("traffic", name)


def metric_reader(name: str) -> Callable[[Dict], Optional[float]]:
    """The ``read`` function of ``metrics/<name>.py``."""
    if not NAME.match(name):
        raise ValueError(f"bad metric name {name!r}")
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"oft_bench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def end_to_end(bench: Dict, cell_name: str) -> List[Dict]:
    """The end-to-end metrics a cell reports."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def per_layer(bench: Dict, cell_name: str) -> List[Dict]:
    """The per-layer metrics a cell reports: those listing it, and those
    listing no cells whose moved metric the cell reports."""
    reported = {m["name"] for m in end_to_end(bench, cell_name)}
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif m["moves"] in reported:
            out.append(m)
    return out
