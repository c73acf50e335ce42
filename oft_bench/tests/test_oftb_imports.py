"""The import rule: nothing the command loads is JAX, a JAX library or
the JAX package (``optical_flow_tpu``), top-level names compared whole
(``optical_flow_tpu_torch`` begins with ``optical_flow_tpu``); the plain
reference and the check load nothing of the port either. Each in a fresh
interpreter, so what another test imported does not count."""

import json
import subprocess
import sys

from oft_bench import spec

PROBE_RUN = """
import json, sys
sys.path.insert(0, 'oft_bench/tests')
from conftest import small_config, small_mix
from oft_bench import harness
import oft_bench.run, oft_bench.calibrate
cfg, mix = small_config('{config}'), small_mix('{traffic}')
out = harness.run_cell('{cell}', 5, 0.3, {traced}, 'cpu', cfg=cfg, mix=mix)
top = sorted({{m.split('.')[0] for m in sys.modules}})
print(json.dumps({{"forbidden": out["forbidden"], "top": top}}))
"""

PROBE_REFERENCE = """
import json, sys
import oft_bench.reference.plain, oft_bench.reference.stream, oft_bench.check
import oft_bench.costs, oft_bench.frames, oft_bench.trace, oft_bench.spec
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""


def _run(code):
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_whole_run_loads_no_jax():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        for traced in (False, True):
            got = _run(PROBE_RUN.format(config=w["config"], traffic=w["traffic"], cell=w["name"],
                                        traced=traced))
            assert got["forbidden"] == []
            assert "optical_flow_tpu_torch" in got["top"]
            assert not {"jax", "jaxlib", "flax", "optical_flow_tpu"} & set(got["top"])


def test_the_reference_and_the_check_load_nothing_of_the_port():
    top = set(_run(PROBE_REFERENCE))
    assert not {"jax", "jaxlib", "flax", "optical_flow_tpu", "optical_flow_tpu_torch"} & top
