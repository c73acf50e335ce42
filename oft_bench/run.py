"""The benchmark of ``optical_flow_tpu_torch`` on the card: one run of one
cell of ``BENCHMARK.json``.

    python3 -m oft_bench.run --workload fast_1080.stream --seed 7 --seconds 10 --trace 0

Prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number compared beside its limit,
which also end standard error. A traced run's window lasts at most
``harness.TRACE_WINDOW_S`` seconds. Exits non-zero, printing no result, without
as many CUDA devices as the cell asks for, or where a module of JAX or of
the JAX package was loaded once the window closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m oft_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from oft_bench import harness, spec

    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                           t_start=T_START, bench=bench)
    if out["forbidden"]:
        print(f"JAX or the JAX package was loaded: {', '.join(out['forbidden'])}",
              file=sys.stderr)
        return 4
    line = out["line"]
    st = out["stats"]
    print(f"window {st['seconds']:.3f} s, {st['frames']} results of {st['pushed']} frames; "
          f"check {out['check_s']:.1f} s over {len(out['rows'])} results", file=sys.stderr)
    for name, r in line["check"].items():
        bound = ">=" if name == "compared" else "<="
        print(f"check {name} {r['value']!r} {bound} {r['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
