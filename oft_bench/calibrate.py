"""Readings the limits of the check are set from, for one cell on the card,
in one process: for each seed, a short window of the cell's own traffic
and the check's numbers of the program against the reference (the lower
readings); of the control, the reference in TF32 put in the program's
place, against the reference in float32 at the same results (the upper
readings); and of two faults planted in the reference put in the
program's place at the cell's size, each kept result's flow moved a pixel
over a 16x16 tile or along the frame's bottom row, the gesture worked out
again from the moved flow.

    python3 -m oft_bench.calibrate --workload fast_1080.stream --seeds 1 2 3 --seconds 3

One JSON line a seed on standard output; not run by the benchmark itself.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _tile(u):
    u[..., 8:24, 8:24] += 1.0


def _bottom_row(u):
    u[..., -1, :] += 1.0


FAULTS = {"tile_16x16": _tile, "bottom_row": _bottom_row}


def fault_rows(video, ieee, plant):
    """The check's numbers of the reference results ``ieee`` with ``plant``
    applied to each one's u, against the reference."""
    from oft_bench import check
    from oft_bench.reference import plain

    rows = []
    for ru, rv, g in ieee.values():
        u = ru.clone()
        plant(u)
        f = plain.detect_gesture(u, rv, video["gesture"])
        scalars = [float(f.detected), float(f.cx), float(f.cy), float(f.votes)]
        rows.append(check.compare_one(u, rv, f.magnitude, scalars, (ru, rv, g)))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m oft_bench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    from oft_bench import check, harness, spec

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    cfg, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    video, seg = cfg["video"], mix["segment_frames"]
    device = torch.device("cuda:0")
    pipe = None
    for seed in args.seeds:
        t0 = time.perf_counter()
        s = harness.Setup(cfg, mix, seed, device, pipe=pipe)
        pipe = s.pipe
        out = harness.run_cell(args.workload, seed, args.seconds, False, device, bench=bench,
                               setup=s)
        rec = {"seed": seed, "correct": out["line"]["correct"],
               "frames_per_s": out["line"]["metrics"].get("frames_per_s", {}).get("value"),
               "program": check.worst(out["rows"]), "compared": len(out["rows"])}
        kept = s.keeper.kept()
        t1 = time.perf_counter()
        ieee = {(k, j): r for k, j, r in check.reference_rows(video, s.ring, seg, kept, device)}
        rec["control"] = check.worst(check.control_rows(video, s.ring, seg, kept, device, ieee))
        rec["control_s"] = time.perf_counter() - t1
        for name, plant in FAULTS.items():
            rec[name] = check.worst(fault_rows(video, ieee, plant))
        rec["seed_s"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
