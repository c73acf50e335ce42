"""The control, the reference computed in TF32 (the next precision below
the configurations' float32 with TF32 off) put in the program's place,
comes out not correct against the reference at the CPU tests' size, on
three seeds; TF32 is emulated here by rounding the matmuls' operands to
its 10-bit mantissa (the CPU has no TF32 matmul)."""

import pytest

from oft_bench import check, harness, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 3, 77777])
def test_control_fails_the_check(cell, seed, small):
    cfg, mix = small(cell)
    s = harness.Setup(cfg, mix, seed, "cpu")
    harness.window(s, 2.0, False)
    kept = s.keeper.kept()
    assert kept
    rows = check.control_rows(cfg["video"], s.ring, mix["segment_frames"], kept, "cpu")
    numbers = dict(check.worst(rows), compared=len(rows))
    judged = check.judge(numbers, cfg["check"]["limits"])
    assert not check.passed(judged), judged
