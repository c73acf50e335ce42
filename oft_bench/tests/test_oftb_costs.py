"""The frozen cost arithmetic (``oft_bench/costs.py``) equals the program's
(``optical_flow_tpu_torch/utils/profiling.py``) today, for every kernel
call that the cells' frames make, at the cells' shapes."""

import pytest
import torch

from oft_bench import costs, spec
from optical_flow_tpu_torch.utils import profiling


def test_peaks_and_operation_counts_equal_the_program():
    assert costs.H100_BYTES_PER_S == profiling.H100["bytes_per_s"]
    assert costs.H100_F32_OPS_PER_S == profiling.H100["ops_per_s"][torch.float32]
    assert costs.OPS_PER_OUTPUT == profiling.OPS_PER_OUTPUT


def _meta(shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("cell", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_frame_work_equals_the_program_cost_of_each_call(cell):
    video = spec.config(spec.cell(spec.load_benchmark(), cell)["config"])["video"]
    work = costs.frame_work(video)
    assert work
    for kind, shape, cost in work:
        h, w = shape
        if kind == "pyramid":
            levels = [_meta((-(-h // 2 ** k), -(-w // 2 ** k))) for k in range(1, 4)]
            want = profiling.kernel_cost(kind, [_meta(shape)], levels,
                                         outputs_counted=sum(x.numel() for x in levels))
        elif kind == "lk":
            want = profiling.kernel_cost(kind, [_meta(shape)] * 2, [_meta(shape)] * 2)
        elif kind == "pyrup_warp_lk":
            c = _meta((h // 2, w // 2))
            want = profiling.kernel_cost(kind, [_meta(shape)] * 2 + [c, c], [_meta(shape)] * 2)
        else:
            up = _meta((2 * h, 2 * w))
            want = profiling.kernel_cost(kind, [_meta(shape)] * 2, [up, up])
        assert tuple(cost) == tuple(want), (kind, shape)
        r = profiling.stage_roofline(profiling.Cost(*want))
        assert costs.bound_s(cost) * 1e3 == pytest.approx(r["bound_ms"], rel=1e-12)


def test_frame_bounds_are_the_kernel_tables_sums():
    """The per-frame bounds the rooflines are held to: fast 1.850 (K2) +
    0.087 (K1 135^2) + 0.392 + 1.567 + 6.267 (K3) us; faithful K1 at four
    levels 7.399 us and S1 4.570 us (PERF.md's kernel table)."""
    fast = spec.config("fast_1080")["video"]
    faithful = spec.config("faithful_1080")["video"]
    assert costs.frame_bound_s(fast) * 1e6 == pytest.approx(10.16, abs=0.01)
    assert costs.frame_bound_s(faithful, ("lk",)) * 1e6 == pytest.approx(7.40, abs=0.01)
    assert costs.frame_bound_s(faithful, ("pyrup",)) * 1e6 == pytest.approx(4.57, abs=0.01)
    assert [k for k, _, _ in costs.frame_work(fast)] == [
        "pyramid", "lk", "pyrup_warp_lk", "pyrup_warp_lk", "pyrup_warp_lk"]
