"""The probes S2-S4 (kernels/probes.py) and the roofline model
(utils/profiling.py).

The TPU probes run their Pallas code when their scripts are imported, so
each plain version is held against the numpy formula its script checks
with, bit for bit: the interleaves of scripts/tpu_interleave_poc.py, the
slice variant's column sum of scripts/tpu_roll_micro.py, and the mul-add
chain of scripts/tpu_vpu_rate_probe.py (bfloat16 emulated in numpy: each
float32 result rounded to bfloat16, half to even). The tests marked
``cuda`` hold each kernel against its plain version on the card.
"""

import numpy as np
import pytest

import torch

from optical_flow_tpu_torch import kernels
from optical_flow_tpu_torch.kernels import probes
from optical_flow_tpu_torch.utils import profiling


def _bf16(x):
    """float32 -> the nearest bfloat16 (ties to even), as float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def _bf16_round_once(x):
    """float64 -> bfloat16 bit patterns (uint16), the value rounded once to
    the nearest bfloat16, ties to even, with subnormals, signed zeros and
    overflow to infinity; integer arithmetic on the float64 bits. Exact for
    any product of two bfloat16 values and, past an innocuous double
    rounding (53 >= 2 x 8 + 2), for any sum; no float64 subnormal arises."""
    u = np.ascontiguousarray(x, np.float64).view(np.uint64)
    sign = u >> np.uint64(63)
    e = ((u >> np.uint64(52)) & np.uint64(0x7FF)).astype(np.int64)
    m = (u & np.uint64((1 << 52) - 1)) | np.uint64(1 << 52)
    E = e - 1023
    Eq = np.maximum(E, -126)  # the exponent of the result's quantum, 2^(Eq - 7)
    shift = np.minimum(45 + Eq - E, 63).astype(np.uint64)  # bits of m below the quantum
    q = m >> shift
    rem = m & ((np.uint64(1) << shift) - np.uint64(1))
    half = np.uint64(1) << (shift - np.uint64(1))
    q = q + ((rem > half) | ((rem == half) & (q & np.uint64(1) == 1))).astype(np.uint64)
    bits = np.minimum(((Eq + 127) << 7) + q.astype(np.int64) - 128, 0x7F80)
    bits = np.where(e == 0, 0, bits)
    return ((sign << np.uint64(15)) | bits.astype(np.uint64)).astype(np.uint16)


def _as_bf16(bits):
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


def _s4_numpy(a, b, steps, bf16):
    rnd = _bf16 if bf16 else (lambda x: x)
    acc = a
    for _ in range(steps):
        acc = rnd(rnd(acc * b) + a)
    return acc


def _s3_numpy(x, win):
    acc = np.zeros(x.shape[:-1] + (win,), np.float32)
    with np.errstate(over="ignore", invalid="ignore"):  # the special values overflow, 0 * inf
        for t in range(-5, 7):
            acc = acc + np.float32(0.1 * t) * x[..., 6 + t : 6 + t + win]
    out = np.zeros_like(x)
    out[..., :win] = acc
    return out


def _f32_bits(x):
    """float32 bit patterns, every NaN as one pattern (its position counts,
    not the payload the CPU's SIMD unit gives it)."""
    x = np.array(x, np.float32)
    x[np.isnan(x)] = np.nan
    return x.view(np.int32)


# ---------------------------------------------------------------- S2


@pytest.mark.parametrize("shape", probes.S2_SHAPES)
@pytest.mark.parametrize("store", ["float2", "smem"])
def test_interleave_plain_matches_script(shape, store):
    rng = np.random.RandomState(0)
    a = rng.rand(*shape).astype(np.float32)
    b = rng.rand(*shape).astype(np.float32)
    want_rows = np.zeros((2 * shape[0], shape[1]), np.float32)
    want_rows[0::2], want_rows[1::2] = a, b
    want_cols = np.zeros((shape[0], 2 * shape[1]), np.float32)
    want_cols[:, 0::2], want_cols[:, 1::2] = a, b
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(probes.interleave_rows_cuda(ta, tb).numpy(), want_rows)
    np.testing.assert_array_equal(probes.interleave_cols_cuda(ta, tb, store=store).numpy(), want_cols)


def test_interleave_rejects_bad_input():
    z = torch.zeros(4, 6)
    with pytest.raises(ValueError):
        probes.interleave_cols_cuda(z, z, store="transpose")
    with pytest.raises(ValueError):
        probes.interleave_rows_cuda(z, z[:, :5])
    with pytest.raises(ValueError):
        probes.interleave_rows_cuda(torch.zeros(2, 4, 6), torch.zeros(2, 4, 6))


# ---------------------------------------------------------------- S3


@pytest.mark.parametrize("shape,win", [(probes.S3_SHAPE, probes.S3_WIN), ((3, 40), 28), ((2, 2, 13), 1),
                                       ((2, 1277), 1265), ((3, 1, 20), 0), ((1, 1280), 1268)])
@pytest.mark.parametrize("reads", ["smem", "shuffle"])
def test_colsum_plain_matches_script(shape, win, reads):
    """Uniform values, then S3's sweep values (signed zeros, subnormals,
    sums that overflow, +-inf), bit patterns compared: a sum started from
    the first product instead of +0, the zero tap dropped or another order
    of the taps would each differ on the second set."""
    rng = np.random.RandomState(1)
    for x in (rng.rand(*shape).astype(np.float32), probes.s3_sweep_values(rng, shape)):
        got = probes.colsum_cuda(torch.from_numpy(x), win, reads=reads)
        np.testing.assert_array_equal(_f32_bits(got.numpy()), _f32_bits(_s3_numpy(x, win)))


def test_colsum_rejects_a_window_past_the_row():
    with pytest.raises(ValueError):
        probes.colsum_cuda(torch.zeros(2, 20), 9)
    with pytest.raises(ValueError):
        probes.colsum_cuda(torch.zeros(2, 20), 8, reads="roll")


# ---------------------------------------------------------------- S4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mul_add_chain_plain_matches_script(dtype):
    rng = np.random.RandomState(2)
    a = rng.rand(*probes.S4_SHAPE).astype(np.float32) + 0.5
    b = rng.rand(*probes.S4_SHAPE).astype(np.float32) * 1e-3
    bf16 = dtype == torch.bfloat16
    if bf16:
        a, b = _bf16(a), _bf16(b)
    got = probes.mul_add_chain_cuda(torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), _s4_numpy(a, b, probes.S4_STEPS, bf16))


def test_mul_add_chain_rejects_other_types():
    with pytest.raises(ValueError):
        probes.mul_add_chain_cuda(torch.zeros(4, dtype=torch.float64), torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError):
        probes.mul_add_chain_cuda(torch.zeros(4), torch.zeros(4, dtype=torch.bfloat16))


@pytest.mark.parametrize("op", ["mul", "add"])
def test_bf16_mul_add_round_once(op):
    """Torch's bfloat16 multiply and add (float32, then rounded to
    bfloat16) equal the exact result rounded once to bfloat16: what S4's
    packed bf16x2 chain (mul.rn.bf16x2, add.rn.bf16x2) computes, so the
    kernel can equal the plain version bit for bit."""
    a, b = probes.bf16_sweep_patterns(np.random.RandomState(4), 100_000)
    fa, fb = (np.float64((x.astype(np.uint32) << 16).view(np.float32)) for x in (a, b))
    got = (_as_bf16(a) * _as_bf16(b)) if op == "mul" else (_as_bf16(a) + _as_bf16(b))
    want = _bf16_round_once(fa * fb if op == "mul" else fa + fb)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)
    # the named ties and zeros land where round-to-nearest-even puts them
    named = {"mul": {(0x3F88, 0x3F88): 0x3F90, (0x1E00, 0x1E00): 0x0000, (0x1EC0, 0x1E00): 0x0002,
                     (0x8000, 0x40A0): 0x8000, (0x97C0, 0x17C0): 0x8000},
             "add": {(0x3F80, 0x3B80): 0x3F80, (0x3F81, 0x3B80): 0x3F82, (0x8000, 0x0000): 0x0000,
                     (0x8000, 0x8000): 0x8000, (0x4480, 0x3580): 0x4480,
                     (0x0001, 0x8001): 0x0000}}[op]
    pairs = dict(zip(zip(a[-12:].tolist(), b[-12:].tolist()), want[-12:].tolist()))
    assert {k: pairs[k] for k in named} == named


def test_quad_path_choice():
    """S2-S4 take their 16-byte path where every tensor starts on a
    16-byte boundary and, for S2's rows and S3, every row does (W % 4 ==
    0); a ragged length runs as the 16-byte path's tail."""
    buf = torch.zeros(1080 * 540 + 1)
    a, off = buf[:-1].view(1080, 540), buf[1:].view(1080, 540)
    assert off.data_ptr() % 16 == 4
    assert probes.quad_path(a, a, row_floats=540) and probes.quad_path(a, a)
    ragged = torch.zeros(1080, 537)
    assert not probes.quad_path(ragged, ragged, row_floats=537)  # rows: scalar
    assert probes.quad_path(ragged, ragged)  # columns: the flat interleave, with a tail
    assert not probes.quad_path(off, a, row_floats=540) and not probes.quad_path(a, off)
    for dtype in (torch.float32, torch.bfloat16):
        odd = torch.zeros(524_288, dtype=dtype)
        assert probes.quad_path(odd[:-1], odd[:-1])  # odd n
        assert not probes.quad_path(odd[1:], odd[1:])  # 4 or 2 bytes past the boundary
    # S3: x and its output, rows of W floats
    x = torch.zeros(probes.S3_SHAPE)
    out = torch.empty_like(x)
    assert probes.quad_path(x, out, row_floats=1280)
    flat = torch.zeros(3 * 1277 + 1)
    assert not probes.quad_path(flat[:-1].view(3, 1277), out, row_floats=1277)  # ragged rows
    four = torch.zeros(3 * 1280 + 1)
    assert not probes.quad_path(four[1:].view(3, 1280), out, row_floats=1280)  # 4 bytes off


def test_interleave_large_cpu_planes_run_plain(monkeypatch):
    """S2's kernels index with 32 bits, so the card takes planes of fewer
    than 2^31 elements; a CPU plane of any size runs the plain version."""
    big = torch.zeros(1, 1).expand(2**16, 2**15)  # 2^31 elements, no memory behind them
    monkeypatch.setattr(probes, "interleave_rows_plain", lambda a, b: "rows, plain")
    monkeypatch.setattr(probes, "interleave_cols_plain", lambda a, b: "columns, plain")
    assert probes.interleave_rows_cuda(big, big) == "rows, plain"
    for store in ("float2", "smem"):
        assert probes.interleave_cols_cuda(big, big, store=store) == "columns, plain"


def test_colsum_large_cpu_input_runs_plain(monkeypatch):
    """S3's kernels index with 32 bits, so the card takes inputs of fewer
    than 2^31 elements; a CPU input of any size runs the plain version."""
    big = torch.zeros(1, 1).expand(2**16, 2**15)  # 2^31 elements, no memory behind them
    monkeypatch.setattr(probes, "colsum_plain", lambda x, win: ("plain", tuple(x.shape), win))
    for reads in ("smem", "shuffle"):
        assert probes.colsum_cuda(big, 1156, reads=reads) == ("plain", (2**16, 2**15), 1156)


def test_cpu_probes_launch_nothing():
    before = kernels.launch_counts()
    x = torch.rand(8, 32)
    probes.interleave_rows_cuda(x, x)
    probes.interleave_cols_cuda(x, x, store="smem")
    probes.colsum_cuda(x, 16, reads="shuffle")
    probes.mul_add_chain_cuda(x, x, 3)
    assert kernels.launch_counts() == before


# ---------------------------------------------------------- the roofline model


def test_kernel_costs_on_known_shapes():
    """Each input byte read once and each output byte written once, against
    3.35 TB/s (the worked examples of the kernel table)."""
    px = 1080 * 1080
    f = torch.zeros(1080, 1080)
    q = torch.zeros(540, 540)
    k1 = profiling.kernel_cost("lk", [f, f], [f, f])
    assert k1 == profiling.Cost(4 * 4 * px, 77 * px)
    r = profiling.stage_roofline(k1, 0.0557)
    assert r["bound_by"] == "bytes" and r["bound_ms"] == pytest.approx(18_662_400 / 3.35e12 * 1e3)
    assert r["bound_ms"] * 1e3 == pytest.approx(5.571, abs=1e-3)  # us
    assert r["share_of_bound"] == pytest.approx(0.1, rel=1e-3)
    s1 = profiling.kernel_cost("pyrup", [q, q], [f, f])
    assert s1.bytes == 2 * 4 * 540 * 540 + 2 * 4 * px == 11_664_000
    assert profiling.stage_roofline(s1)["bound_ms"] * 1e3 == pytest.approx(3.482, abs=1e-3)
    k3 = profiling.kernel_cost("pyrup_warp_lk", [f, f, q, q], [f, f])
    assert k3.bytes == 18 * px
    assert profiling.stage_roofline(k3)["bound_ms"] * 1e3 == pytest.approx(6.267, abs=1e-3)
    s3 = profiling.kernel_cost("colsum", [], [torch.zeros(1)], outputs_counted=15 * 88 * 1156)
    assert s3.ops == 24 * 15 * 88 * 1156
    assert profiling.stage_roofline(s3)["bound_by"] == "operations"


@pytest.mark.parametrize("shape, win, read", [((15, 88, 1280), 1156, 1167), ((3, 40), 28, 39),
                                              ((2, 13), 0, 0)])
def test_colsum_cost_reads_only_the_window(shape, win, read):
    """S3 reads x[..., 1 : win + 12] (nothing at win = 0) and writes every
    output: 12.92 MB, 3.857 us at the probe's shape."""
    rows, W = int(np.prod(shape[:-1])), shape[-1]
    c = profiling.colsum_cost(shape, win)
    assert c == profiling.Cost(4 * rows * (read + W), 24 * rows * win)
    if shape == probes.S3_SHAPE:
        assert c.bytes == 12_920_160
        assert profiling.stage_roofline(c)["bound_ms"] * 1e3 == pytest.approx(3.857, abs=1e-3)
        assert profiling.stage_roofline(c)["bound_by"] == "bytes"


def test_stage_roofline_against_measured_rates():
    c = profiling.Cost(1e9, 1e9)
    r = profiling.stage_roofline(c, 1.0, rates={"bytes_per_s": 2e12,
                                                "ops_per_s": {torch.float32: 1e11}})
    assert r["bound_by"] == "bytes" and r["bound_ms"] == pytest.approx(1e9 / 3.35e12 * 1e3)
    assert r["sustained_by"] == "operations"
    assert r["sustained_ms"] == pytest.approx(10.0)
    assert r["share_of_sustained"] == pytest.approx(10.0)
    assert "share_of_bound" in r and "share_of_sustained" not in profiling.stage_roofline(c)
    bf = torch.zeros(4, 4, dtype=torch.bfloat16)
    assert profiling.io_bytes([bf, torch.zeros(2, 2, dtype=torch.float32)]) == 32 + 16


@pytest.mark.parametrize("dtype, peak, bound_us", [(torch.float32, 67e12, 1.878),
                                                   (torch.bfloat16, 133.8e12, 0.939)])
def test_stage_roofline_peak_follows_the_operations_type(dtype, peak, bound_us):
    """The operations' peak is the card's rate outside the tensor cores for
    their type. S4's chain on (512, 1024) (a, b read and the result written
    in the chain's type, 2 operations a step) is bound by its bytes in
    either type once bfloat16 takes its own rate, twice float32's."""
    ops_only = profiling.stage_roofline(profiling.Cost(0.0, 1e12), dtype=dtype)
    assert ops_only["bound_by"] == "operations"
    assert ops_only["bound_ms"] == pytest.approx(1e12 / peak * 1e3)
    n = 512 * 1024
    size = torch.zeros((), dtype=dtype).element_size()
    r = profiling.stage_roofline(profiling.Cost(3 * size * n, 2 * 64 * n), dtype=dtype)
    assert r["bound_by"] == "bytes"
    assert r["bound_ms"] * 1e3 == pytest.approx(bound_us, abs=1e-3)  # us


def test_device_timing_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        profiling.time_use_once(lambda: None, [(), ()], "cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        profiling.time_use_once(lambda: None, [(), ()], "cpu")


# ---------------------------------------------------- on the card (marked)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _same_bits(got, want):
    ints = torch.int16 if want.dtype == torch.bfloat16 else torch.int32
    return got.dtype == want.dtype and torch.equal(got.view(ints), want.view(ints))


def _counted(name, fn):
    before = kernels.launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    return out


@pytest.mark.cuda
def test_probes_on_card_equal_plain(cuda_device):
    rng = np.random.RandomState(3)

    def on(*shape, scale=1.0, dtype=torch.float32):
        return (torch.from_numpy(rng.rand(*shape).astype(np.float32)) * scale).to(cuda_device, dtype)

    for shape in probes.S2_SHAPES:
        a, b = on(*shape), on(*shape)
        want_r, want_c = probes.interleave_rows_plain(a, b), probes.interleave_cols_plain(a, b)
        assert torch.equal(_counted("oft_interleave_rows", lambda: probes.interleave_rows_cuda(a, b)),
                           want_r)
        for store, entry in (("float2", "oft_interleave_cols_f2"), ("smem", "oft_interleave_cols_smem")):
            got = _counted(entry, lambda: probes.interleave_cols_cuda(a, b, store=store))
            assert torch.equal(got, want_c)
    x = on(*probes.S3_SHAPE)
    for reads, entry in (("smem", "oft_colsum_smem"), ("shuffle", "oft_colsum_shfl")):
        assert torch.equal(_counted(entry, lambda: probes.colsum_cuda(x, reads=reads)),
                           probes.colsum_plain(x))
    for dtype, entry in ((torch.float32, "oft_mul_add_chain_f32"),
                         (torch.bfloat16, "oft_mul_add_chain_bf16")):
        a, b = on(*probes.S4_SHAPE, dtype=dtype) + 0.5, on(*probes.S4_SHAPE, scale=1e-3, dtype=dtype)
        want = probes.mul_add_chain_plain(a, b)
        assert _same_bits(_counted(entry, lambda: probes.mul_add_chain_cuda(a, b)), want)

    # S2 over ragged, tiny and unaligned planes (data_ptr % 16 == 4), both paths
    def plane(H, W, offset):
        return on(H * W + 1)[offset : offset + H * W].view(H, W)

    for H in (1, 2, 1080):
        for W in (1, 3, 537, 540):
            for offset in (0, 1):
                a, b = plane(H, W, offset), plane(H, W, offset)
                want_r, want_c = probes.interleave_rows_plain(a, b), probes.interleave_cols_plain(a, b)
                assert _same_bits(probes.interleave_rows_cuda(a, b), want_r), (H, W, offset)
                for store in ("float2", "smem"):
                    got = probes.interleave_cols_cuda(a, b, store=store)
                    assert _same_bits(got, want_c), (store, H, W, offset)
    # S3, both forms, over ragged and narrow widths, windows at 0, 1 and W -
    # 12, 1-1,320 rows, unaligned views and special values
    for lead, W in (((1,), 13), ((3, 1), 16), ((3,), 1277), ((15, 88), 1280)):
        for offset in (0, 1):
            n = int(np.prod(lead)) * W
            x = torch.from_numpy(probes.s3_sweep_values(rng, (n + 1,))).to(cuda_device)
            x = x[offset : offset + n].view(*lead, W)
            for win in sorted({0, 1, min(1156, W - 12), W - 12}):
                want = probes.colsum_plain(x, win)
                for reads in ("smem", "shuffle"):
                    assert _same_bits(probes.colsum_cuda(x, win, reads=reads), want), (lead, W, offset, win)
    # S4 at odd n, several step counts, unaligned; bfloat16 subnormals, ties,
    # signed zeros, negatives and exponent gaps
    ab, bb = probes.bf16_sweep_patterns(np.random.RandomState(5), 20_000)
    special = (_as_bf16(ab).to(cuda_device), _as_bf16(bb).to(cuda_device))
    for dtype in (torch.float32, torch.bfloat16):
        for n in (1, 3, 9, 1001):
            for offset in (0, 1):
                a = (on(n + 1, dtype=dtype) + 0.5)[offset : offset + n]
                b = on(n + 1, scale=1e-3, dtype=dtype)[offset : offset + n]
                for steps in (0, 1, 3, 64):
                    assert _same_bits(probes.mul_add_chain_cuda(a, b, steps),
                                      probes.mul_add_chain_plain(a, b, steps)), (dtype, n, offset, steps)
    for offset in (0, 1):
        a, b = (x[offset:] for x in special)
        for steps in (0, 1, 3, 64):
            assert _same_bits(probes.mul_add_chain_cuda(a, b, steps),
                              probes.mul_add_chain_plain(a, b, steps)), (offset, steps)


@pytest.mark.cuda
def test_time_use_once_on_card(cuda_device):
    sets = [(torch.rand(512, 1024, device=cuda_device) + 0.5, torch.rand(512, 1024, device=cuda_device))
            for _ in range(9)]
    ms = profiling.time_use_once(probes.mul_add_chain_cuda, sets, cuda_device)
    assert 0.0 < ms < 1.0
