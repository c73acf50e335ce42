"""S2-S4: the probes of csrc/probes.cu, each with its plain PyTorch version.

No flow path calls them: they measure, on the card, what the flow kernels
are made of (``chip_smoke.py`` phase 10).

  S2  interleave_rows_cuda, interleave_cols_cuda  the 2x interleave store of
      pyrUp's output (scripts/tpu_interleave_poc.py); columns with the
      (a, b) pairs formed in registers (store='float2') or through a tile in
      shared memory (store='smem'), both stored 16 bytes at a time
  S3  colsum_cuda  the 12-tap weighted column sum of K3/K4's stencil reads
      (scripts/tpu_roll_micro.py, the slice variant's output): four outputs a
      thread from its own float4 of input and its three right-hand
      neighbours', stored as one float4, 128 threads a block; the
      neighbours' float4s read from shared memory (reads='smem') or taken
      by warp shuffles (reads='shuffle'). Bound at the probe's (15, 88,
      1280), the window's inputs read and every output written
      (profiling.colsum_cost): 12.92 MB, 3.86 us at 3.35 TB/s
  S4  mul_add_chain_cuda  the elementwise rate: acc = a, then ``steps`` times
      acc = acc * b + a, float32 or bfloat16 (scripts/tpu_vpu_rate_probe.py)

Every kernel equals its plain version bit for bit. A CUDA tensor launches
the kernel or raises; a CPU tensor runs the plain version. S2-S4 take
their 16-byte path where ``quad_path`` says so, and otherwise the same
kernels one element a lane. S2's and S3's kernels index with 32 bits: on
the card their tensors hold fewer than 2^31 elements.
"""

from __future__ import annotations

import numpy as np
import torch

from optical_flow_tpu_torch.kernels import _lib

__all__ = [
    "BF16_NAMED_PAIRS", "S2_SHAPES", "S3_SHAPE", "S3_TAPS", "S3_WIN", "S4_SHAPE", "S4_STEPS",
    "bf16_sweep_patterns", "colsum_cuda", "colsum_plain", "interleave_cols_cuda",
    "interleave_cols_plain", "interleave_rows_cuda", "interleave_rows_plain",
    "mul_add_chain_cuda", "mul_add_chain_plain", "quad_path", "s3_sweep_values",
]

S2_SHAPES = ((256, 256), (1080, 540))  # the probe's planes and the timed (1080, 540) -> 1080^2
S3_SHAPE, S3_WIN, S3_TAPS = (15, 88, 1280), 1156, tuple(range(-5, 7))
S4_SHAPE, S4_STEPS = (512, 1024), 64


def _check_planes(name, a, b):
    if a.ndim != 2 or a.shape != b.shape:
        raise ValueError(f"{name}: two (H, W) planes of one shape, got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")


def _check_cuda_indexable(name, *tensors):
    """Contiguous float32 on one card, and fewer than 2^31 elements: the
    kernels index with 32 bits."""
    _lib.check_cuda_f32(name, *tensors)
    if tensors[0].numel() >= 2**31:
        raise ValueError(f"{name}: the kernels index tensors of fewer than 2^31 elements, got "
                         f"{tuple(tensors[0].shape)}")


def quad_path(*tensors: torch.Tensor, row_floats=None) -> bool:
    """Whether S2, S3 or S4 takes its 16-byte path on these tensors: every
    one starts on a 16-byte boundary and, for S2's rows and S3
    (``row_floats``, the width), so does every row (W % 4 == 0). Otherwise
    the kernel runs one element a lane (S3: loads and stores one float at a
    time); a ragged length is the 16-byte path's tail."""
    if row_floats is not None and row_floats % 4:
        return False
    return all(t.data_ptr() % 16 == 0 for t in tensors)


# ------------------------------------------------------------------ S2


def interleave_rows_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(2H, W): a in the even rows, b in the odd."""
    return torch.stack([a, b], dim=-2).reshape(2 * a.shape[0], a.shape[1])


def interleave_cols_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(H, 2W): a in the even columns, b in the odd."""
    return torch.stack([a, b], dim=-1).reshape(a.shape[0], 2 * a.shape[1])


def interleave_rows_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check_planes("interleave_rows_cuda", a, b)
    if not a.is_cuda:
        return interleave_rows_plain(a, b)
    _check_cuda_indexable("interleave_rows_cuda", a, b)
    H, W = a.shape
    out = torch.empty(2 * H, W, dtype=a.dtype, device=a.device)
    if a.numel():
        _lib.launch("oft_interleave_rows", a.device, a.data_ptr(), b.data_ptr(),
                    out.data_ptr(), H, W, int(quad_path(a, b, out, row_floats=W)))
    return out


_COL_STORES = {"float2": "oft_interleave_cols_f2", "smem": "oft_interleave_cols_smem"}


def interleave_cols_cuda(a: torch.Tensor, b: torch.Tensor, *, store: str = "float2") -> torch.Tensor:
    _check_planes("interleave_cols_cuda", a, b)
    if store not in _COL_STORES:
        raise ValueError(f"store must be one of {sorted(_COL_STORES)}, got {store!r}")
    if not a.is_cuda:
        return interleave_cols_plain(a, b)
    _check_cuda_indexable("interleave_cols_cuda", a, b)
    H, W = a.shape
    out = torch.empty(H, 2 * W, dtype=a.dtype, device=a.device)
    if a.numel():
        _lib.launch(_COL_STORES[store], a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                    H, W, int(quad_path(a, b, out)))
    return out


# ------------------------------------------------------------------ S3


def colsum_plain(x: torch.Tensor, win: int = S3_WIN) -> torch.Tensor:
    """out[..., o] = sum_t float32(0.1 t) * x[..., o + 6 + t] for o < win
    (t = -5..6, summed from 0 in the order of t), 0 for o >= win."""
    acc = torch.zeros(x.shape[:-1] + (win,), dtype=x.dtype, device=x.device)
    for t in S3_TAPS:
        acc = acc + float(np.float32(0.1 * t)) * x[..., 6 + t : 6 + t + win]
    out = torch.zeros_like(x)
    out[..., :win] = acc
    return out


def s3_sweep_values(rng, shape):
    """float32 inputs (numpy) for holding S3 bit for bit: segments of 16
    consecutive elements (in C order), each of one kind drawn at random:
    standard normal values; eight +0.0 then eight -0.0 (the window whose
    products are all -0.0: a sum started from its first product would be
    -0.0); subnormals of either sign (their products round to signed
    zeros); magnitudes in [2^127, 2^128) of either sign (partial sums
    overflow, and where depends on the order of the taps); normal values
    with one +-inf (0 * inf is NaN at the zero tap). ``rng`` is a numpy
    RandomState."""
    n = int(np.prod(shape))
    kind = np.repeat(rng.randint(0, 5, (n + 15) // 16), 16)[:n]
    sign = rng.randint(0, 2, n).astype(np.uint32) << 31
    x = rng.randn(n).astype(np.float32)
    zeros = np.where(np.arange(n) % 16 < 8, np.float32(0.0), np.float32(-0.0))
    subnormal = (sign | rng.randint(1, 1 << 23, n).astype(np.uint32)).view(np.float32)
    huge = (sign | (254 << 23) | rng.randint(0, 1 << 23, n).astype(np.uint32)).view(np.float32)
    x = np.select([kind == 1, kind == 2, kind == 3], [zeros, subnormal, huge], x)
    pos = np.repeat(rng.randint(0, 16, (n + 15) // 16), 16)[:n]
    inf = (kind == 4) & (np.arange(n) % 16 == pos)
    x[inf] = np.where(sign[inf], -np.inf, np.inf)
    return x.reshape(shape)


_COL_READS = {"smem": "oft_colsum_smem", "shuffle": "oft_colsum_shfl"}


def colsum_cuda(x: torch.Tensor, win: int = S3_WIN, *, reads: str = "smem") -> torch.Tensor:
    if reads not in _COL_READS:
        raise ValueError(f"reads must be one of {sorted(_COL_READS)}, got {reads!r}")
    W = x.shape[-1]
    if not 0 <= win <= W - 12:
        raise ValueError(f"colsum_cuda: the taps of window {win} reach past width {W}")
    if not x.is_cuda:
        return colsum_plain(x, win)
    _check_cuda_indexable("colsum_cuda", x)
    out = torch.empty_like(x)
    rows = x.numel() // max(W, 1)
    if rows and W:
        _lib.launch(_COL_READS[reads], x.device, x.data_ptr(), out.data_ptr(), rows, W, win,
                    int(quad_path(x, out, row_floats=W)))
    return out


# ------------------------------------------------------------------ S4


def mul_add_chain_plain(a: torch.Tensor, b: torch.Tensor, steps: int = S4_STEPS) -> torch.Tensor:
    acc = a
    for _ in range(steps):
        acc = acc * b + a
    return acc


# the last pairs of bf16_sweep_patterns: ties (1.0625^2, 1 + 2^-8,
# 0x3F81 + 2^-8), subnormal ties (2^-67 x 2^-67 = 2^-134, 1.5 x 2^-66 x
# 2^-67), signed zeros and a negative underflow, a gap of 30 binades, the
# least subnormals
BF16_NAMED_PAIRS = np.array(
    [[0x3F88, 0x3F88], [0x3F80, 0x3B80], [0x3F81, 0x3B80], [0x1E00, 0x1E00], [0x1EC0, 0x1E00],
     [0x8000, 0x40A0], [0x8000, 0x0000], [0x8000, 0x8000], [0x97C0, 0x17C0], [0x4480, 0x3580],
     [0x0001, 0x0001], [0x0001, 0x8001]], np.uint16)


def bf16_sweep_patterns(rng, k: int):
    """Pairs (a, b) of bfloat16 bit patterns (uint16 arrays) for holding
    S4's bfloat16 chain bit for bit: k random finite patterns over every
    exponent, then about k/8 pairs of each kind: subnormal inputs, both
    subnormal, results in the subnormal range, sums that are exact ties,
    products of (1 + 2^-i)(1 + 2^-j) over every exponent (ties, subnormal
    ties), exponent gaps of 8-30 binades; then the 12 pairs of
    ``BF16_NAMED_PAIRS``. ``rng`` is a numpy RandomState."""
    def bits(exp, man):
        return ((rng.randint(0, 2, exp.size) << 15) | (exp << 7) | man).astype(np.uint16)

    def some(lo, hi, n=k // 8):
        return rng.randint(lo, hi, n)

    n = k // 8
    a = [bits(some(0, 255, k), some(0, 128, k)), bits(np.zeros(n, int), some(0, 128)),
         bits(np.zeros(n, int), some(0, 128)),
         bits(some(1, 30), some(0, 128)), bits(some(1, 240), np.zeros(n, int)),
         bits(some(0, 200), 1 << some(0, 7)), bits(some(40, 200), some(0, 128))]
    b = [bits(some(0, 255, k), some(0, 128, k)), bits(some(100, 140), some(0, 128)),
         bits(np.zeros(n, int), some(0, 128)),
         bits(some(100, 127), some(0, 128)), bits(np.full(n, 135), some(0, 128)),
         bits(some(0, 130), 1 << some(0, 7)),
         bits(127 + rng.choice([-1, 1], n) * some(8, 31), some(0, 128))]
    return (np.concatenate(a + [BF16_NAMED_PAIRS[:, 0]]),
            np.concatenate(b + [BF16_NAMED_PAIRS[:, 1]]))


_CHAINS = {torch.float32: "oft_mul_add_chain_f32", torch.bfloat16: "oft_mul_add_chain_bf16"}


def mul_add_chain_cuda(a: torch.Tensor, b: torch.Tensor, steps: int = S4_STEPS) -> torch.Tensor:
    """The S4 chain in ``a``'s type (float32 or bfloat16), each multiply
    and add rounded as eager PyTorch rounds it."""
    if a.shape != b.shape or a.dtype != b.dtype or a.dtype not in _CHAINS:
        raise ValueError(f"mul_add_chain_cuda: two same-shaped float32 or bfloat16 tensors, got "
                         f"{tuple(a.shape)} {a.dtype} and {tuple(b.shape)} {b.dtype}")
    if not a.is_cuda:
        return mul_add_chain_plain(a, b, steps)
    _lib.check_cuda("mul_add_chain_cuda", a.dtype, a, b)
    out = torch.empty_like(a)
    if a.numel():
        _lib.launch(_CHAINS[a.dtype], a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                    a.numel(), steps, int(quad_path(a, b, out)))
    return out

