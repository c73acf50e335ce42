"""S2-S4: the probes of csrc/probes.cu, each with its plain PyTorch version.

No flow path calls them: they measure, on the card, what the flow kernels
are made of (``chip_smoke.py`` phase 10).

  S2  interleave_rows_cuda, interleave_cols_cuda  the 2x interleave store of
      pyrUp's output (scripts/tpu_interleave_poc.py); columns as float2
      stores from registers (store='float2') or through shared memory
      (store='smem')
  S3  colsum_cuda  the 12-tap weighted column sum of K3/K4's stencil reads
      (scripts/tpu_roll_micro.py, the slice variant's output); taps read from
      a shared-memory row (reads='smem') or by warp shuffles (reads='shuffle')
  S4  mul_add_chain_cuda  the elementwise rate: acc = a, then ``steps`` times
      acc = acc * b + a, float32 or bfloat16 (scripts/tpu_vpu_rate_probe.py)

Every kernel equals its plain version bit for bit. A CUDA tensor launches
the kernel or raises; a CPU tensor runs the plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from optical_flow_tpu_torch.kernels import _lib

__all__ = [
    "S2_SHAPES", "S3_SHAPE", "S3_TAPS", "S3_WIN", "S4_SHAPE", "S4_STEPS",
    "colsum_cuda", "colsum_plain", "interleave_cols_cuda", "interleave_cols_plain",
    "interleave_rows_cuda", "interleave_rows_plain", "mul_add_chain_cuda",
    "mul_add_chain_plain",
]

S2_SHAPES = ((256, 256), (1080, 540))  # the probe's planes and the timed (1080, 540) -> 1080^2
S3_SHAPE, S3_WIN, S3_TAPS = (15, 88, 1280), 1156, tuple(range(-5, 7))
S4_SHAPE, S4_STEPS = (512, 1024), 64


def _check_planes(name, a, b):
    if a.ndim != 2 or a.shape != b.shape:
        raise ValueError(f"{name}: two (H, W) planes of one shape, got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")


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
    _lib.check_cuda_f32("interleave_rows_cuda", a, b)
    H, W = a.shape
    out = torch.empty(2 * H, W, dtype=a.dtype, device=a.device)
    if a.numel():
        _lib.launch("oft_interleave_rows", a.device, a.data_ptr(), b.data_ptr(),
                    out.data_ptr(), H, W)
    return out


_COL_STORES = {"float2": "oft_interleave_cols_f2", "smem": "oft_interleave_cols_smem"}


def interleave_cols_cuda(a: torch.Tensor, b: torch.Tensor, *, store: str = "float2") -> torch.Tensor:
    _check_planes("interleave_cols_cuda", a, b)
    if store not in _COL_STORES:
        raise ValueError(f"store must be one of {sorted(_COL_STORES)}, got {store!r}")
    if not a.is_cuda:
        return interleave_cols_plain(a, b)
    _lib.check_cuda_f32("interleave_cols_cuda", a, b)
    H, W = a.shape
    out = torch.empty(H, 2 * W, dtype=a.dtype, device=a.device)
    if a.numel():
        _lib.launch(_COL_STORES[store], a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                    H, W)
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


_COL_READS = {"smem": "oft_colsum_smem", "shuffle": "oft_colsum_shfl"}


def colsum_cuda(x: torch.Tensor, win: int = S3_WIN, *, reads: str = "smem") -> torch.Tensor:
    if reads not in _COL_READS:
        raise ValueError(f"reads must be one of {sorted(_COL_READS)}, got {reads!r}")
    W = x.shape[-1]
    if not 0 <= win <= W - 12:
        raise ValueError(f"colsum_cuda: the taps of window {win} reach past width {W}")
    if not x.is_cuda:
        return colsum_plain(x, win)
    _lib.check_cuda_f32("colsum_cuda", x)
    out = torch.empty_like(x)
    rows = x.numel() // max(W, 1)
    if rows and W:
        _lib.launch(_COL_READS[reads], x.device, x.data_ptr(), out.data_ptr(), rows, W, win)
    return out


# ------------------------------------------------------------------ S4


def mul_add_chain_plain(a: torch.Tensor, b: torch.Tensor, steps: int = S4_STEPS) -> torch.Tensor:
    acc = a
    for _ in range(steps):
        acc = acc * b + a
    return acc


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
                    a.numel(), steps)
    return out
