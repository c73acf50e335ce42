"""S1: cv::pyrUp of the flow's two planes as one CUDA kernel (csrc/pyrup.cu).

Replaces the TPU kernel ``scripts/tpu_pyrup_poc.py::pyrup_pallas``
(pallas_call at :40, kernel :22). It computes ``ops.pyramid.pyr_up`` (rows
first, then columns, cv::pyrUp's asymmetric border) of ``u`` and ``v`` in
one launch: two input and two output pointers, so no stacked copy is made.
The border is computed in the kernel, so no padded copy is made either. A
thread owns two coarse columns and walks a strip of coarse rows, loading
each once; it writes each output row as one 16-byte store where the coarse
width is even (two 8-byte stores where it is odd). Its plain version is
``pyr_up_pair_plain``, ``pyr_up`` of each plane; the kernel equals it bit
for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from optical_flow_tpu_torch.kernels import _lib
from optical_flow_tpu_torch.ops.pyramid import pyr_up

__all__ = ["pyr_up_pair_cuda", "pyr_up_pair_plain"]


def pyr_up_pair_plain(u: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return pyr_up(u), pyr_up(v)


def pyr_up_pair_cuda(u: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(pyr_up(u), pyr_up(v))`` of two same-shaped ``(..., Hc, Wc)``
    planes, each output exactly ``(..., 2Hc, 2Wc)``, through kernel S1.

    CUDA tensors must be contiguous float32 and launch the kernel (or
    raise); CPU tensors run ``pyr_up_pair_plain``.
    """
    if u.shape != v.shape:
        raise ValueError(f"shape mismatch {tuple(u.shape)} vs {tuple(v.shape)}")
    if not u.is_cuda:
        return pyr_up_pair_plain(u, v)
    _lib.check_cuda_f32("pyr_up_pair_cuda", u, v)
    Hc, Wc = u.shape[-2], u.shape[-1]
    shape = u.shape[:-2] + (2 * Hc, 2 * Wc)
    uo = torch.empty(shape, dtype=u.dtype, device=u.device)
    vo = torch.empty(shape, dtype=u.dtype, device=u.device)
    B = u.numel() // max(Hc * Wc, 1)
    if B and Hc and Wc:
        _lib.launch("oft_pyrup", u.device, u.data_ptr(), v.data_ptr(), uo.data_ptr(),
                    vo.data_ptr(), B, Hc, Wc)
    return uo, vo
