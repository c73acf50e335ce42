"""K1: dense single-level Lucas-Kanade as one CUDA kernel (csrc/lk.cu).

Replaces the TPU kernel ``optical_flow_tpu/kernels/lk_kernel.py::
_lk_pallas_batched`` (pallas_call at :173). One launch computes the 2x2
gradients of both frames, the five products, the 3x3 interior window sums
and the Cramer solve with det == 0 -> 0, and zeroes the 1-px ring; only the
two frames are read and only (u, v) written. A warp owns a strip of rows
and 29 output columns (one frame column a lane) or 60 (two a lane), and
keeps the whole LK tail in registers (no shared memory, no barrier); the
launcher picks the strip's shape by the grid. Its plain version is
``lucas_kanade_plain`` (= ``flow/lk.lucas_kanade_torch``); the kernel
equals it bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from optical_flow_tpu_torch.flow.lk import lucas_kanade_torch as lucas_kanade_plain
from optical_flow_tpu_torch.kernels import _lib

__all__ = ["lucas_kanade_cuda", "lucas_kanade_plain"]


def lucas_kanade_cuda(img1: torch.Tensor, img2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense LK on ``(..., H, W)`` frames through kernel K1.

    A CUDA tensor must be contiguous float32 and launches the kernel (or
    raises); a CPU tensor runs ``lucas_kanade_plain``. H < 3 or W < 3 gives
    zeros, as every pixel then lies on the border ring.
    """
    if img1.shape != img2.shape:
        raise ValueError(f"shape mismatch {tuple(img1.shape)} vs {tuple(img2.shape)}")
    if not img1.is_cuda:
        return lucas_kanade_plain(img1, img2)
    _lib.check_cuda_f32("lucas_kanade_cuda", img1, img2)
    H, W = img1.shape[-2], img1.shape[-1]
    if H < 3 or W < 3:
        return torch.zeros_like(img1), torch.zeros_like(img2)
    u = torch.empty_like(img1)
    v = torch.empty_like(img1)
    B = img1.numel() // (H * W)
    if B:
        _lib.launch(
            "oft_lk", img1.device, img1.data_ptr(), img2.data_ptr(), u.data_ptr(),
            v.data_ptr(), B, H, W,
        )
    return u, v
