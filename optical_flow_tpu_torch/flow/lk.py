"""Single-level dense Lucas–Kanade flow (reference C7, LKof.cpp:152-178):
fx/fy/ft -> five products -> five 3x3 interior window sums -> per-pixel 2x2
Cramer solve with divide-by-zero -> 0."""

from __future__ import annotations

from typing import Tuple

import torch

from optical_flow_tpu_torch.ops.gradients import spatio_temporal_gradients
from optical_flow_tpu_torch.ops.solve import solve_lk_2x2
from optical_flow_tpu_torch.ops.window import sum3x3_interior


def lucas_kanade_torch(img1, img2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch dense LK: the parity oracle and the plain version of
    kernel K1."""
    fx, fy, ft = spatio_temporal_gradients(img1, img2)
    prods = torch.stack([fx * fx, fy * fy, fx * fy, fx * ft, fy * ft], dim=0)
    sums = sum3x3_interior(prods)
    return solve_lk_2x2(sums[0], sums[1], sums[2], sums[3], sums[4])


def use_cuda(impl: str, is_cuda: bool) -> bool:
    """Whether ``impl`` routes through the kernels for a tensor that is
    (``is_cuda``) or is not on a CUDA device."""
    if impl == "cuda":
        return True
    if impl == "torch":
        return False
    if impl != "auto":
        raise ValueError(f"impl must be 'torch', 'cuda' or 'auto', got {impl!r}")
    return is_cuda


def lucas_kanade(img1, img2, *, impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense optical flow between two same-shaped ``(..., H, W)`` images.

    impl: ``'torch'`` (plain), ``'cuda'`` (kernel K1; a CPU tensor runs its
    plain version) or ``'auto'`` (``'cuda'`` for a CUDA tensor).
    """
    if use_cuda(impl, img1.is_cuda):
        from optical_flow_tpu_torch.kernels.lk_kernel import lucas_kanade_cuda

        return lucas_kanade_cuda(img1.contiguous(), img2.contiguous())
    return lucas_kanade_torch(img1, img2)
