"""K3 and K4: the clamped symmetric shift_sep warp fused with LK
(csrc/warp_lk.cu).

K4, ``warp_lk_cuda``, replaces ``optical_flow_tpu/kernels/warp_lk_kernel.py::
_warp_lk_batched`` (pallas_call at :370): clip -> negate -> quantized
half-flow -> symmetric warp -> LK, returning (du, dv). Its plain version is
``warp_lk_plain``.

K3, ``pyrup_warp_lk_cuda``, replaces ``_pyrup_warp_lk_batched`` (pallas_call
at :667): the corrected pyramid's whole inter-level step, up = 2 *
pyrUp(coarse flow) -> K4 with negate -> (du + up_u, dv + up_v). Its plain
version is ``pyrup_warp_lk_plain``.

In both, the warped frames stay in shared memory; only the frames and the
flow are read and only the result is written. The TPU kernels' band and
VMEM rules do not apply on the card: K4 takes any shape, K3 any even H, W
with the coarse flow exactly half. The tile mode of the TPU kernels (halo,
origin, global size) serves the mesh-sharded path and is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from optical_flow_tpu_torch.flow.lk import lucas_kanade_torch
from optical_flow_tpu_torch.kernels import _lib
from optical_flow_tpu_torch.ops.pyramid import pyr_up_cols_first
from optical_flow_tpu_torch.ops.warp import symmetric_warp

__all__ = ["pyrup_warp_lk_cuda", "pyrup_warp_lk_plain", "warp_lk_cuda", "warp_lk_plain"]


def warp_lk_plain(img1, img2, u, v, *, max_disp: int, clamp: float, negate: bool = True):
    """The unfused composition K4 computes."""
    wu = torch.clamp(u, -clamp, clamp)
    wv = torch.clamp(v, -clamp, clamp)
    if negate:
        wu, wv = -wu, -wv
    w1, w2 = symmetric_warp(
        img1, img2, wu, wv, quantize=True, impl="shift_sep", max_disp=max_disp
    )
    return lucas_kanade_torch(w1, w2)


def pyrup_warp_lk_plain(img1, img2, u_coarse, v_coarse, *, max_disp: int, clamp: float):
    """The unfused composition K3 computes."""
    upu = 2.0 * pyr_up_cols_first(u_coarse)
    upv = 2.0 * pyr_up_cols_first(v_coarse)
    du, dv = warp_lk_plain(img1, img2, upu, upv, max_disp=max_disp, clamp=clamp, negate=True)
    return du + upu, dv + upv


def _check_max_disp(max_disp: int) -> int:
    if int(max_disp) <= 0:
        raise ValueError(f"max_disp must be > 0, got {max_disp}")
    return int(max_disp)


def warp_lk_cuda(
    img1, img2, u, v, *, max_disp: int, clamp: float, negate: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused clip -> (negate) -> symmetric shift_sep warp -> LK on
    ``(..., H, W)`` planes through kernel K4; returns (du, dv).

    A CUDA tensor must be contiguous float32 and launches the kernel (or
    raises); a CPU tensor runs ``warp_lk_plain``.
    """
    C = _check_max_disp(max_disp)
    if not (img1.shape == img2.shape == u.shape == v.shape):
        raise ValueError("img1, img2, u and v must have one shape")
    if not img1.is_cuda:
        return warp_lk_plain(img1, img2, u, v, max_disp=C, clamp=clamp, negate=negate)
    _lib.check_cuda_f32("warp_lk_cuda", img1, img2, u, v)
    H, W = img1.shape[-2], img1.shape[-1]
    du = torch.empty_like(img1)
    dv = torch.empty_like(img1)
    B = img1.numel() // max(H * W, 1)
    if B and H and W:
        _lib.launch(
            "oft_warp_lk", img1.device, img1.data_ptr(), img2.data_ptr(), u.data_ptr(),
            v.data_ptr(), du.data_ptr(), dv.data_ptr(), B, H, W, C, float(clamp),
            -0.5 if negate else 0.5,
        )
    return du, dv


def pyrup_warp_lk_cuda(
    img1, img2, u_coarse, v_coarse, *, max_disp: int, clamp: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The corrected inter-level step through kernel K3: ``img1``/``img2``
    are level-i frames (..., H, W) with H, W even, ``u_coarse``/``v_coarse``
    the level-(i+1) flow (..., H/2, W/2). Returns the accumulated level-i
    flow (du + 2*pyrUp(u_coarse), dv + 2*pyrUp(v_coarse)).

    A CUDA tensor must be contiguous float32 and launches the kernel (or
    raises); a CPU tensor runs ``pyrup_warp_lk_plain``.
    """
    C = _check_max_disp(max_disp)
    if img1.shape != img2.shape or u_coarse.shape != v_coarse.shape:
        raise ValueError("frame shapes or coarse flow shapes differ")
    H, W = img1.shape[-2], img1.shape[-1]
    if (
        u_coarse.shape[:-2] != img1.shape[:-2]
        or u_coarse.shape[-2] * 2 != H
        or u_coarse.shape[-1] * 2 != W
    ):
        raise ValueError(
            f"coarse flow {tuple(u_coarse.shape)} is not the exact half of {tuple(img1.shape)}"
        )
    if not img1.is_cuda:
        return pyrup_warp_lk_plain(img1, img2, u_coarse, v_coarse, max_disp=C, clamp=clamp)
    _lib.check_cuda_f32("pyrup_warp_lk_cuda", img1, img2, u_coarse, v_coarse)
    u = torch.empty_like(img1)
    v = torch.empty_like(img1)
    B = img1.numel() // max(H * W, 1)
    if B and H and W:
        _lib.launch(
            "oft_pyrup_warp_lk", img1.device, img1.data_ptr(), img2.data_ptr(),
            u_coarse.data_ptr(), v_coarse.data_ptr(), u.data_ptr(), v.data_ptr(), B, H, W,
            C, float(clamp),
        )
    return u, v
