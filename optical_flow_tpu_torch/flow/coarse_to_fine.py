"""Coarse-to-fine pyramidal flow controller (reference C9, LKof.cpp:191-228;
port of optical_flow_tpu/flow/coarse_to_fine.py).

The kernels are chosen per call from ``FlowConfig.impl`` and the device of
the frames: with the kernel route and the clamped, quantized shift_sep
warp, the inter-level step runs on K3 (``level_step``) and every other
warp+solve on K4 (``warp_solve``); every LK solve outside those runs on
K1 through ``lucas_kanade`` (with the exact ``'shift'`` or the
``'gather'`` warp, every level's solve); reference mode's inter-level
upsample runs on S1 (``upsample``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from optical_flow_tpu_torch.config import FlowConfig
from optical_flow_tpu_torch.flow.lk import lucas_kanade, use_cuda
from optical_flow_tpu_torch.flow.pyramid_loop import run_pyramid
from optical_flow_tpu_torch.ops.pyramid import gaussian_pyramid, max_pyramid_levels
from optical_flow_tpu_torch.ops.warp import symmetric_warp


def resolve_warp_impl(config: FlowConfig, is_cuda: bool):
    """(impl, max_disp) for symmetric_warp. ``'auto'`` is ``'shift_sep'``
    for CUDA frames when warp_clamp is set, else ``'gather'``. The shift
    forms need warp_clamp: their reach is half the clamped flow, plus 1 for
    the exact ``'shift'`` form's fixed-point rounding slack."""
    impl = config.warp_impl
    if impl == "auto":
        impl = "shift_sep" if (config.warp_clamp is not None and is_cuda) else "gather"
    if impl in ("shift", "shift_sep"):
        if config.warp_clamp is None:
            raise ValueError(f"warp_impl={impl!r} requires warp_clamp (bounded reach)")
        # flow-space quantization keeps |d| <= clamp/2 exactly
        reach = int(-(-config.warp_clamp // 2))
        return impl, reach + (1 if impl == "shift" else 0)
    if impl != "gather":
        raise ValueError(
            f"warp_impl must be 'gather', 'shift', 'shift_sep' or 'auto', got {impl!r}"
        )
    return "gather", 0


def _validate_levels(levels: Optional[int], shape, config: FlowConfig) -> int:
    if levels is None:
        levels = config.levels or max_pyramid_levels(shape)
    if levels < 1:
        raise ValueError(f"levels must be >= 1, got {levels}")
    max_levels = max_pyramid_levels(shape)
    if levels > max_levels:
        raise ValueError(
            f"levels={levels} too deep for {shape[-2]}x{shape[-1]} "
            f"(max {max_levels}, LKof.cpp:230-249 getMaxLayer)"
        )
    return levels


def _resolve_warp_solve(config: FlowConfig, warp_impl: str, max_disp: int, is_cuda: bool):
    """The K4 warp+solve callable for run_pyramid, or None when the kernel
    route or the clamped quantized shift_sep warp is not selected."""
    if not (
        use_cuda(config.impl, is_cuda)
        and warp_impl == "shift_sep"
        and config.quantize_warp
        and config.warp_clamp is not None
    ):
        return None
    from optical_flow_tpu_torch.kernels.warp_lk_kernel import warp_lk_cuda

    clamp = float(config.warp_clamp)

    def warp_solve(_i, a, b, wu, wv):
        # (wu, wv) arrive clamped and negated; the kernel's own clip is
        # idempotent on them, so negate=False reproduces the composition
        return warp_lk_cuda(
            a.contiguous(), b.contiguous(), wu.contiguous(), wv.contiguous(),
            max_disp=max_disp, clamp=clamp, negate=False,
        )

    return warp_solve


def _resolve_level_step(config: FlowConfig, max_disp: int, warp_solve):
    """The K3 inter-level callable for run_pyramid (corrected mode with a
    warp_solve), or None. Levels whose coarse flow is not exactly half the
    frame (odd H or W) take the plain upsample and K4."""
    if warp_solve is None or config.mode != "corrected":
        return None
    from optical_flow_tpu_torch.kernels.warp_lk_kernel import pyrup_warp_lk_cuda
    from optical_flow_tpu_torch.ops.pyramid import pyr_up_cols_first

    clamp = float(config.warp_clamp)

    def level_step(i, a, b, uc, vc):
        H, W = a.shape[-2], a.shape[-1]
        if uc.shape[-2] * 2 == H and uc.shape[-1] * 2 == W:
            return pyrup_warp_lk_cuda(
                a.contiguous(), b.contiguous(), uc.contiguous(), vc.contiguous(),
                max_disp=max_disp, clamp=clamp,
            )
        upu = 2.0 * pyr_up_cols_first(uc)
        upv = 2.0 * pyr_up_cols_first(vc)
        wu = -torch.clamp(upu, -clamp, clamp)
        wv = -torch.clamp(upv, -clamp, clamp)
        du, dv = warp_solve(i, a, b, wu, wv)
        return du + upu, dv + upv

    return level_step


def _resolve_upsample(config: FlowConfig, is_cuda: bool):
    """Reference mode's inter-level upsample of (u, v) for run_pyramid: S1
    on the kernel route, else None (the plain ``pyr_up``)."""
    if config.mode != "reference" or not use_cuda(config.impl, is_cuda):
        return None
    from optical_flow_tpu_torch.kernels.pyrup_kernel import pyr_up_pair_cuda

    def upsample(u, v):
        return pyr_up_pair_cuda(u.contiguous(), v.contiguous())

    return upsample


def coarse_to_fine_pyramids(
    pyr1, pyr2, *, config: FlowConfig = FlowConfig(), _need_images: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pyramidal LK over prebuilt Gaussian pyramids (level 0 finest)."""
    if len(pyr1) != len(pyr2):
        raise ValueError(f"pyramid depths differ: {len(pyr1)} vs {len(pyr2)}")
    is_cuda = pyr1[0].is_cuda

    def solve(_i, a, b):
        return lucas_kanade(a, b, impl=config.impl)

    warp_impl, max_disp = resolve_warp_impl(config, is_cuda)

    def warp(_i, a, b, u, v):
        return symmetric_warp(
            a, b, u, v, quantize=config.quantize_warp, impl=warp_impl, max_disp=max_disp
        )

    warp_solve = _resolve_warp_solve(config, warp_impl, max_disp, is_cuda)
    level_step = _resolve_level_step(config, max_disp, warp_solve)
    return run_pyramid(
        list(pyr1), list(pyr2), solve, warp, config,
        warp_solve=warp_solve, level_step=level_step,
        upsample=_resolve_upsample(config, is_cuda), need_images=_need_images,
    )


def coarse_to_fine_with_images(
    img1, img2, levels: Optional[int] = None, *, config: FlowConfig = FlowConfig(),
    _need_images: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pyramidal LK; returns (u, v, warped_img1, warped_img2): the finest
    frames after the last level warp (the reference's in-place contract)."""
    levels = _validate_levels(levels, img1.shape, config)
    pyr1 = gaussian_pyramid(img1, levels, impl=config.pyr_impl)
    pyr2 = gaussian_pyramid(img2, levels, impl=config.pyr_impl)
    return coarse_to_fine_pyramids(pyr1, pyr2, config=config, _need_images=_need_images)


def coarse_to_fine(
    img1, img2, levels: Optional[int] = None, *, config: FlowConfig = FlowConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pyramidal dense LK flow; returns (u, v)."""
    u, v, _, _ = coarse_to_fine_with_images(
        img1, img2, levels, config=config, _need_images=False
    )
    return u, v
