"""Mesh-sharded coarse-to-fine pyramidal flow (port of
optical_flow_tpu/parallel/sharded_flow.py).

- frame axis: a batch of frame pairs is split over the mesh's frames;
- fine levels: the LK solve runs tiled (``sharded_lucas_kanade``, exact
  2-px halo), the clamped warp runs tiled (``sharded_symmetric_warp``),
  and on the kernel route the fused steps run per tile through K5
  (``sharded_warp_lk``, ``sharded_pyrup_warp_lk``);
- global ops run on the mesh's home device, as XLA runs them replicated in
  the JAX path: the pyramid, the levels too small or too odd to tile, the
  full-frame fallbacks and (in the pipeline) the gesture.

A level is tiled when its size divides the spatial mesh and tiles stay
>= MIN_TILE; a fused step is tiled when, in addition, the card's gate of
parallel/sharded_warp_lk.py admits the tile. Otherwise the level takes the
unsharded controller's route. Nothing falls back silently: a route either
applies or is not taken, and a kernel that fails raises. Results are
bit-identical to the unsharded controller.

The pyramid is built with the unsharded port's ``pyr_impl`` rule, K2 on a
CUDA home device. The JAX controller forces ``'auto'`` to ``'poly'`` on the
mesh, because a pallas_call under XLA's automatic sharding was unproven
there; the port's pyramid runs whole on one device, where K2 is
bit-identical to ``'poly'`` (PERF.md), so no such rule is needed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from optical_flow_tpu_torch.config import FlowConfig
from optical_flow_tpu_torch.flow.coarse_to_fine import (
    _resolve_level_step,
    _resolve_upsample,
    _resolve_warp_solve,
    _validate_levels,
    resolve_warp_impl,
)
from optical_flow_tpu_torch.flow.lk import lucas_kanade
from optical_flow_tpu_torch.flow.pyramid_loop import run_pyramid
from optical_flow_tpu_torch.ops.pyramid import gaussian_pyramid
from optical_flow_tpu_torch.ops.warp import symmetric_warp
from optical_flow_tpu_torch.parallel.mesh import AXIS_COLS, AXIS_ROWS, FlowMesh
from optical_flow_tpu_torch.parallel.sharded_lk import sharded_lucas_kanade
from optical_flow_tpu_torch.parallel.sharded_warp import sharded_symmetric_warp
from optical_flow_tpu_torch.parallel.sharded_warp_lk import (
    sharded_pyrup_warp_lk,
    sharded_pyrup_warp_lk_fits,
    sharded_warp_lk,
    sharded_warp_lk_fits,
)

MIN_TILE = 32  # don't spatially tile levels smaller than this per tile


def _tileable(shape, rows_n: int, cols_n: int, min_tile: int) -> bool:
    H, W = shape[-2], shape[-1]
    return H % rows_n == 0 and W % cols_n == 0 and H // rows_n >= min_tile and W // cols_n >= min_tile


def _on_home(mesh: FlowMesh, *tensors) -> None:
    for t in tensors:
        if t.device != mesh.home:
            raise ValueError(f"inputs must be on the mesh's home device {mesh.home}, got {t.device}")


def sharded_coarse_to_fine(
    img1, img2, mesh: FlowMesh, levels: Optional[int] = None, *,
    config: FlowConfig = FlowConfig(), min_tile: int = MIN_TILE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pyramidal dense LK with the fine levels tiled over the mesh.

    img1/img2: (H, W) or (B, H, W) on the mesh's home device, B split over
    frames. Semantics identical to flow.coarse_to_fine.
    """
    u, v, _, _ = sharded_coarse_to_fine_with_images(
        img1, img2, mesh, levels, config=config, min_tile=min_tile, _need_images=False,
    )
    return u, v


def sharded_coarse_to_fine_with_images(
    img1, img2, mesh: FlowMesh, levels: Optional[int] = None, *,
    config: FlowConfig = FlowConfig(), min_tile: int = MIN_TILE, _need_images: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Like flow.coarse_to_fine_with_images, mesh-sharded: returns (u, v,
    warped_img1, warped_img2), the finest frames after the last level warp
    (the reference's in-place contract, LKof.cpp:193-226)."""
    _on_home(mesh, img1, img2)
    levels = _validate_levels(levels, img1.shape, config)
    pyr1 = gaussian_pyramid(img1, levels, impl=config.pyr_impl)
    pyr2 = gaussian_pyramid(img2, levels, impl=config.pyr_impl)
    return sharded_coarse_to_fine_pyramids(
        pyr1, pyr2, mesh, config=config, min_tile=min_tile, _need_images=_need_images,
    )


def sharded_coarse_to_fine_pyramids(
    pyr1, pyr2, mesh: FlowMesh, *, config: FlowConfig = FlowConfig(),
    min_tile: int = MIN_TILE, _need_images: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mesh-sharded pyramidal LK over prebuilt pyramids (level 0 finest):
    the streaming entry point, each frame's pyramid serving both its pairs
    (pipeline/video.py)."""
    if len(pyr1) != len(pyr2):
        raise ValueError(f"pyramid depths differ: {len(pyr1)} vs {len(pyr2)}")
    _on_home(mesh, *pyr1, *pyr2)
    rows_n, cols_n = mesh.shape[AXIS_ROWS], mesh.shape[AXIS_COLS]
    is_cuda = pyr1[0].is_cuda
    # one warp-impl decision for the whole pyramid, shared with the
    # unsharded controller so sharded == unsharded for any config
    warp_impl, warp_max_disp = resolve_warp_impl(config, is_cuda)
    halo_k = None if config.warp_clamp is None else int(-(-config.warp_clamp // 2)) + 1

    def tiles(a) -> bool:
        return _tileable(a.shape, rows_n, cols_n, min_tile)

    def solve(_i, a, b):
        if tiles(a):
            return sharded_lucas_kanade(a, b, mesh, impl=config.impl)
        return lucas_kanade(a, b, impl=config.impl)

    def warp(_i, a, b, u, v):
        if (
            halo_k is not None
            and tiles(a)
            # the warp halo must fit within one neighbour tile
            and halo_k <= min(a.shape[-2] // rows_n, a.shape[-1] // cols_n)
        ):
            return sharded_symmetric_warp(
                a, b, u, v, mesh, config.warp_clamp, quantize=config.quantize_warp,
                impl=warp_impl,
            )
        return symmetric_warp(
            a, b, u, v, quantize=config.quantize_warp, impl=warp_impl, max_disp=warp_max_disp
        )

    warp_solve = _resolve_sharded_warp_solve(
        config, warp_impl, warp_max_disp, is_cuda, mesh, min_tile
    )
    level_step = _resolve_sharded_level_step(config, warp_max_disp, mesh, min_tile, warp_solve)
    # reference mode's upsample runs whole on the home device, as the pyramid does
    return run_pyramid(
        list(pyr1), list(pyr2), solve, warp, config,
        warp_solve=warp_solve, level_step=level_step,
        upsample=_resolve_upsample(config, is_cuda), need_images=_need_images,
    )


def _resolve_sharded_warp_solve(config, warp_impl, max_disp, is_cuda, mesh, min_tile):
    """The fused warp+LK callable for run_pyramid, or None: the unsharded
    controller's K4 route (``_resolve_warp_solve``), with the levels whose
    tiles pass the card's gate run per tile through K5."""
    base = _resolve_warp_solve(config, warp_impl, max_disp, is_cuda)
    if base is None:
        return None
    rows_n, cols_n = mesh.shape[AXIS_ROWS], mesh.shape[AXIS_COLS]
    clamp = float(config.warp_clamp)

    def warp_solve(i, a, b, wu, wv):
        # (wu, wv) arrive clamped and negated, as on the unsharded route
        if _tileable(a.shape, rows_n, cols_n, min_tile) and sharded_warp_lk_fits(
            a.shape, rows_n, cols_n, max_disp
        ):
            return sharded_warp_lk(a, b, wu, wv, mesh, max_disp=max_disp, clamp=clamp)
        return base(i, a, b, wu, wv)

    return warp_solve


def _resolve_sharded_level_step(config, max_disp, mesh, min_tile, warp_solve):
    """The fused inter-level callable for run_pyramid, or None: the
    unsharded controller's K3 route (``_resolve_level_step``, built over the
    sharded ``warp_solve``), with the levels whose tiles pass the card's
    gate run per tile through K5."""
    base = _resolve_level_step(config, max_disp, warp_solve)
    if base is None:
        return None
    rows_n, cols_n = mesh.shape[AXIS_ROWS], mesh.shape[AXIS_COLS]
    clamp = float(config.warp_clamp)

    def level_step(i, a, b, uc, vc):
        H, W = a.shape[-2], a.shape[-1]
        if (
            uc.shape[-2] * 2 == H
            and uc.shape[-1] * 2 == W
            and _tileable(a.shape, rows_n, cols_n, min_tile)
            and sharded_pyrup_warp_lk_fits(a.shape, rows_n, cols_n, max_disp)
        ):
            return sharded_pyrup_warp_lk(a, b, uc, vc, mesh, max_disp=max_disp, clamp=clamp)
        return base(i, a, b, uc, vc)

    return level_step
