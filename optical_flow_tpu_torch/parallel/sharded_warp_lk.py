"""The fused warp+LK kernels K3 and K4, tiled over a mesh through their
tile mode K5 (port of optical_flow_tpu/parallel/sharded_warp_lk.py).

Each tile is extended by a halo of C + 2 pixels (C = ceil(clamp/2), the
quantized shift warp's tap reach, + 2 for the LK stencil on the warped
plane), the frames and the clamped flow alike, zero-filled beyond the
frame as the full-frame kernel's own margin is. K3's coarse flow carries
``pyrup_coarse_halo(C)`` rows and 2 columns with cv::pyrUp's border at the
frame's edges. The kernel takes the tile's global origin and the frame
size, so its interior mask and REFLECT_101 fixes are decided in global
coordinates and every tile equals the same region of the full-frame
kernel bit for bit. One launch per tile.

The gates are the card's. The JAX package also requires a Mosaic band
(``warp_lk_band``) and, for K3, ``h % 8 == 0``: VMEM and layout rules of
the TPU that the CUDA kernels do not have. The port's gates are geometric
only (K4: the halo fits in one neighbour tile; K3: the tile is even, so
its coarse tile is exactly half, and both halos fit in one neighbour
tile), so on one mesh the port may tile a level that the JAX package runs
whole, or the reverse. The output cannot differ: either way it equals the
unsharded path bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from optical_flow_tpu_torch.kernels.warp_lk_kernel import (
    pyrup_coarse_halo,
    pyrup_warp_lk_cuda,
    warp_lk_cuda,
)
from optical_flow_tpu_torch.parallel.halo import exchange_halo, exchange_halo_pyrup
from optical_flow_tpu_torch.parallel.mesh import (
    AXIS_COLS,
    AXIS_ROWS,
    FlowMesh,
    grid_like,
    local_indices,
    merge,
    split,
    tile_origin,
)
from optical_flow_tpu_torch.parallel.vma_compat import require_mesh_probe


def sharded_warp_lk_fits(shape, rows_n: int, cols_n: int, max_disp: int) -> bool:
    """Can K4 run per tile at this level? Its halo (C + 2) must fit in one
    neighbour tile."""
    h, w = shape[-2] // rows_n, shape[-1] // cols_n
    return max_disp + 2 <= min(h, w)


def sharded_pyrup_warp_lk_fits(shape, rows_n: int, cols_n: int, max_disp: int) -> bool:
    """Can K3 run per tile at this level? The tile must be even in both
    axes (its coarse tile is then exactly half) and both halos must fit in
    one neighbour tile."""
    h, w = shape[-2] // rows_n, shape[-1] // cols_n
    return (
        h % 2 == 0
        and w % 2 == 0
        and max_disp + 2 <= min(h, w)
        and pyrup_coarse_halo(max_disp) <= h // 2
        and 2 <= w // 2
    )


def _check(img1, mesh: FlowMesh, fits: bool, what: str, max_disp: int):
    rows_n, cols_n = mesh.shape[AXIS_ROWS], mesh.shape[AXIS_COLS]
    H, W = img1.shape[-2], img1.shape[-1]
    if H % rows_n or W % cols_n:
        raise ValueError(f"image {H}x{W} not divisible by mesh {rows_n}x{cols_n}")
    if not fits:
        raise ValueError(
            f"tile {H // rows_n}x{W // cols_n} (max_disp={max_disp}) does not fit {what}"
        )
    require_mesh_probe(mesh)
    return H, W


def sharded_warp_lk(
    img1, img2, u, v, mesh: FlowMesh, *, max_disp: int, clamp: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused symmetric shift_sep warp + LK (K4 tile mode), tiled over the
    mesh. img1/img2/u/v: (H, W) or (B, H, W); (u, v) already clamped and
    negated by the controller, as for the unsharded fused path. Returns
    (du, dv), bit-identical to ``warp_lk_cuda`` on the whole frames."""
    rows_n, cols_n = mesh.shape[AXIS_ROWS], mesh.shape[AXIS_COLS]
    fits = sharded_warp_lk_fits(img1.shape, rows_n, cols_n, max_disp)
    H, W = _check(img1, mesh, fits, "the warp+LK kernel's halo", max_disp)
    halo = max_disp + 2
    g1 = split(img1, mesh)
    # the extended tiles come out of torch.cat: contiguous, as the kernels take
    e1, e2, eu, ev = (
        exchange_halo(g, halo, border="zero")
        for g in (g1, split(img2, mesh), split(u, mesh), split(v, mesh))
    )
    gu, gv = grid_like(g1), grid_like(g1)
    for idx in local_indices(g1):
        gu[idx], gv[idx] = warp_lk_cuda(
            e1[idx], e2[idx], eu[idx], ev[idx], max_disp=max_disp, clamp=clamp,
            negate=False, halo=halo, origin=tile_origin(g1, idx), global_hw=(H, W),
        )
    return merge(gu, mesh), merge(gv, mesh)


def sharded_pyrup_warp_lk(
    img1, img2, u_coarse, v_coarse, mesh: FlowMesh, *, max_disp: int, clamp: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The corrected inter-level step (K3 tile mode), tiled over the mesh.

    img1/img2: level-i frames (H, W) or (B, H, W); u_coarse/v_coarse: the
    level-(i+1) accumulated flow (H/2, W/2). Returns this level's
    accumulated flow, bit-identical to ``pyrup_warp_lk_cuda`` on the whole
    frames.
    """
    rows_n, cols_n = mesh.shape[AXIS_ROWS], mesh.shape[AXIS_COLS]
    fits = sharded_pyrup_warp_lk_fits(img1.shape, rows_n, cols_n, max_disp)
    H, W = _check(img1, mesh, fits, "the inter-level kernel's halos", max_disp)
    halo, chalo = max_disp + 2, pyrup_coarse_halo(max_disp)
    g1 = split(img1, mesh)
    e1, e2 = (exchange_halo(g, halo, border="zero") for g in (g1, split(img2, mesh)))
    eu, ev = (exchange_halo_pyrup(split(c, mesh), chalo, 2) for c in (u_coarse, v_coarse))
    gu, gv = grid_like(g1), grid_like(g1)
    for idx in local_indices(g1):
        gu[idx], gv[idx] = pyrup_warp_lk_cuda(
            e1[idx], e2[idx], eu[idx], ev[idx], max_disp=max_disp, clamp=clamp,
            halo=halo, origin=tile_origin(g1, idx), global_hw=(H, W),
        )
    return merge(gu, mesh), merge(gv, mesh)
