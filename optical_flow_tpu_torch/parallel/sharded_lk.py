"""Spatially tiled dense Lucas–Kanade over a mesh (port of
optical_flow_tpu/parallel/sharded_lk.py).

One LK output depends on image pixels [i-2 .. i+1] x [j-2 .. j+1] (the 2x2
gradient stencil, then a 3x3 window sum), so a 2-px halo makes each tile
exact: run the single-device LK (kernel K1 on a CUDA tile) on the
reflect-extended (h+4, w+4) tile and cut out the centre. The reflect fill
at the frame's edge reproduces the unsharded op's own padding; the frame's
border ring, which the unsharded sums leave at 0, is re-imposed in global
coordinates. The result equals the unsharded LK bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from optical_flow_tpu_torch.flow.lk import lucas_kanade
from optical_flow_tpu_torch.ops.window import interior_mask
from optical_flow_tpu_torch.parallel.halo import exchange_halo
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

_HALO = 2  # gradient stencil (1 back) + 3x3 window (1 each way)


def sharded_lucas_kanade(
    img1, img2, mesh: FlowMesh, *, impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense LK with the images tiled over the mesh's rows and cols.

    img1/img2: (H, W) or (B, H, W); a leading batch is split over frames.
    H (W) must divide by the rows (cols) axis and tiles must be at least
    3x3 for the reflect fill.
    """
    rows_n, cols_n = mesh.shape[AXIS_ROWS], mesh.shape[AXIS_COLS]
    H, W = img1.shape[-2], img1.shape[-1]
    if H % rows_n or W % cols_n:
        raise ValueError(f"image {H}x{W} not divisible by mesh {rows_n}x{cols_n}")
    if H // rows_n < 3 or W // cols_n < 3:
        raise ValueError("tiles must be at least 3x3")
    require_mesh_probe(mesh)
    g1, g2 = split(img1, mesh), split(img2, mesh)
    e1, e2 = exchange_halo(g1, _HALO), exchange_halo(g2, _HALO)
    gu, gv = grid_like(g1), grid_like(g1)
    crop = (Ellipsis, slice(_HALO, -_HALO), slice(_HALO, -_HALO))
    for idx in local_indices(g1):
        u, v = lucas_kanade(e1[idx], e2[idx], impl=impl)
        h, w = g1[idx].shape[-2], g1[idx].shape[-1]
        keep = interior_mask(h, w, *tile_origin(g1, idx), H, W, device=u.device)
        zero = u.new_zeros(())
        gu[idx] = torch.where(keep, u[crop], zero)
        gv[idx] = torch.where(keep, v[crop], zero)
    return merge(gu, mesh), merge(gv, mesh)
