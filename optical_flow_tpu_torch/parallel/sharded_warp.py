"""Spatially tiled symmetric warp (port of
optical_flow_tpu/parallel/sharded_warp.py).

A warp's reach is bounded only by the flow, so tiling needs the flow
clamped to ``max_disp`` (``FlowConfig.warp_clamp``, applied identically by
the unsharded controller). The halo is then

    k = ceil(max_disp / 2) + 1     (half-flow warp + bilinear tap;
                                    shift_sep: no +1, its flow-space
                                    quantization adds no rounding slack)

with zero fill at the frame's edges (cv2.remap's BORDER_CONSTANT 0).
'gather' builds its maps in global coordinates and shifts the tap indices
to the halo tile after quantization (``remap_bilinear(index_offset=)``),
an exact integer step; 'shift_sep' is position-independent and needs only
the neighbour rows' x-displacement for its x-pass; 'shift' pads one zero
ring around the halo tile (the margin ``shift_warp_sum`` expects, whose
weight is always exactly 0) and computes its displacements from global
coordinates (``shift_disp_fields``). All three equal the unsharded warp
bit for bit.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from optical_flow_tpu_torch.ops.pad import pad_last2
from optical_flow_tpu_torch.ops.warp import (
    quantize_disp,
    remap_bilinear,
    shift_disp_fields,
    shift_warp_sum,
    symmetric_shift_sep_sum,
)
from optical_flow_tpu_torch.parallel.halo import exchange_halo, exchange_halo_rows
from optical_flow_tpu_torch.parallel.mesh import (
    AXIS_COLS,
    AXIS_ROWS,
    FlowMesh,
    grid_like,
    grid_map,
    local_indices,
    merge,
    split,
    tile_origin,
)


def sharded_symmetric_warp(
    img1, img2, u, v, mesh: FlowMesh, max_disp: float, *, quantize: bool = True,
    impl: str = "gather",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp both frames half-way toward each other, tiled over the mesh.

    u/v must already be clamped to [-max_disp, max_disp] (the controller
    does this); the halo covers exactly that reach. impl: 'gather', 'shift'
    or 'shift_sep', each bit-identical to the unsharded warp of that form.
    """
    if impl not in ("gather", "shift", "shift_sep"):
        raise ValueError(f"unknown tiled warp impl {impl!r}")
    rows_n, cols_n = mesh.shape[AXIS_ROWS], mesh.shape[AXIS_COLS]
    k = int(math.ceil(max_disp / 2.0)) + (0 if impl == "shift_sep" else 1)
    tile_h, tile_w = img1.shape[-2] // rows_n, img1.shape[-1] // cols_n
    if k > min(tile_h, tile_w):
        # a halo ships at most one whole neighbour tile
        raise ValueError(
            f"warp halo {k} (max_disp={max_disp}) exceeds tile {tile_h}x{tile_w}; "
            "lower warp_clamp or the spatial mesh"
        )
    if not torch.is_floating_point(img1):
        img1, img2 = img1.to(torch.float32), img2.to(torch.float32)
    g1, g2 = split(img1, mesh), split(img2, mesh)
    e1 = exchange_halo(g1, k, border="zero")
    e2 = exchange_halo(g2, k, border="zero")
    hx = grid_map(lambda t: t.to(torch.float32) / 2.0, split(u, mesh))
    hy = grid_map(lambda t: t.to(torch.float32) / 2.0, split(v, mesh))
    if impl == "shift_sep":
        dx = grid_map(lambda t: quantize_disp(t, k, quantize=quantize), hx)
        dy = grid_map(lambda t: quantize_disp(t, k, quantize=quantize), hy)
        dx_ext = exchange_halo_rows(dx, k, border="zero")
        w1, w2 = grid_map(lambda a, b, x, y: symmetric_shift_sep_sum(a, b, x, y, k),
                          e1, e2, dx_ext, dy)
        return merge(w1, mesh), merge(w2, mesh)
    w1, w2 = grid_like(g1), grid_like(g1)
    for idx in local_indices(g1):
        h, w = g1[idx].shape[-2], g1[idx].shape[-1]
        row0, col0 = tile_origin(g1, idx)
        dev = g1[idx].device
        # maps in global coordinates (the unsharded warp's float32
        # arithmetic); tap indices move to the halo tile after quantization
        xs = torch.arange(col0, col0 + w, dtype=torch.float32, device=dev)[None, :]
        ys = torch.arange(row0, row0 + h, dtype=torch.float32, device=dev)[:, None]
        if impl == "shift":
            dx, dy = shift_disp_fields(xs + hx[idx], ys + hy[idx], xs, ys, k,
                                       quantize=quantize, dtype=e1[idx].dtype)
            w1[idx] = shift_warp_sum(pad_last2(e1[idx], 1, 1, 1, 1, mode="constant"), dx, dy, k)
            dx, dy = shift_disp_fields(xs - hx[idx], ys - hy[idx], xs, ys, k,
                                       quantize=quantize, dtype=e2[idx].dtype)
            w2[idx] = shift_warp_sum(pad_last2(e2[idx], 1, 1, 1, 1, mode="constant"), dx, dy, k)
            continue
        off = (k - row0, k - col0)
        w1[idx] = remap_bilinear(e1[idx], xs + hx[idx], ys + hy[idx], quantize=quantize,
                                 index_offset=off)
        w2[idx] = remap_bilinear(e2[idx], xs - hx[idx], ys - hy[idx], quantize=quantize,
                                 index_offset=off)
    return merge(w1, mesh), merge(w2, mesh)
