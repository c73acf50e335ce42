"""K3 and K4: the clamped symmetric shift_sep warp fused with LK
(csrc/warp_lk.cu), and K5, their tile mode.

K4, ``warp_lk_cuda``, replaces ``optical_flow_tpu/kernels/warp_lk_kernel.py::
_warp_lk_batched`` (pallas_call at :370): clip -> negate -> quantized
half-flow -> symmetric warp -> LK, returning (du, dv). Its plain version is
``warp_lk_plain``.

K3, ``pyrup_warp_lk_cuda``, replaces ``_pyrup_warp_lk_batched`` (pallas_call
at :667): the corrected pyramid's whole inter-level step, up = 2 *
pyrUp(coarse flow) -> K4 with negate -> (du + up_u, dv + up_v). Its plain
version is ``pyrup_warp_lk_plain``.

In both, the frames, the flow and the warped values stay in shared memory
and registers; only the frames and the flow are read and only the result is
written. The TPU kernels' band and VMEM rules do not apply on the card: K4
takes any shape, K3 any even H, W with the coarse flow exactly half. A
block's shared memory grows with ``max_disp`` (C); a C whose block does not
fit in the card's shared memory is refused at launch and the wrapper raises
(on an H100 every C up to 49 fits).

K5, the tile mode (``halo``, ``origin``, ``global_hw``, the JAX keywords),
serves the mesh-sharded path (parallel/sharded_warp_lk.py): the inputs are
one tile of a ``global_hw`` frame whose first pixel sits at ``origin``,
extended by ``halo`` >= C + 2 pixels per side (neighbour data inside the
frame, 0 beyond it); K3's coarse flow is extended by
``pyrup_coarse_halo(C)`` rows and 2 columns with cv::pyrUp's border at the
frame's edges (parallel/halo.py ``exchange_halo_pyrup``). The output is the
tile's (..., h, w), equal bit for bit to the full-frame result over the
same pixels; the C entry points are ``oft_warp_lk_tile`` and
``oft_pyrup_warp_lk_tile``. The plain versions take the same keywords.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from optical_flow_tpu_torch.flow.lk import lucas_kanade_torch
from optical_flow_tpu_torch.kernels import _lib
from optical_flow_tpu_torch.ops.pyramid import _up_cols, _up_rows, pyr_up_cols_first
from optical_flow_tpu_torch.ops.warp import symmetric_warp
from optical_flow_tpu_torch.ops.window import interior_mask

__all__ = [
    "pyrup_coarse_halo",
    "pyrup_warp_lk_cuda",
    "pyrup_warp_lk_plain",
    "warp_lk_cuda",
    "warp_lk_plain",
]


def pyrup_coarse_halo(max_disp: int) -> int:
    """Rows of halo a tile-mode coarse flow carries (its columns carry 2):
    the JAX kernel's coarse-buffer offset R//2 + 1, R = round_up(C+2, 4)."""
    return -(-(int(max_disp) + 2) // 4) * 4 // 2 + 1


def _check_max_disp(max_disp: int) -> int:
    if int(max_disp) <= 0:
        raise ValueError(f"max_disp must be > 0, got {max_disp}")
    return int(max_disp)


def _tile(shape, C: int, halo: int, origin, global_hw):
    """(h, w, row0, col0, Hg, Wg) of a tile-mode call, or None for a full
    frame (halo 0, no origin or global size)."""
    if not halo:
        if origin is not None or global_hw is not None:
            raise ValueError("origin and global_hw need a halo (tile mode)")
        return None
    if halo < C + 2:
        raise ValueError(f"tile mode needs halo >= max_disp + 2 = {C + 2}, got {halo}")
    h, w = shape[-2] - 2 * halo, shape[-1] - 2 * halo
    if h <= 0 or w <= 0:
        raise ValueError(f"extended tile {tuple(shape)} is not larger than 2 * halo {halo}")
    row0, col0 = (0, 0) if origin is None else (int(origin[0]), int(origin[1]))
    Hg, Wg = (h, w) if global_hw is None else (int(global_hw[0]), int(global_hw[1]))
    if not (0 <= row0 and row0 + h <= Hg and 0 <= col0 and col0 + w <= Wg):
        raise ValueError(f"tile {h}x{w} at {(row0, col0)} lies outside the {Hg}x{Wg} frame")
    return h, w, row0, col0, Hg, Wg


def warp_lk_plain(
    img1, img2, u, v, *, max_disp: int, clamp: float, negate: bool = True,
    halo: int = 0, origin=None, global_hw: Optional[Tuple[int, int]] = None,
):
    """The unfused composition K4 computes; with a halo, K5's tile mode:
    the warp runs on the extended tile, the warped planes are cut to the
    tile plus the 2-px reach of the LK stencil and REFLECT_101-fixed where
    the tile touches the frame's top/left edge, and the frame's border ring
    is zeroed in global coordinates."""
    C = _check_max_disp(max_disp)
    tile = _tile(img1.shape, C, halo, origin, global_hw)
    wu = torch.clamp(u, -clamp, clamp)
    wv = torch.clamp(v, -clamp, clamp)
    if negate:
        wu, wv = -wu, -wv
    w1, w2 = symmetric_warp(img1, img2, wu, wv, quantize=True, impl="shift_sep", max_disp=C)
    if tile is None:
        return lucas_kanade_torch(w1, w2)
    h, w, row0, col0, Hg, Wg = tile
    k = halo - 2  # exact warped values cover tile rows/cols [-2, h+2), [-2, w+2)
    w1, w2 = (x[..., k : k + h + 4, k : k + w + 4] for x in (w1, w2))
    if row0 == 0:  # rows -2, -1 := 2, 1, what LK's reflect padding reads
        w1, w2 = (torch.cat([x[..., 4:5, :], x[..., 3:4, :], x[..., 2:, :]], -2) for x in (w1, w2))
    if col0 == 0:
        w1, w2 = (torch.cat([x[..., 4:5], x[..., 3:4], x[..., 2:]], -1) for x in (w1, w2))
    du, dv = lucas_kanade_torch(w1, w2)
    keep = interior_mask(h, w, row0, col0, Hg, Wg, device=du.device)
    zero = du.new_zeros(())
    return (torch.where(keep, du[..., 2:-2, 2:-2], zero),
            torch.where(keep, dv[..., 2:-2, 2:-2], zero))


def _check_coarse(img_shape, c_shape, C: int, tile) -> int:
    """Raise unless the coarse flow fits the frames; return its row halo."""
    H, W = (img_shape[-2], img_shape[-1]) if tile is None else tile[:2]
    ocr = 0 if tile is None else pyrup_coarse_halo(C)
    if (
        H % 2 or W % 2 or tuple(c_shape[:-2]) != tuple(img_shape[:-2])
        or c_shape[-2] != H // 2 + 2 * ocr
        or c_shape[-1] != W // 2 + (4 if ocr else 0)
    ):
        raise ValueError(
            f"coarse flow {tuple(c_shape)} is not the exact half of {H}x{W}"
            + (f" extended by {ocr} rows and 2 columns" if ocr else "")
        )
    return ocr


def _up_tile(c, halo: int, ocr: int, tile):
    """2 * pyr_up_cols_first of a tile-mode coarse flow on the tile's
    extended grid (rows and columns [-halo, h+halo)), from the tile's rows
    [-halo, h+halo) and columns [-2, w+2) and 0 elsewhere and outside the
    frame."""
    h, w, row0, col0, Hg, Wg = tile
    up = 2.0 * _up_rows(_up_cols(c))  # rows [2 - 2*ocr, h + 2*ocr - 2), cols [-2, w+2)
    r = 2 * ocr - 2 - halo
    if r < 0:
        raise ValueError(f"halo {halo} exceeds the coarse flow's reach (2 * {ocr} - 2)")
    up = up[..., r : r + h + 2 * halo, :]
    z = up.new_zeros(up.shape[:-1] + (halo - 2,))
    up = torch.cat([z, up, z], -1)
    ys = torch.arange(row0 - halo, row0 + h + halo, device=up.device)[:, None]
    xs = torch.arange(col0 - halo, col0 + w + halo, device=up.device)[None, :]
    inside = (ys >= 0) & (ys < Hg) & (xs >= 0) & (xs < Wg)
    return torch.where(inside, up, up.new_zeros(()))


def pyrup_warp_lk_plain(
    img1, img2, u_coarse, v_coarse, *, max_disp: int, clamp: float,
    halo: int = 0, origin=None, global_hw: Optional[Tuple[int, int]] = None,
):
    """The unfused composition K3 computes; with a halo, K5's tile mode
    (the upsampled flow formed on the extended tile, then ``warp_lk_plain``
    in tile mode)."""
    C = _check_max_disp(max_disp)
    tile = _tile(img1.shape, C, halo, origin, global_hw)
    ocr = _check_coarse(img1.shape, u_coarse.shape, C, tile)
    if tile is None:
        upu = 2.0 * pyr_up_cols_first(u_coarse)
        upv = 2.0 * pyr_up_cols_first(v_coarse)
        du, dv = warp_lk_plain(img1, img2, upu, upv, max_disp=C, clamp=clamp, negate=True)
        return du + upu, dv + upv
    h, w = tile[0], tile[1]
    upu, upv = _up_tile(u_coarse, halo, ocr, tile), _up_tile(v_coarse, halo, ocr, tile)
    du, dv = warp_lk_plain(img1, img2, upu, upv, max_disp=C, clamp=clamp, negate=True,
                           halo=halo, origin=origin, global_hw=global_hw)
    inner = (Ellipsis, slice(halo, halo + h), slice(halo, halo + w))
    return du + upu[inner], dv + upv[inner]


def warp_lk_cuda(
    img1, img2, u, v, *, max_disp: int, clamp: float, negate: bool = True,
    halo: int = 0, origin=None, global_hw: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused clip -> (negate) -> symmetric shift_sep warp -> LK on
    ``(..., H, W)`` planes through kernel K4, or on one extended tile
    through K5 (``halo``, ``origin``, ``global_hw``); returns (du, dv).

    A CUDA tensor must be contiguous float32 and launches the kernel (or
    raises); a CPU tensor runs ``warp_lk_plain``.
    """
    C = _check_max_disp(max_disp)
    if not (img1.shape == img2.shape == u.shape == v.shape):
        raise ValueError("img1, img2, u and v must have one shape")
    tile = _tile(img1.shape, C, halo, origin, global_hw)
    if not img1.is_cuda:
        return warp_lk_plain(img1, img2, u, v, max_disp=C, clamp=clamp, negate=negate,
                             halo=halo, origin=origin, global_hw=global_hw)
    _lib.check_cuda_f32("warp_lk_cuda", img1, img2, u, v)
    He, We = img1.shape[-2], img1.shape[-1]
    H, W = (He, We) if tile is None else tile[:2]
    du = img1.new_empty(img1.shape[:-2] + (H, W))
    dv = img1.new_empty(img1.shape[:-2] + (H, W))
    B = img1.numel() // max(He * We, 1)
    half = -0.5 if negate else 0.5
    if B and H and W:
        ptrs = (img1.data_ptr(), img2.data_ptr(), u.data_ptr(), v.data_ptr(), du.data_ptr(),
                dv.data_ptr())
        if tile is None:
            _lib.launch("oft_warp_lk", img1.device, *ptrs, B, H, W, C, float(clamp), half)
        else:
            _lib.launch("oft_warp_lk_tile", img1.device, *ptrs, B, H, W, C, float(clamp), half,
                        int(halo), *tile[2:])
    return du, dv


def pyrup_warp_lk_cuda(
    img1, img2, u_coarse, v_coarse, *, max_disp: int, clamp: float,
    halo: int = 0, origin=None, global_hw: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The corrected inter-level step through kernel K3: ``img1``/``img2``
    are level-i frames (..., H, W) with H, W even, ``u_coarse``/``v_coarse``
    the level-(i+1) flow (..., H/2, W/2). Returns the accumulated level-i
    flow (du + 2*pyrUp(u_coarse), dv + 2*pyrUp(v_coarse)).

    Tile mode (K5): the frames are an even h x w tile extended by ``halo``
    per side, the coarse flow (..., h/2 + 2*pyrup_coarse_halo(C), w/2 + 4).

    A CUDA tensor must be contiguous float32 and launches the kernel (or
    raises); a CPU tensor runs ``pyrup_warp_lk_plain``.
    """
    C = _check_max_disp(max_disp)
    if img1.shape != img2.shape or u_coarse.shape != v_coarse.shape:
        raise ValueError("frame shapes or coarse flow shapes differ")
    tile = _tile(img1.shape, C, halo, origin, global_hw)
    ocr = _check_coarse(img1.shape, u_coarse.shape, C, tile)
    H, W = (img1.shape[-2], img1.shape[-1]) if tile is None else tile[:2]
    if not img1.is_cuda:
        return pyrup_warp_lk_plain(img1, img2, u_coarse, v_coarse, max_disp=C, clamp=clamp,
                                   halo=halo, origin=origin, global_hw=global_hw)
    _lib.check_cuda_f32("pyrup_warp_lk_cuda", img1, img2, u_coarse, v_coarse)
    u = img1.new_empty(img1.shape[:-2] + (H, W))
    v = img1.new_empty(img1.shape[:-2] + (H, W))
    B = img1.numel() // max(img1.shape[-2] * img1.shape[-1], 1)
    if B and H and W:
        ptrs = (img1.data_ptr(), img2.data_ptr(), u_coarse.data_ptr(), v_coarse.data_ptr(),
                u.data_ptr(), v.data_ptr())
        if tile is None:
            _lib.launch("oft_pyrup_warp_lk", img1.device, *ptrs, B, H, W, C, float(clamp))
        else:
            _lib.launch("oft_pyrup_warp_lk_tile", img1.device, *ptrs, B, H, W, C, float(clamp),
                        int(halo), ocr, *tile[2:])
    return u, v
