"""Bilinear image warping (OpenCV ``remap`` semantics; reference C9 warps).

The reference remaps both frames half-way toward each other: img1 at
``(x + u/2, y + v/2)``, img2 at ``(x - u/2, y - v/2)``, INTER_LINEAR with a
constant-0 border (LKof.cpp:213-226). Three forms:

- ``'gather'``: exact, unbounded; map coordinates quantized to OpenCV's
  5-bit fixed point (round half to even), taps outside the image read 0.
- ``'shift'``: the exact bounded form without gathers (``remap_bilinear_shift``):
  the same taps and weights as ``'gather'``, as a (2C+2)^2 sum of static
  shifts of one zero-padded operand with per-pixel hat weights, summed in
  another order (about 1 ulp from ``'gather'``). The JAX package made it to
  avoid gathers on the TPU; here it is the exact reference for the mesh's
  tiled warp and the controller's ``warp_impl='shift'``.
- ``'shift_sep'``: the separable shift decomposition with flow-space
  quantization (``quantize_disp``); both frames share one set of hat
  weights (img1 samples at +d, img2 at -d). This is the composition the
  warp+LK kernels fuse.
"""

from __future__ import annotations

from typing import Tuple

import torch

from optical_flow_tpu_torch.ops.pad import pad_last2

_INTER_BITS = 5
_INTER_TAB_SIZE = 1 << _INTER_BITS  # 32


def _gather2d(src, yy, xx):
    """src[..., yy, xx] with out-of-range reads -> 0; batch dims broadcast."""
    H, W = src.shape[-2], src.shape[-1]
    ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
    idx = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
    batch = torch.broadcast_shapes(src.shape[:-2], idx.shape[:-2])
    out_sp = idx.shape[-2:]
    flat = src.reshape(src.shape[:-2] + (H * W,)).expand(batch + (H * W,))
    idxf = idx.to(torch.long).expand(batch + out_sp).reshape(batch + (-1,))
    vals = torch.gather(flat, -1, idxf).reshape(batch + out_sp)
    return torch.where(ok, vals, torch.zeros((), dtype=src.dtype, device=src.device))


def remap_bilinear(src, map_x, map_y, *, quantize: bool = True, index_offset=(0, 0)):
    """cv2.remap(src, map_x, map_y, INTER_LINEAR, BORDER_CONSTANT 0).

    src: (..., H, W); map_x/map_y: (..., H2, W2) float32 sample
    coordinates. Integer sources are interpolated in float32 and rounded
    and saturated back, like cv2.

    index_offset (dy, dx) is added to the integer tap indices after the
    coordinates are quantized: the mesh-tiled gather warp
    (parallel/sharded_warp.py) builds its maps in global coordinates and
    reads a halo-extended tile, and shifting the indices rather than the
    float maps keeps every fraction bit-identical to the global remap.
    """
    out_dtype = src.dtype
    is_int = not torch.is_floating_point(src)
    if is_int:
        src = src.to(torch.float32)
    cdt = src.dtype
    if quantize:
        sx = torch.round(map_x.to(torch.float32) * _INTER_TAB_SIZE).to(torch.int32)
        sy = torch.round(map_y.to(torch.float32) * _INTER_TAB_SIZE).to(torch.int32)
        ix = sx >> _INTER_BITS
        iy = sy >> _INTER_BITS
        fx = (sx & (_INTER_TAB_SIZE - 1)).to(cdt) / _INTER_TAB_SIZE
        fy = (sy & (_INTER_TAB_SIZE - 1)).to(cdt) / _INTER_TAB_SIZE
    else:
        ix = torch.floor(map_x).to(torch.int32)
        iy = torch.floor(map_y).to(torch.int32)
        fx = (map_x - ix).to(cdt)
        fy = (map_y - iy).to(cdt)
    iy = iy + int(index_offset[0])
    ix = ix + int(index_offset[1])
    v00 = _gather2d(src, iy, ix)
    v01 = _gather2d(src, iy, ix + 1)
    v10 = _gather2d(src, iy + 1, ix)
    v11 = _gather2d(src, iy + 1, ix + 1)
    top = v00 + fx * (v01 - v00)
    bot = v10 + fx * (v11 - v10)
    out = top + fy * (bot - top)
    if is_int:
        info = torch.iinfo(out_dtype)
        out = torch.clamp(torch.round(out), info.min, info.max).to(out_dtype)
    return out


def quantize_disp(d, max_disp, *, quantize: bool = True):
    """Clamp a displacement to [-max_disp, max_disp] and optionally round
    it to the 1/32 grid in flow space (round half to even)."""
    C = float(max_disp)
    d = torch.clamp(d, -C, C)
    if quantize:
        d = torch.round(d * _INTER_TAB_SIZE) / _INTER_TAB_SIZE
    return d


def _shift_sep_core(planes, signs, dx_ext, dy, max_disp: int):
    """Separable shift-warp passes over zero-padded planes that share the
    hat weights: plane i samples at signs[i] * d.

    planes: sources padded by M = max_disp on both spatial axes.
    dx_ext: x-displacement on the extended rows (H + 2M, W), for sign +1.
    dy:     y-displacement per output pixel (H, W), for sign +1.
    """
    C = M = int(max_disp)
    H, W = dy.shape[-2], dy.shape[-1]
    batch = torch.broadcast_shapes(*(p.shape[:-2] for p in planes), dx_ext.shape[:-2])
    # the hat weights take the planes' dtype before `1 - |d - k|`, as in JAX
    dt = planes[0].dtype
    tmps = [p.new_zeros(batch + (H + 2 * M, W)) for p in planes]
    for k in range(-C, C + 1):
        w = torch.clamp_min(1.0 - torch.abs(dx_ext - k).to(dt), 0.0)
        tmps = [
            t + w * p[..., :, M + s * k : M + s * k + W]
            for t, p, s in zip(tmps, planes, signs)
        ]
    outs = [p.new_zeros(batch + (H, W)) for p in planes]
    for k in range(-C, C + 1):
        w = torch.clamp_min(1.0 - torch.abs(dy - k).to(dt), 0.0)
        outs = [
            o + w * t[..., M + s * k : M + s * k + H, :]
            for o, t, s in zip(outs, tmps, signs)
        ]
    return outs


def symmetric_shift_sep_sum(p1, p2, dx_ext, dy, max_disp: int):
    """Both separable shift warps with shared hat weights: ``p1`` sampled at
    +d, ``p2`` at -d. The one copy the global warp and the mesh-tiled warp
    (parallel/sharded_warp.py) share, so the two stay bit-identical.

    p1/p2: frames zero-padded (global) or halo-extended (tiled) by
    M = max_disp on both spatial axes; dx_ext: the quantized x-displacement
    on the extended rows (H + 2M, W), 0 where the source rows are outside
    the frame; dy: the y-displacement (H, W).
    """
    o1, o2 = _shift_sep_core((p1, p2), (1, -1), dx_ext, dy, max_disp)
    return o1, o2


def shift_disp_fields(map_x, map_y, xs, ys, max_disp: int, *, quantize: bool, dtype):
    """Per-pixel displacements (dx, dy) = map - identity, quantized to cv2's
    5-bit fixed point in coordinate space and clamped to [-max_disp,
    max_disp]: the weights input of the exact shift warp.

    xs/ys are the identity coordinates the maps are relative to. A tiled
    caller passes global coordinates and gets the unsharded arithmetic bit
    for bit (integer-valued float32 adds are exact below 2^24).
    """
    if quantize:
        sx = torch.round(map_x.to(torch.float32) * _INTER_TAB_SIZE).to(torch.int32)
        sy = torch.round(map_y.to(torch.float32) * _INTER_TAB_SIZE).to(torch.int32)
        dxq = sx.to(dtype) / _INTER_TAB_SIZE - xs.to(dtype)
        dyq = sy.to(dtype) / _INTER_TAB_SIZE - ys.to(dtype)
    else:
        dxq = (map_x - xs).to(dtype)
        dyq = (map_y - ys).to(dtype)
    C = int(max_disp)
    return torch.clamp(dxq, -C, C), torch.clamp(dyq, -C, C)


def shift_warp_sum(p, dxq, dyq, max_disp: int):
    """The exact shift warp's double sum, shared by the global warp
    (``remap_bilinear_shift``) and the mesh-tiled one
    (parallel/sharded_warp.py), so the two stay bit-identical:

        out(q) = sum_ky hat(dy(q) - ky) sum_kx hat(dx(q) - kx) p(q + (ky, kx))

    over ky, kx in [-C, C+1], hat(t) = max(0, 1 - |t|).

    p:   the source with margin M = max_disp + 1 on both spatial axes (zero
         padding globally; the halo plus one zero ring when tiled; the
         outermost ring always gets a zero weight since |d| <= max_disp).
    dxq, dyq: clamped displacements per output pixel, (..., H, W). The
    separable form is ``symmetric_shift_sep_sum``.
    """
    C = int(max_disp)
    M = C + 1
    H, W = dyq.shape[-2], dyq.shape[-1]
    dt = p.dtype
    batch = torch.broadcast_shapes(p.shape[:-2], dxq.shape[:-2])
    wx = {k: torch.clamp_min(1.0 - torch.abs(dxq - k).to(dt), 0.0) for k in range(-C, C + 2)}
    out = p.new_zeros(batch + (H, W))
    for ky in range(-C, C + 2):
        wy = torch.clamp_min(1.0 - torch.abs(dyq - ky).to(dt), 0.0)
        inner = p.new_zeros(batch + (H, W))
        for kx in range(-C, C + 2):
            inner = inner + wx[kx] * p[..., M + ky : M + ky + H, M + kx : M + kx + W]
        out = out + wy * inner
    return out


def remap_bilinear_shift(
    src, map_x, map_y, max_disp: int, *, quantize: bool = True, separable: bool = False
):
    """Gather-free remap for bounded displacements (|map - identity| <=
    max_disp; beyond it the displacement is clamped): the bilinear warp as a
    sum of static integer shifts of one zero-padded operand with per-pixel
    hat weights (``shift_warp_sum``). The four bilinear taps get the same
    weights as ``remap_bilinear``'s, summed in another order.

    src: (..., H, W); map_x/map_y: (H, W) absolute sample coordinates; the
    output has src's shape.

    ``separable=True`` is the two-pass O(C) form over ``_shift_sep_core``,
    with flow-space quantization (``quantize_disp``); it is exact only where
    dx is constant along y.
    """
    H, W = src.shape[-2], src.shape[-1]
    xs = torch.arange(W, dtype=torch.float32, device=src.device)[None, :]
    ys = torch.arange(H, dtype=torch.float32, device=src.device)[:, None]
    C = int(max_disp)
    if separable:
        dxq = quantize_disp((map_x - xs).to(src.dtype), C, quantize=quantize)
        dyq = quantize_disp((map_y - ys).to(src.dtype), C, quantize=quantize)
        p = pad_last2(src, C, C, C, C, mode="constant")
        dxq_ext = pad_last2(dxq, C, C, 0, 0, mode="constant")
        return _shift_sep_core((p,), (1,), dxq_ext, dyq, C)[0]
    dxq, dyq = shift_disp_fields(map_x, map_y, xs, ys, C, quantize=quantize, dtype=src.dtype)
    M = C + 1
    return shift_warp_sum(pad_last2(src, M, M, M, M, mode="constant"), dxq, dyq, C)


def symmetric_warp_shift_sep(
    img1, img2, hx, hy, max_disp: int, *, quantize: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both frames warped half-way toward each other by the separable shift
    decomposition. hx/hy: the half-flow (u/2, v/2), clamped to max_disp."""
    C = int(max_disp)
    dx = quantize_disp(hx.to(torch.float32), C, quantize=quantize)
    dy = quantize_disp(hy.to(torch.float32), C, quantize=quantize)
    p1 = pad_last2(img1, C, C, C, C, mode="constant")
    p2 = pad_last2(img2, C, C, C, C, mode="constant")
    dx_ext = pad_last2(dx, C, C, 0, 0, mode="constant")
    return symmetric_shift_sep_sum(p1, p2, dx_ext, dy, C)


def symmetric_warp(
    img1, img2, u, v, *, quantize: bool = True, impl: str = "gather", max_disp: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp both frames half-way toward each other along flow (u, v):
    img1 samples at (x + u/2, y + v/2), img2 at (x - u/2, y - v/2).

    impl: ``'gather'`` (exact), ``'shift'`` (exact for |u|, |v| <= 2 *
    max_disp; about 1 ulp from ``'gather'``) or ``'shift_sep'`` (the half-flow
    clamped to max_disp). The shift forms need max_disp > 0. Integer images
    are promoted to float32 by every form.
    """
    if impl in ("shift", "shift_sep") and max_disp <= 0:
        raise ValueError(
            f"impl={impl!r} needs max_disp > 0 (the shift decomposition's "
            f"displacement bound); got {max_disp}"
        )
    if not torch.is_floating_point(img1):
        img1 = img1.to(torch.float32)
        img2 = img2.to(torch.float32)
    hx = u.to(torch.float32) / 2.0
    hy = v.to(torch.float32) / 2.0
    if impl == "shift_sep":
        return symmetric_warp_shift_sep(img1, img2, hx, hy, max_disp, quantize=quantize)
    if impl not in ("gather", "shift"):
        raise ValueError(f"warp impl must be 'gather', 'shift' or 'shift_sep', got {impl!r}")
    H, W = img1.shape[-2], img1.shape[-1]
    xs = torch.arange(W, dtype=torch.float32, device=img1.device)[None, :]
    ys = torch.arange(H, dtype=torch.float32, device=img1.device)[:, None]
    if impl == "shift":
        w1 = remap_bilinear_shift(img1, xs + hx, ys + hy, max_disp, quantize=quantize)
        w2 = remap_bilinear_shift(img2, xs - hx, ys - hy, max_disp, quantize=quantize)
        return w1, w2
    w1 = remap_bilinear(img1, xs + hx, ys + hy, quantize=quantize)
    w2 = remap_bilinear(img2, xs - hx, ys - hy, quantize=quantize)
    return w1, w2
