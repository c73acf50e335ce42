"""The plain reference of one frame of the gesture tracker, in plain PyTorch
and NumPy, float32, TF32 off. It is a frozen copy of the port's plain
versions (``pipeline/preprocess.py``, ``ops/``, ``flow/``,
``pipeline/gesture.py`` and the kernels' plain compositions), kept here so
that a change to the program cannot move the yardstick. It imports nothing
of the program.

What each function computes (reference ``ParallelVideoPyr.cpp:780-890``,
``LKof.cpp:34-249``):

- preprocess, both heads: the float head (BT.601 gray, then the bicubic
  resize with the 9x9 Gaussian folded in, as two block-banded matmuls) and
  the faithful uint8 head (dense bicubic resize, 9-tap blur, fixed-point
  gray, each stage saturating to uint8);
- ``diff_features``: temporal diff, THRESH_TOZERO, Sobel x + y,
  dilate^n, erode^n;
- the Gaussian pyramid (5-tap pyrDown, rows then columns), ``pyr_up`` and
  its columns-first form;
- dense LK (2x2 gradients, five products, 3x3 interior sums, Cramer solve
  with x / 0 -> 0);
- the warps: the quantized ``gather`` remap and the separable shift warp
  with flow-space quantization; the unfused warp+LK step (what K4
  computes) and the pyrUp+warp+LK step (what K3 computes);
- the coarse-to-fine loop in reference and corrected mode;
- the gesture: votes, centroid and the L2-normalised magnitude.

``matmul_precision`` selects how the two preprocess heads' matmuls run:
``'ieee'`` (the configuration's float32, TF32 off) or ``'tf32'`` (the
control: the next precision below; TF32 on a card, operands rounded to
TF32's 10-bit mantissa on the CPU, which has no TF32 matmul).
"""

from __future__ import annotations

from contextlib import contextmanager
from functools import lru_cache
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

# ----------------------------------------------------------------- matmuls


@contextmanager
def matmul_precision(mode: str):
    """float32 matmuls at ``mode`` ('ieee' or 'tf32') on the card, restored
    on exit; on the CPU the TF32 rounding is applied by ``mm``."""
    if mode not in ("ieee", "tf32"):
        raise ValueError(f"matmul precision must be 'ieee' or 'tf32', got {mode!r}")
    backends = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    prev = [b.fp32_precision for b in backends]
    torch.backends.cuda.matmul.fp32_precision = mode
    torch.backends.mkldnn.matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        for b, p in zip(backends, prev):
            b.fp32_precision = p


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa, to nearest even."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    r = (i + 0xFFF + lsb) & ~0x1FFF
    return torch.where(torch.isfinite(x), r.view(torch.float32), x)


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in float32 at ``precision`` (see ``matmul_precision``)."""
    if precision == "tf32" and not a.is_cuda:
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


# ----------------------------------------------------------------- padding


def reflect101(i: int, n: int) -> int:
    if n == 1:
        return 0
    period = 2 * (n - 1)
    i %= period
    return i if i < n else period - i


def _reflect_axis(x, dim, before, after):
    if before == 0 and after == 0:
        return x
    n = x.shape[dim]
    parts = [x.narrow(dim, reflect101(i, n), 1) for i in range(-before, 0)]
    parts.append(x)
    parts += [x.narrow(dim, reflect101(n + i, n), 1) for i in range(after)]
    return torch.cat(parts, dim=dim)


def pad_last2(x, top, bottom, left, right, mode="reflect", value=0.0):
    """Pad the trailing two axes: REFLECT_101 or a constant."""
    if mode == "reflect":
        return _reflect_axis(_reflect_axis(x, -2, top, bottom), -1, left, right)
    H, W = x.shape[-2], x.shape[-1]
    out = x.new_full(x.shape[:-2] + (top + H + bottom, left + W + right), value)
    out[..., top : top + H, left : left + W] = x
    return out


# --------------------------------------------------------------- preprocess

_CUBIC_A = -0.75
_TILE = 128
_SMALL_GAUSSIAN_TAB = {
    1: (1.0,),
    3: (0.25, 0.5, 0.25),
    5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
    7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125),
}


def _cubic_weights(t):
    A = _CUBIC_A
    w0 = ((A * (t + 1) - 5 * A) * (t + 1) + 8 * A) * (t + 1) - 4 * A
    w1 = ((A + 2) * t - (A + 3)) * t * t + 1
    s = 1 - t
    w2 = ((A + 2) * s - (A + 3)) * s * s + 1
    w3 = 1.0 - w0 - w1 - w2
    return np.stack([w0, w1, w2, w3], axis=-1)


@lru_cache(maxsize=16)
def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) dense bicubic resampling matrix (OpenCV's mapping)."""
    scale = n_in / n_out
    fx = (np.arange(n_out) + 0.5) * scale - 0.5
    ix = np.floor(fx).astype(np.int64)
    w = _cubic_weights(fx - ix)
    M = np.zeros((n_out, n_in), dtype=np.float32)
    for tap in range(4):
        src = np.clip(ix - 1 + tap, 0, n_in - 1)
        np.add.at(M, (np.arange(n_out), src), w[:, tap].astype(np.float32))
    return M


@lru_cache(maxsize=16)
def gauss_taps(ksize: int, sigma: float) -> Tuple[float, ...]:
    """cv2.getGaussianKernel taps."""
    if sigma <= 0:
        if ksize % 2 == 1 and ksize in _SMALL_GAUSSIAN_TAB:
            return _SMALL_GAUSSIAN_TAB[ksize]
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    i = np.arange(ksize) - (ksize - 1) * 0.5
    k = np.exp(-(i * i) / (2.0 * sigma * sigma))
    return tuple((k / k.sum()).tolist())


@lru_cache(maxsize=16)
def _resize_blur_matrix(n_in, n_out, ksize, sigma):
    M = resize_matrix(n_in, n_out).astype(np.float64)
    taps = np.asarray(gauss_taps(ksize, sigma), np.float64)
    r = ksize // 2
    B = np.zeros((n_out, n_out), np.float64)
    idx = np.arange(n_out)
    for j, w in enumerate(taps):
        src = np.abs(idx + j - r)
        src = np.where(src >= n_out, 2 * (n_out - 1) - src, src)
        np.add.at(B, (idx, src), w)
    return (B @ M).astype(np.float32)


@lru_cache(maxsize=16)
def banded_factors(n_in, n_out, ksize, sigma, tile=_TILE):
    """The (n_out, n_in) resize+blur operator split into bands of ``tile``
    output rows, each reading only the input slab it touches."""
    M = _resize_blur_matrix(n_in, n_out, ksize, sigma)
    nt = -(-n_out // tile)
    starts, width = [], 0
    for t in range(nt):
        rows = M[t * tile : (t + 1) * tile]
        nz = np.nonzero(np.abs(rows).sum(0) > 0)[0]
        starts.append(int(nz.min()))
        width = max(width, int(nz.max() - nz.min() + 1))
    width = min(-(-width // 64) * 64, n_in)
    starts = [min(s, n_in - width) for s in starts]
    W = np.zeros((nt, tile, width), np.float32)
    for t in range(nt):
        rows = M[t * tile : (t + 1) * tile]
        W[t, : rows.shape[0]] = rows[:, starts[t] : starts[t] + width]
    return W, tuple(starts)


class ResizeBlur:
    """Bicubic resize + Gaussian blur of ``(..., H, W)`` float planes."""

    def __init__(self, in_hw, size, ksize, sigma, device, precision="ieee"):
        self.size = tuple(size)
        self.precision = precision
        Wr, self.row_starts = banded_factors(int(in_hw[0]), self.size[0], ksize, sigma)
        Wc, self.col_starts = banded_factors(int(in_hw[1]), self.size[1], ksize, sigma)
        self.row_factors = torch.from_numpy(Wr).to(device)
        self.col_factors = torch.from_numpy(Wc).to(device)

    def __call__(self, x):
        p = self.precision
        x = x.to(torch.float32)
        with matmul_precision(p):
            h_out, w_out = self.size
            n = self.row_factors.shape[2]
            rows = torch.cat(
                [mm(self.row_factors[t], x[..., s : s + n, :], p)
                 for t, s in enumerate(self.row_starts)], dim=-2,
            )[..., :h_out, :]
            n = self.col_factors.shape[2]
            return torch.cat(
                [mm(rows[..., s : s + n], self.col_factors[t].T, p)
                 for t, s in enumerate(self.col_starts)], dim=-1,
            )[..., :w_out]


def saturate_u8(x):
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def resize_cubic(img, size, precision="ieee"):
    """cv2.resize(INTER_CUBIC) of an (H, W, C) uint8 frame or (..., H, W)
    planes: two dense float32 matmuls, the columns first."""
    chan_last = img.ndim >= 3 and img.shape[-1] in (1, 3, 4)
    x = torch.movedim(img, -1, 0) if chan_last else img
    Mr = torch.from_numpy(resize_matrix(x.shape[-2], size[0])).to(x.device)
    Mc = torch.from_numpy(resize_matrix(x.shape[-1], size[1])).to(x.device)
    with matmul_precision(precision):
        y = mm(Mr, mm(x.to(torch.float32), Mc.T, precision), precision)
    if img.dtype == torch.uint8:
        y = saturate_u8(y)
    return torch.movedim(y, 0, -1) if chan_last else y


def gaussian_blur(img, ksize=9, sigma=1.5):
    """cv2.GaussianBlur, REFLECT_101, taps summed in order."""
    chan_last = img.ndim >= 3 and img.shape[-1] in (1, 3, 4)
    x = torch.movedim(img, -1, 0) if chan_last else img
    xf = x.to(torch.float32)
    taps = gauss_taps(ksize, sigma)
    r = ksize // 2
    H, W = xf.shape[-2], xf.shape[-1]
    p = pad_last2(xf, r, r, 0, 0)
    xf = sum(t * p[..., i : i + H, :] for i, t in enumerate(taps))
    p = pad_last2(xf, 0, 0, r, r)
    xf = sum(t * p[..., :, j : j + W] for j, t in enumerate(taps))
    y = saturate_u8(xf) if img.dtype == torch.uint8 else xf
    return torch.movedim(y, 0, -1) if chan_last else y


def bgr_to_gray(img):
    """cvtColor(BGR2GRAY): OpenCV's 15-bit fixed point on uint8, BT.601
    weights on floats."""
    if img.dtype == torch.uint8:
        b, g, r = (img[..., k].to(torch.int32) for k in range(3))
        return ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15).to(torch.uint8)
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    return 0.299 * r + 0.587 * g + 0.114 * b


def temporal_diff(cur, prev, learning_rate, faithful_uint8):
    d = cur.to(torch.float32) - float(np.float32(learning_rate)) * prev.to(torch.float32)
    if faithful_uint8 and cur.dtype == torch.uint8:
        return saturate_u8(d)
    return d


def sobel3(img, dx, dy):
    x = img.to(torch.float32)
    H, W = x.shape[-2], x.shape[-1]

    def rows(v, taps):
        p = pad_last2(v, 1, 1, 0, 0)
        return sum(t * p[..., i : i + H, :] for i, t in enumerate(taps) if t)

    def cols(v, taps):
        p = pad_last2(v, 0, 0, 1, 1)
        return sum(t * p[..., :, j : j + W] for j, t in enumerate(taps) if t)

    smooth, diff = (1.0, 2.0, 1.0), (-1.0, 0.0, 1.0)
    if (dx, dy) == (1, 0):
        return cols(rows(x, smooth), diff)
    return rows(cols(x, smooth), diff)


def morph3x3(x, mode, iterations):
    """n iterated 3x3 dilations (max) or erosions (min), border ignored."""
    if iterations <= 0:
        return x
    init = -float("inf") if mode == "max" else float("inf")
    op = torch.maximum if mode == "max" else torch.minimum
    k, r = 2 * iterations + 1, iterations
    H, W = x.shape[-2], x.shape[-1]
    p = pad_last2(x, r, r, 0, 0, mode="constant", value=init)
    y = p[..., 0:H, :]
    for i in range(1, k):
        y = op(y, p[..., i : i + H, :])
    p = pad_last2(y, 0, 0, r, r, mode="constant", value=init)
    y = p[..., :, 0:W]
    for i in range(1, k):
        y = op(y, p[..., :, i : i + W])
    return y


def diff_features(cur_gray, prev_gray, pre: Dict):
    d = temporal_diff(cur_gray, prev_gray, pre["learning_rate"], pre["faithful_uint8"])
    d = torch.where(d > pre["diff_thresh"], d, torch.zeros((), dtype=d.dtype, device=d.device))
    d = sobel3(d, 1, 0) + sobel3(d, 0, 1)
    d = morph3x3(d, "max", pre["morph_iterations"])
    return morph3x3(d, "min", pre["morph_iterations"])


# ------------------------------------------------------------------ pyramid

_K5 = (0.0625, 0.25, 0.375, 0.25, 0.0625)
_K5UP = tuple(2.0 * v for v in _K5)


def _poly_pass(p, dim, n_out):
    out = None
    idx = [slice(None)] * p.ndim
    for t, k in enumerate(_K5):
        idx[dim] = slice(t, t + 2 * n_out - 1, 2)
        term = k * p[tuple(idx)]
        out = term if out is None else out + term
    return out


def pyr_down(x):
    """cv::pyrDown: 5 taps, REFLECT_101, rows then columns."""
    x = x.to(torch.float32)
    H, W = x.shape[-2], x.shape[-1]
    r = _poly_pass(pad_last2(x, 2, 2, 0, 0), -2, -(-H // 2))
    return _poly_pass(pad_last2(r, 0, 0, 2, 2), -1, -(-W // 2))


def gaussian_pyramid(img, levels) -> List[torch.Tensor]:
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def max_pyramid_levels(h: int, w: int) -> int:
    def v2_plus1(n):
        p = 1
        while n % (1 << p) == 0:
            p += 1
        return p

    return min(v2_plus1(int(w)), v2_plus1(int(h)))


def _pad_pyrup(x):
    H, W = x.shape[-2], x.shape[-1]
    top = x[..., 1:2, :] if H > 1 else x[..., 0:1, :]
    x = torch.cat([top, x, x[..., H - 1 : H, :]], dim=-2)
    left = x[..., :, 1:2] if W > 1 else x[..., :, 0:1]
    return torch.cat([left, x, x[..., :, W - 1 : W]], dim=-1)


def _up_rows(p):
    k = _K5UP
    ev = k[0] * p[..., :-2, :] + k[2] * p[..., 1:-1, :] + k[4] * p[..., 2:, :]
    od = k[1] * p[..., 1:-1, :] + k[3] * p[..., 2:, :]
    s = torch.stack([ev, od], dim=-2)
    return s.reshape(s.shape[:-3] + (2 * s.shape[-3], s.shape[-1]))


def _up_cols(p):
    k = _K5UP
    ev = k[0] * p[..., :, :-2] + k[2] * p[..., :, 1:-1] + k[4] * p[..., :, 2:]
    od = k[1] * p[..., :, 1:-1] + k[3] * p[..., :, 2:]
    s = torch.stack([ev, od], dim=-1)
    return s.reshape(s.shape[:-2] + (2 * s.shape[-2],))


def pyr_up(x):
    """cv::pyrUp to exactly (2H, 2W), rows first."""
    return _up_cols(_up_rows(_pad_pyrup(x)))


def pyr_up_cols_first(x):
    """``pyr_up`` with the column pass first (corrected mode)."""
    return _up_rows(_up_cols(_pad_pyrup(x)))


# ----------------------------------------------------------------------- LK


def _shifted4(img):
    p = pad_last2(img, 1, 0, 1, 0)
    return p[..., :-1, :-1], p[..., :-1, 1:], p[..., 1:, :-1], p[..., 1:, 1:]


def lucas_kanade(img1, img2):
    """Dense single-level LK; the 1-px border ring is 0."""
    a1, b1, c1, d1 = _shifted4(img1)
    a2, b2, c2, d2 = _shifted4(img2)
    fx = (b1 - a1 + d1 - c1) + (b2 - a2 + d2 - c2)
    fy = (c1 + d1 - a1 - b1) + (c2 + d2 - a2 - b2)
    ft = (a2 + b2 + c2 + d2) - (a1 + b1 + c1 + d1)
    prods = torch.stack([fx * fx, fy * fy, fx * fy, fx * ft, fy * ft], dim=0)
    sums = torch.zeros_like(prods)
    if prods.shape[-2] >= 3 and prods.shape[-1] >= 3:
        r = prods[..., :-2, :] + prods[..., 1:-1, :] + prods[..., 2:, :]
        sums[..., 1:-1, 1:-1] = r[..., :, :-2] + r[..., :, 1:-1] + r[..., :, 2:]
    sfx2, sfy2, sfxfy, sfxft, sfyft = sums
    det = sfx2 * sfy2 - sfxfy * sfxfy

    def safe_divide(num, den):
        ok = den != 0
        return torch.where(ok, num, torch.zeros_like(num)) / torch.where(
            ok, den, torch.ones_like(den))

    return (safe_divide(sfxfy * sfyft - sfy2 * sfxft, det),
            safe_divide(sfxft * sfxfy - sfx2 * sfyft, det))


# -------------------------------------------------------------------- warps

_INTER_BITS = 5
_INTER_TAB_SIZE = 1 << _INTER_BITS


def _gather2d(src, yy, xx):
    H, W = src.shape[-2], src.shape[-1]
    ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
    idx = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
    batch = torch.broadcast_shapes(src.shape[:-2], idx.shape[:-2])
    out_sp = idx.shape[-2:]
    flat = src.reshape(src.shape[:-2] + (H * W,)).expand(batch + (H * W,))
    idxf = idx.to(torch.long).expand(batch + out_sp).reshape(batch + (-1,))
    vals = torch.gather(flat, -1, idxf).reshape(batch + out_sp)
    return torch.where(ok, vals, torch.zeros((), dtype=src.dtype, device=src.device))


def remap_bilinear(src, map_x, map_y):
    """cv2.remap(INTER_LINEAR, BORDER_CONSTANT 0), coordinates quantized to
    OpenCV's 5-bit fixed point."""
    sx = torch.round(map_x.to(torch.float32) * _INTER_TAB_SIZE).to(torch.int32)
    sy = torch.round(map_y.to(torch.float32) * _INTER_TAB_SIZE).to(torch.int32)
    ix, iy = sx >> _INTER_BITS, sy >> _INTER_BITS
    fx = (sx & (_INTER_TAB_SIZE - 1)).to(src.dtype) / _INTER_TAB_SIZE
    fy = (sy & (_INTER_TAB_SIZE - 1)).to(src.dtype) / _INTER_TAB_SIZE
    v00 = _gather2d(src, iy, ix)
    v01 = _gather2d(src, iy, ix + 1)
    v10 = _gather2d(src, iy + 1, ix)
    v11 = _gather2d(src, iy + 1, ix + 1)
    top = v00 + fx * (v01 - v00)
    bot = v10 + fx * (v11 - v10)
    return top + fy * (bot - top)


def _quantize_disp(d, C):
    d = torch.clamp(d, -float(C), float(C))
    return torch.round(d * _INTER_TAB_SIZE) / _INTER_TAB_SIZE


def symmetric_warp(img1, img2, u, v, impl, max_disp=0):
    """Both frames warped half-way toward each other along (u, v):
    'gather' (exact) or 'shift_sep' (half-flow clamped to max_disp)."""
    img1 = img1.to(torch.float32)
    img2 = img2.to(torch.float32)
    hx = u.to(torch.float32) / 2.0
    hy = v.to(torch.float32) / 2.0
    if impl == "shift_sep":
        C = M = int(max_disp)
        dx = _quantize_disp(hx, C)
        dy = _quantize_disp(hy, C)
        planes = (pad_last2(img1, C, C, C, C, mode="constant"),
                  pad_last2(img2, C, C, C, C, mode="constant"))
        dx_ext = pad_last2(dx, C, C, 0, 0, mode="constant")
        H, W = dy.shape[-2], dy.shape[-1]
        batch = torch.broadcast_shapes(*(p.shape[:-2] for p in planes), dx_ext.shape[:-2])
        dt = planes[0].dtype
        tmps = [p.new_zeros(batch + (H + 2 * M, W)) for p in planes]
        for k in range(-C, C + 1):
            w = torch.clamp_min(1.0 - torch.abs(dx_ext - k).to(dt), 0.0)
            tmps = [t + w * p[..., :, M + s * k : M + s * k + W]
                    for t, p, s in zip(tmps, planes, (1, -1))]
        outs = [p.new_zeros(batch + (H, W)) for p in planes]
        for k in range(-C, C + 1):
            w = torch.clamp_min(1.0 - torch.abs(dy - k).to(dt), 0.0)
            outs = [o + w * t[..., M + s * k : M + s * k + H, :]
                    for o, t, s in zip(outs, tmps, (1, -1))]
        return outs[0], outs[1]
    if impl != "gather":
        raise ValueError(f"the reference warps by 'gather' or 'shift_sep', got {impl!r}")
    H, W = img1.shape[-2], img1.shape[-1]
    xs = torch.arange(W, dtype=torch.float32, device=img1.device)[None, :]
    ys = torch.arange(H, dtype=torch.float32, device=img1.device)[:, None]
    return remap_bilinear(img1, xs + hx, ys + hy), remap_bilinear(img2, xs - hx, ys - hy)


def warp_lk(img1, img2, u, v, max_disp, clamp, negate=True):
    """Clip -> (negate) -> shift_sep warp -> LK: the step K4 computes."""
    wu = torch.clamp(u, -clamp, clamp)
    wv = torch.clamp(v, -clamp, clamp)
    if negate:
        wu, wv = -wu, -wv
    w1, w2 = symmetric_warp(img1, img2, wu, wv, "shift_sep", max_disp)
    return lucas_kanade(w1, w2)


def pyrup_warp_lk(img1, img2, u_coarse, v_coarse, max_disp, clamp):
    """The corrected inter-level step K3 computes: up = 2 pyrUp(coarse),
    then ``warp_lk`` with negate, accumulated."""
    upu = 2.0 * pyr_up_cols_first(u_coarse)
    upv = 2.0 * pyr_up_cols_first(v_coarse)
    du, dv = warp_lk(img1, img2, upu, upv, max_disp, clamp, negate=True)
    return du + upu, dv + upv


# --------------------------------------------------------------- controller


def warp_reach(flow: Dict) -> Tuple[str, int]:
    """(warp, max_disp) of a flow configuration: the kernel route's
    clamped 'shift_sep' where ``warp_clamp`` is set, else 'gather'."""
    impl = flow["warp_impl"]
    if impl == "auto":
        impl = "shift_sep" if flow["warp_clamp"] is not None else "gather"
    if impl == "shift_sep":
        return impl, int(-(-flow["warp_clamp"] // 2))
    if impl != "gather":
        raise ValueError(f"the reference runs warp_impl 'gather' or 'shift_sep', got {impl!r}")
    return "gather", 0


def coarse_to_fine(pyr1, pyr2, flow: Dict, need_images: bool):
    """Pyramidal LK over prebuilt pyramids (level 0 finest), returning (u,
    v, finest img1, finest img2). Corrected mode with 'shift_sep' takes
    the fused steps (``pyrup_warp_lk``) at every level below the coarsest,
    except level 0 when its warped frames are needed; reference mode
    upsamples by ``pyr_up`` without doubling and warps by 'gather'."""
    if flow["level_iters"] != 1 or not flow["quantize_warp"]:
        raise ValueError("the reference runs level_iters=1 with quantized warps")
    corrected = flow["mode"] == "corrected"
    warp_impl, C = warp_reach(flow)
    clamp = flow["warp_clamp"]
    fused = corrected and warp_impl == "shift_sep"
    pyr1, pyr2 = list(pyr1), list(pyr2)
    levels = len(pyr1)
    for i in range(levels - 1, -1, -1):
        a, b = pyr1[i], pyr2[i]
        if i == levels - 1:
            u, v = lucas_kanade(a, b)
            continue
        if fused and not (i == 0 and need_images):
            u, v = pyrup_warp_lk(a, b, u, v, C, float(clamp))
            continue
        if corrected:
            upu, upv = 2.0 * pyr_up_cols_first(u), 2.0 * pyr_up_cols_first(v)
        else:
            upu, upv = pyr_up(u), pyr_up(v)
        wu, wv = upu, upv
        if clamp is not None:
            wu, wv = torch.clamp(wu, -clamp, clamp), torch.clamp(wv, -clamp, clamp)
        if corrected:
            wu, wv = -wu, -wv
        pyr1[i], pyr2[i] = symmetric_warp(a, b, wu, wv, warp_impl, C)
        du, dv = lucas_kanade(pyr1[i], pyr2[i])
        u, v = du + upu, dv + upv
    return u, v, pyr1[0], pyr2[0]


# ------------------------------------------------------------------ gesture


class Gesture(NamedTuple):
    detected: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    votes: torch.Tensor
    magnitude: torch.Tensor


def detect_gesture(u, v, g: Dict) -> Gesture:
    """Pixels with |flow| >= mag_thresh vote into a centroid; detection
    when votes > min_votes; the thresholded magnitude L2-normalised."""
    H, W = u.shape[-2], u.shape[-1]
    mag = torch.sqrt(u * u + v * v)
    zero = torch.zeros((), dtype=mag.dtype, device=mag.device)
    thresholded = torch.where(mag >= g["mag_thresh"], mag, zero)
    votes_mask = mag >= g["mag_thresh"]
    cols = torch.arange(W, dtype=u.dtype, device=u.device)[None, :]
    rows = torch.arange(H, dtype=u.dtype, device=u.device)[:, None]
    votes = votes_mask.sum(dim=(-2, -1))
    denom = votes.clamp_min(1).to(u.dtype)
    cx = torch.where(votes_mask, cols, 0.0).sum(dim=(-2, -1)) / denom
    cy = torch.where(votes_mask, rows, 0.0).sum(dim=(-2, -1)) / denom
    l2 = torch.sqrt((thresholded * thresholded).sum(dim=(-2, -1), keepdim=True))
    normalized = torch.where(
        l2 > 0, thresholded * (g["norm_alpha"] / l2.clamp_min(1e-30)), thresholded)
    return Gesture(votes > g["min_votes"], cx, cy, votes.to(torch.int32), normalized)
