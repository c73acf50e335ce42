"""Frame preprocessing (reference C11, ParallelVideoPyr.cpp:780-820; port of
optical_flow_tpu/pipeline/preprocess.py).

Float path (``faithful_uint8=False``). Head: BGR -> gray first (resize, blur
and BT.601 gray are all linear, so they commute), then the bicubic resize
with the 9x9 Gaussian folded into it, as two block-banded float32 matmuls
(``ResizeBlur``).

Faithful path (``faithful_uint8=True``, the reference's uint8 saturating
chain). Head in the reference's order: dense bicubic ``resize_cubic`` of
the BGR frame, ``gaussian_blur`` (9 taps, REFLECT_101), fixed-point
``bgr_to_gray``, each stage saturating back to uint8 with round half to
even. The dense resize matrices are kept as the JAX package keeps them: a
banded form would sum in another order and move the uint8 bits.

Tail (``diff_features``, both paths): temporal diff (saturating on uint8),
THRESH_TOZERO, Sobel x + y, dilate^n, erode^n. Every matmul here is plain
``torch.matmul`` in float32, run at float32 matmul precision ``'highest'``
(no TF32) whatever the caller's global setting, to match the JAX
package's ``Precision.HIGHEST``. The matmuls of XLA and PyTorch sum in
different orders, so a resize value at a rounding tie can land one apart:
the faithful chain agrees with the JAX package within 1 per uint8 stage.
"""

from __future__ import annotations

from contextlib import contextmanager
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
from torch import nn

from optical_flow_tpu_torch.config import PreprocessConfig
from optical_flow_tpu_torch.ops.pad import pad_last2

_CUBIC_A = -0.75  # OpenCV's bicubic parameter
_TILE = 128  # output rows per band of the banded resize+blur factors

_SMALL_GAUSSIAN_TAB = {
    1: (1.0,),
    3: (0.25, 0.5, 0.25),
    5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
    7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125),
}


def _cubic_weights(t: np.ndarray) -> np.ndarray:
    """OpenCV interpolateCubic tap weights for fraction t in [0,1)."""
    A = _CUBIC_A
    w0 = ((A * (t + 1) - 5 * A) * (t + 1) + 8 * A) * (t + 1) - 4 * A
    w1 = ((A + 2) * t - (A + 3)) * t * t + 1
    s = 1 - t
    w2 = ((A + 2) * s - (A + 3)) * s * s + 1
    w3 = 1.0 - w0 - w1 - w2
    return np.stack([w0, w1, w2, w3], axis=-1)


@lru_cache(maxsize=64)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) dense bicubic resampling matrix (OpenCV coordinate
    mapping, source-index clamping)."""
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
def _gauss_taps(ksize: int, sigma: float) -> Tuple[float, ...]:
    """cv2.getGaussianKernel taps (float64, normalized)."""
    if sigma <= 0:
        if ksize % 2 == 1 and ksize in _SMALL_GAUSSIAN_TAB:
            return _SMALL_GAUSSIAN_TAB[ksize]
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    i = np.arange(ksize) - (ksize - 1) * 0.5
    k = np.exp(-(i * i) / (2.0 * sigma * sigma))
    return tuple((k / k.sum()).tolist())


@lru_cache(maxsize=64)
def _resize_blur_matrix(n_in: int, n_out: int, ksize: int, sigma: float) -> np.ndarray:
    """(n_out, n_in) one-axis operator for blur(resize(x)): the 1-D Gaussian
    (REFLECT_101) composed onto the bicubic resampling matrix."""
    M = _resize_matrix(n_in, n_out).astype(np.float64)
    taps = np.asarray(_gauss_taps(ksize, sigma), np.float64)
    r = ksize // 2
    B = np.zeros((n_out, n_out), np.float64)
    idx = np.arange(n_out)
    for j, w in enumerate(taps):
        src = np.abs(idx + j - r)
        src = np.where(src >= n_out, 2 * (n_out - 1) - src, src)
        np.add.at(B, (idx, src), w)
    return (B @ M).astype(np.float32)


@lru_cache(maxsize=64)
def _banded_factors(n_in: int, n_out: int, ksize: int, sigma: float, tile: int):
    """Block-banded split of the (n_out, n_in) resize+blur operator: the
    operator is ~13-banded, so each band of ``tile`` output rows reads only
    the input slab it touches. Returns ((nt, tile, width) weights, starts)."""
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


@contextmanager
def _ieee_f32_matmul():
    """float32 matmuls in full IEEE precision (no TF32 on cuBLAS, no bf16
    on oneDNN) whatever the caller's global setting, restored on exit."""
    backends = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    prev = [b.fp32_precision for b in backends]
    for b in backends:
        b.fp32_precision = "ieee"
    try:
        yield
    finally:
        for b, p in zip(backends, prev):
            b.fp32_precision = p


class ResizeBlur(nn.Module):
    """Fused bicubic resize + Gaussian blur of ``(..., H, W)`` float planes
    of one input size, the banded factors held as buffers."""

    def __init__(self, in_hw: Tuple[int, int], config: PreprocessConfig):
        super().__init__()
        self.size = tuple(config.size)
        Wr, self.row_starts = _banded_factors(
            int(in_hw[0]), self.size[0], config.blur_ksize, config.blur_sigma, _TILE
        )
        Wc, self.col_starts = _banded_factors(
            int(in_hw[1]), self.size[1], config.blur_ksize, config.blur_sigma, _TILE
        )
        self.register_buffer("row_factors", torch.from_numpy(Wr))
        self.register_buffer("col_factors", torch.from_numpy(Wc))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with _ieee_f32_matmul():
            return self._banded(x.to(torch.float32))

    def _banded(self, x: torch.Tensor) -> torch.Tensor:
        h_out, w_out = self.size
        n = self.row_factors.shape[2]
        rows = torch.cat(
            [self.row_factors[t] @ x[..., s : s + n, :] for t, s in enumerate(self.row_starts)],
            dim=-2,
        )[..., :h_out, :]
        n = self.col_factors.shape[2]
        return torch.cat(
            [rows[..., s : s + n] @ self.col_factors[t].T for t, s in enumerate(self.col_starts)],
            dim=-1,
        )[..., :w_out]


def _saturate_u8(x: torch.Tensor) -> torch.Tensor:
    """OpenCV saturate_cast<uchar> with cvRound: round half to even
    (``torch.round``, like ``jnp.rint``), clamped to [0, 255] before the
    cast, as JAX clips before ``astype``."""
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def _chan_last(img: torch.Tensor) -> bool:
    """An (H, W, C) color frame, as OpenCV reads one (C in 1, 3, 4); any
    other last axis is a width."""
    return img.ndim >= 3 and img.shape[-1] in (1, 3, 4)


@lru_cache(maxsize=16)
def _resize_matrix_on(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_resize_matrix(n_in, n_out)).to(device)


def resize_cubic(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """cv2.resize(img, (W, H), INTER_CUBIC) of ``(..., H, W)`` planes or
    channel-last ``(H, W, C)`` frames; ``size`` is (height, width). Two
    dense float32 matmuls, the columns first. A uint8 input saturates back
    to uint8; another integer input gives float32 samples (a cast would
    wrap the bicubic overshoot)."""
    chan_last = _chan_last(img)
    x = torch.movedim(img, -1, 0) if chan_last else img
    Mr = _resize_matrix_on(x.shape[-2], size[0], x.device)
    Mc = _resize_matrix_on(x.shape[-1], size[1], x.device)
    with _ieee_f32_matmul():
        y = Mr @ (x.to(torch.float32) @ Mc.T)
    if img.dtype == torch.uint8:
        y = _saturate_u8(y)
    elif torch.is_floating_point(img):
        y = y.to(img.dtype)
    return torch.movedim(y, 0, -1) if chan_last else y


def gaussian_blur(img: torch.Tensor, ksize: int = 9, sigma: float = 1.5) -> torch.Tensor:
    """cv2.GaussianBlur(ksize x ksize, sigma), BORDER_REFLECT_101, of
    ``(..., H, W)`` planes or channel-last ``(H, W, C)`` frames. Each pass
    sums its taps in the JAX package's order (0 + t0*p0 + t1*p1 + ...). A
    uint8 input saturates back to uint8; another integer input gives
    float32 samples."""
    chan_last = _chan_last(img)
    x = torch.movedim(img, -1, 0) if chan_last else img
    xf = x.to(torch.float32)
    taps = _gauss_taps(ksize, sigma)
    r = ksize // 2
    H, W = xf.shape[-2], xf.shape[-1]
    p = pad_last2(xf, r, r, 0, 0, mode="reflect")
    xf = sum(t * p[..., i : i + H, :] for i, t in enumerate(taps))
    p = pad_last2(xf, 0, 0, r, r, mode="reflect")
    xf = sum(t * p[..., :, j : j + W] for j, t in enumerate(taps))
    if img.dtype == torch.uint8:
        y = _saturate_u8(xf)
    elif torch.is_floating_point(img):
        y = xf.to(img.dtype)
    else:
        y = xf  # float samples: never wrap-cast the overshoot back to ints
    return torch.movedim(y, 0, -1) if chan_last else y


def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    """cvtColor(BGR2GRAY) on (..., 3). uint8: OpenCV's fixed point, 15-bit
    BT.601 coefficients (R 9798, G 19235, B 3735, + 2^14 >> 15) in int32;
    float: plain BT.601 weights."""
    if img.dtype == torch.uint8:
        b, g, r = (img[..., k].to(torch.int32) for k in range(3))
        return ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15).to(torch.uint8)
    if not torch.is_floating_point(img):
        raise TypeError(f"bgr_to_gray takes uint8 or float frames, got {img.dtype}")
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    return 0.299 * r + 0.587 * g + 0.114 * b


def gray_f32(frame: torch.Tensor) -> torch.Tensor:
    """The float path's first step: a BGR(A), single-channel or gray frame
    (batched or not) -> float32 gray plane(s)."""
    x = frame
    if not torch.is_floating_point(x):
        x = x.to(torch.float32)
    if x.ndim >= 3 and x.shape[-1] in (3, 4):
        return bgr_to_gray(x[..., :3])
    if x.ndim >= 3 and x.shape[-1] == 1:
        return x[..., 0]
    return x


def preprocess_frame(frame_bgr: torch.Tensor, config: PreprocessConfig = PreprocessConfig()):
    """resize -> blur -> gray (ParallelVideoPyr.cpp:782-793). Faithful:
    the reference's order on the BGR frame, uint8 between stages (a uint8
    frame gives a uint8 gray). Float: gray first, then the fused banded
    resize+blur, float32."""
    if config.faithful_uint8:
        x = resize_cubic(frame_bgr, config.size)
        x = gaussian_blur(x, config.blur_ksize, config.blur_sigma)
        return bgr_to_gray(x) if _chan_last(x) else x
    x = gray_f32(frame_bgr)
    return ResizeBlur(x.shape[-2:], config).to(x.device)(x)


def temporal_diff(cur, prev, learning_rate: float = 0.3, *, faithful_uint8: bool = True):
    """diff = cur - learning_rate * prev (ParallelVideoPyr.cpp:803) in
    float32. On uint8 with ``faithful_uint8`` it saturates back to uint8,
    as OpenCV's Mat expression does."""
    d = cur.to(torch.float32) - float(np.float32(learning_rate)) * prev.to(torch.float32)
    if faithful_uint8 and cur.dtype == torch.uint8:
        return _saturate_u8(d)
    return d


def threshold_tozero(x, thresh: float):
    """cv2.threshold(..., THRESH_TOZERO): keep x where x > thresh else 0."""
    return torch.where(x > thresh, x, torch.zeros((), dtype=x.dtype, device=x.device))


def sobel3(img, dx: int, dy: int, out_dtype=torch.float32):
    """cv2.Sobel(ksize=3), BORDER_REFLECT_101, separable."""
    x = img.to(out_dtype)
    H, W = x.shape[-2], x.shape[-1]

    def rows(v, taps):
        p = pad_last2(v, 1, 1, 0, 0, mode="reflect")
        return sum(t * p[..., i : i + H, :] for i, t in enumerate(taps) if t)

    def cols(v, taps):
        p = pad_last2(v, 0, 0, 1, 1, mode="reflect")
        return sum(t * p[..., :, j : j + W] for j, t in enumerate(taps) if t)

    smooth, diff = (1.0, 2.0, 1.0), (-1.0, 0.0, 1.0)
    if (dx, dy) == (1, 0):
        return cols(rows(x, smooth), diff)
    if (dx, dy) == (0, 1):
        return rows(cols(x, smooth), diff)
    raise ValueError(f"unsupported (dx, dy) = {(dx, dy)}")


def _morph3x3(x, mode: str, iterations: int):
    """n iterated 3x3 dilations/erosions as one (2n+1)-square separable
    max/min pass; the border is ignored (OpenCV's default border value)."""
    if iterations <= 0:
        return x
    if torch.is_floating_point(x):
        init = -float("inf") if mode == "max" else float("inf")
    else:
        info = torch.iinfo(x.dtype)
        init = info.min if mode == "max" else info.max
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


def dilate3x3(x, iterations: int = 1):
    """cv2.dilate with the default 3x3 rect kernel, border ignored."""
    return _morph3x3(x, "max", iterations)


def erode3x3(x, iterations: int = 1):
    """cv2.erode with the default 3x3 rect kernel, border ignored."""
    return _morph3x3(x, "min", iterations)


def diff_features(cur_gray, prev_gray, config: PreprocessConfig = PreprocessConfig()):
    """Gray pair -> flow-ready feature map: temporal diff, threshold, Sobel
    x+y, dilate^n, erode^n (ParallelVideoPyr.cpp:803-814), float32."""
    d = temporal_diff(
        cur_gray, prev_gray, config.learning_rate, faithful_uint8=config.faithful_uint8
    )
    d = threshold_tozero(d, config.diff_thresh)
    d = sobel3(d, 1, 0) + sobel3(d, 0, 1)
    d = dilate3x3(d, config.morph_iterations)
    return erode3x3(d, config.morph_iterations)
