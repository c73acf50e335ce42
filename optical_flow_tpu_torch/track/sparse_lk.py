"""Pyramidal sparse Lucas–Kanade tracking, cv2.calcOpticalFlowPyrLK
semantics (port of optical_flow_tpu/track/sparse_lk.py; reference C16,
of.cpp:55: 31x31 window, 3 pyramid levels, 20 iterations / 0.03 eps).

All K features are tracked together: patch sampling is one batched
bilinear gather of (K, w+2, w+2), each Newton step one batched 2x2 solve.
The steps run a fixed ``iters`` times with a per-feature convergence mask
(|delta| <= eps freezes a feature), OpenCV's COUNT+EPS criterion; patch
gradients are Scharr 3x3 / 32, as in calcOpticalFlowPyrLK.

Returns (new_points, status, err) like cv2: status is False for features
whose window left the image or whose gradient matrix was singular.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from optical_flow_tpu_torch.ops.pyramid import gaussian_pyramid
from optical_flow_tpu_torch.utils.device import as_tensor, call_device


@dataclasses.dataclass(frozen=True)
class SparseLKConfig:
    win: int = 31  # window side (of.cpp:55 Size(31,31))
    max_level: int = 2  # coarsest pyramid index (cv2 maxLevel; 3 levels total)
    iters: int = 20  # TermCriteria COUNT (of.cpp:44)
    eps: float = 0.03  # TermCriteria EPS
    min_eig_threshold: float = 1e-4  # cv2 minEigThreshold default
    # 'gather': bilinear-gather the moving window every Newton step;
    # 'shift': one integer region gather per level, then every step samples
    #   inside the region by separable hat-weighted static shifts (a
    #   feature's wander within a level is bounded by `margin` px);
    # 'auto': 'gather' on every device of the port. The JAX package picks
    #   'shift' on the TPU, where a gather costs a scalar load per element;
    #   on a GPU a gather is an ordinary load, and 'shift' does 2(2M+2)
    #   slice-mul-adds a step (64 at win=31) for the same samples.
    impl: str = "auto"
    margin: int = 0  # 'shift' wander bound per level; 0 = win // 2


def _sample_patches(img, centers, half: int, extra: int = 1):
    """Bilinear patches around centers: img (H, W), centers (K, 2) float
    (x, y) -> (K, w + 2 extra, w + 2 extra), w = 2 half + 1. Taps outside
    the image clamp to the border (edge replication)."""
    H, W = img.shape
    w = 2 * half + 1 + 2 * extra
    offs = torch.arange(w, dtype=torch.float32, device=img.device) - (half + extra)
    cx = centers[:, 0][:, None, None]
    cy = centers[:, 1][:, None, None]
    xs = cx + offs[None, None, :]
    ys = cy + offs[None, :, None]
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = xs - x0
    fy = ys - y0

    def tap(yi, xi):
        yc = yi.to(torch.int64).clamp(0, H - 1)
        xc = xi.to(torch.int64).clamp(0, W - 1)
        return img[yc, xc]

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    top = v00 + fx * (v01 - v00)
    bot = v10 + fx * (v11 - v10)
    return top + fy * (bot - top)


def _scharr(patch):
    """Scharr 3x3 / 32 gradients of (K, n, n) -> two (K, n-2, n-2)."""
    s = (3.0 / 32.0, 10.0 / 32.0, 3.0 / 32.0)
    rs = s[0] * patch[:, :-2, :] + s[1] * patch[:, 1:-1, :] + s[2] * patch[:, 2:, :]
    ix = rs[:, :, 2:] - rs[:, :, :-2]
    cs = s[0] * patch[:, :, :-2] + s[1] * patch[:, :, 1:-1] + s[2] * patch[:, :, 2:]
    iy = cs[:, 2:, :] - cs[:, :-2, :]
    return ix, iy


def _extract_regions(img, oy, ox, P: int):
    """Integer (K, P, P) regions at per-feature origins, clamped at the
    image border: the 'shift' impl's one gather a level."""
    H, W = img.shape
    offs = torch.arange(P, dtype=oy.dtype, device=img.device)
    ys = (oy[:, None] + offs[None, :]).clamp(0, H - 1).to(torch.int64)
    xs = (ox[:, None] + offs[None, :]).clamp(0, W - 1).to(torch.int64)
    return img[ys[:, :, None], xs[:, None, :]]


def _shift_sample(R, py, px, half: int, S: int):
    """(K, w, w) windows of the (K, P, P) regions R at per-feature float
    positions (py, px) in [0, S-1], without gathers: the bilinear weight as
    a hat over integer shifts, a separable sum over S static slices per
    axis."""
    w = 2 * half + 1
    K, P, _ = R.shape
    T = R.new_zeros((K, w, P))
    for s in range(S):
        wy = torch.clamp_min(1.0 - torch.abs(py - s), 0.0)[:, None, None]
        T = T + wy * R[:, s : s + w, :]
    out = R.new_zeros((K, w, w))
    for s in range(S):
        wx = torch.clamp_min(1.0 - torch.abs(px - s), 0.0)[:, None, None]
        out = out + wx * T[:, :, s : s + w]
    return out


def _track_level(img1, img2, pts, guess, cfg: SparseLKConfig, impl: str):
    """One pyramid level of iterative LK for all K features -> (d, ok)."""
    half = cfg.win // 2
    H, W = img1.shape

    t_patch = _sample_patches(img1, pts, half, extra=1)  # (K, w+2, w+2)
    template = t_patch[:, 1:-1, 1:-1]
    ix, iy = _scharr(t_patch)  # (K, w, w)

    gxx = torch.sum(ix * ix, dim=(1, 2))
    gxy = torch.sum(ix * iy, dim=(1, 2))
    gyy = torch.sum(iy * iy, dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    win_area = cfg.win * cfg.win
    min_eig = 0.5 * (gxx + gyy - torch.sqrt((gxx - gyy) ** 2 + 4 * gxy * gxy))
    ok_eig = (min_eig / win_area) >= cfg.min_eig_threshold
    safe_det = torch.where(det != 0, det, torch.ones_like(det))

    if impl == "shift":
        M = cfg.margin or half
        P = cfg.win + 2 * M + 2
        S = 2 * M + 2  # integer shifts covering p in [0, 2M+1]
        p0 = pts + guess
        oy = torch.floor(p0[:, 1]).to(torch.int32) - half - M
        ox = torch.floor(p0[:, 0]).to(torch.int32) - half - M
        R2 = _extract_regions(img2, oy, ox, P)
        org = torch.stack([ox, oy], dim=-1).to(torch.float32)

    def sample2(d):
        p2 = pts + d
        if impl != "shift":
            return _sample_patches(img2, p2, half, extra=0)
        # the window's top-left in the region, clamped: the wander bound
        q = torch.clamp(p2 - org - half, 0.0, float(S - 1))
        return _shift_sample(R2, q[:, 1], q[:, 0], half, S)

    d = guess
    live = ok_eig & (det != 0)
    live0 = live
    for _ in range(cfg.iters):
        diff = sample2(d) - template
        bx = torch.sum(diff * ix, dim=(1, 2))
        by = torch.sum(diff * iy, dim=(1, 2))
        du = (gyy * bx - gxy * by) / safe_det
        dv = (gxx * by - gxy * bx) / safe_det
        delta = -torch.stack([du, dv], dim=-1)
        d = torch.where(live[:, None], d + delta, d)
        live = live & (torch.sum(delta * delta, dim=-1) > cfg.eps * cfg.eps)

    # cv2: a feature is lost only when its center leaves the image by more
    # than the half-window
    x, y = pts[:, 0] + d[:, 0], pts[:, 1] + d[:, 1]
    inb = (x >= -half) & (x <= W - 1 + half) & (y >= -half) & (y <= H - 1 + half)
    return d, live0 & inb


def build_tracking_pyramid(img, config: Optional[SparseLKConfig] = None, *, device=None):
    """The Gaussian pyramid ``track_features(..., pyr1=, pyr2=)`` takes, as
    a tuple of float32 levels. Sequential tracking builds each frame's
    pyramid once and passes it as img2's this step and img1's the next.
    Built with ``gaussian_pyramid(impl='auto')``: kernel K2 on the card.
    A tensor stays on its device; a host array goes to the card unless
    ``device`` names another."""
    cfg = config or SparseLKConfig()
    img = as_tensor(img, call_device(img, device=device), torch.float32).contiguous()
    return tuple(gaussian_pyramid(img, cfg.max_level + 1, impl="auto"))


def _track(img1, img2, pts, cfg: SparseLKConfig, impl: str, pyr1=None, pyr2=None):
    levels = cfg.max_level + 1
    if pyr1 is None:
        pyr1 = build_tracking_pyramid(img1, cfg)
    if pyr2 is None:
        pyr2 = build_tracking_pyramid(img2, cfg)

    K = pts.shape[0]
    d = torch.zeros((K, 2), dtype=torch.float32, device=pts.device)
    status = torch.ones((K,), dtype=torch.bool, device=pts.device)
    for lvl in range(levels - 1, -1, -1):
        d, ok = _track_level(
            pyr1[lvl].to(torch.float32), pyr2[lvl].to(torch.float32),
            pts / float(1 << lvl), d, cfg, impl,
        )
        status = status & ok
        if lvl > 0:
            d = d * 2.0
    new_pts = pts + d

    half = cfg.win // 2
    err_patch1 = _sample_patches(img1, pts, half, extra=0)
    err_patch2 = _sample_patches(img2, new_pts, half, extra=0)
    err = torch.mean(torch.abs(err_patch2 - err_patch1), dim=(1, 2))
    return new_pts, status, err


def track_features(
    img1, img2, points, config: Optional[SparseLKConfig] = None, *,
    pyr1=None, pyr2=None, device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """cv2.calcOpticalFlowPyrLK(img1, img2, points) analogue.

    img1/img2: (H, W) gray; points: (K, 2) float32 (x, y). pyr1/pyr2:
    optional prebuilt pyramids (``build_tracking_pyramid``). Tensors stay on
    their device; host arrays go to the card unless ``device`` names
    another. Returns (new_points (K, 2), status (K,) bool, err (K,) float32).
    """
    cfg = config or SparseLKConfig()
    impl = "gather" if cfg.impl == "auto" else cfg.impl
    if impl not in ("gather", "shift"):
        raise ValueError(f"impl must be 'gather', 'shift' or 'auto', got {cfg.impl!r}")
    first = pyr1[0] if pyr1 is not None else None
    dev = call_device(img1, img2, points, first, device=device)
    return _track(
        as_tensor(img1, dev, torch.float32), as_tensor(img2, dev, torch.float32),
        as_tensor(points, dev, torch.float32), cfg, impl, pyr1=pyr1, pyr2=pyr2,
    )
