"""RANSAC homography from sparse feature tracks (port of
optical_flow_tpu/track/pose.py).

All hypotheses at once: ``n_hypotheses`` minimal 4-point sets, each solved
by normalized DLT (the null vector of the 9x9 normal matrix from a batched
``eigh``) and scored by one (n_hypotheses, K) transfer-error broadcast; the
winner's consensus set is refined by a final weighted DLT. Fixed shapes, no
data-dependent control flow.

The JAX package draws the 4-point sets from threefry, a stream torch cannot
reproduce. ``sample_hypotheses`` draws them from a CPU ``torch.Generator``
seeded by ``RansacConfig.seed``, so the card and the CPU pick the same sets;
the solver takes the sets as an argument.

``estimate_homography`` solves and scores in float64 and returns H in
float32, where the JAX package stays in float32. The normal matrix squares
the design matrix's condition number, and in float32 the vote is chaotic
on real tracks: on a frame pair of two motions (a static background and a
moving patch) a 1e-6 relative change of the points moved the winning
inlier count from 500 to 421, so the card and the CPU picked different
winners. In float64 the same change moves nothing. The private helpers
keep the dtype they are given; their matmuls run in full precision (no
TF32) whatever the caller's global setting, since with TF32 even the
minimal 4-point case is no longer exact.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from optical_flow_tpu_torch.pipeline.preprocess import _ieee_f32_matmul
from optical_flow_tpu_torch.utils.device import as_tensor, call_device


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    n_hypotheses: int = 256
    inlier_px: float = 3.0
    seed: int = 0


def _normalize_points(pts, w):
    """Hartley normalization with weights w (..., K) of pts (K, 2): the
    similarity T with the weighted centroid at 0 and mean distance
    sqrt(2). Returns (pts_n (..., K, 2), T (..., 3, 3))."""
    wsum = torch.clamp_min(torch.sum(w, dim=-1), 1e-9)
    c = torch.sum(pts * w[..., None], dim=-2) / wsum[..., None]
    d = torch.sqrt(torch.sum((pts - c[..., None, :]) ** 2, dim=-1))
    mean_d = torch.sum(d * w, dim=-1) / wsum
    s = math.sqrt(2.0) / torch.clamp_min(mean_d, 1e-9)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, zero, -s * c[..., 0]], dim=-1),
        torch.stack([zero, s, -s * c[..., 1]], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    return (pts - c[..., None, :]) * s[..., None, None], T


def _dlt_homography(p1, p2, w):
    """Weighted DLT: H (..., 3, 3) with p2 ~ H p1, from K >= 4 pairs.
    p1/p2: (K, 2); w: (..., K) weights (0 leaves a pair out). The null
    vector of the (2K, 9) design matrix is the smallest eigenvalue's
    eigenvector of its normal matrix (exact for the minimal K = 4 case)."""
    p1n, T1 = _normalize_points(p1, w)
    p2n, T2 = _normalize_points(p2, w)
    x, y = p1n[..., 0], p1n[..., 1]
    u, v = p2n[..., 0], p2n[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], dim=-1)
    r2 = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], dim=-1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)  # (..., 2K, 9)
    _, ev = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    Hn = ev[..., :, 0].reshape(ev.shape[:-2] + (3, 3))  # ascending: column 0
    H = torch.linalg.solve(T2, Hn @ T1)
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(torch.abs(h22) > 1e-12, h22, torch.ones_like(h22))


def _transfer_error(H, p1, p2):
    """Forward transfer error |H p1 - p2| per pair: H (..., 3, 3) ->
    (..., K)."""
    ones = torch.ones((p1.shape[0], 1), dtype=p1.dtype, device=p1.device)
    ph = torch.cat([p1, ones], dim=-1) @ H.transpose(-1, -2)
    w = ph[..., 2:3]
    proj = ph[..., :2] / torch.where(torch.abs(w) > 1e-12, w, torch.full_like(w, 1e-12))
    return torch.sqrt(torch.sum((proj - p2) ** 2, dim=-1))


def sample_hypotheses(valid: torch.Tensor, n_hypotheses: int, seed: int) -> torch.Tensor:
    """(n_hypotheses, 4) indices of valid points: the top 4 of uniform
    scores masked to -inf where not valid, drawn on the CPU from ``seed``
    (the same sets on every device), returned on ``valid``'s device."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    scores = torch.rand((n_hypotheses, valid.shape[0]), generator=gen)
    scores = torch.where(valid.cpu()[None, :], scores, torch.tensor(-float("inf")))
    return torch.topk(scores, 4, dim=-1).indices.to(valid.device)


def _ransac_homography(p1, p2, valid, inlier_px: float, idx):
    """RANSAC over the given (n_hypotheses, 4) sets -> (H, inliers, count),
    in the points' dtype."""
    thr = float(np.float32(inlier_px))
    w = torch.zeros((idx.shape[0], p1.shape[0]), dtype=p1.dtype, device=p1.device)
    w = w.scatter(1, idx, 1.0) * valid
    with _ieee_f32_matmul():
        errs = _transfer_error(_dlt_homography(p1, p2, w), p1, p2)  # (n, K)
        inl = (errs <= thr) & valid[None, :]
        best = torch.argmax(torch.sum(inl, dim=-1))  # the first of equal counts
        H = _dlt_homography(p1, p2, inl[best].to(p1.dtype))
        final_inl = (_transfer_error(H, p1, p2) <= thr) & valid
    return H, final_inl, torch.sum(final_inl)


def estimate_homography(
    pts1, pts2, valid=None, config: RansacConfig = RansacConfig(), *, device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RANSAC homography from matched points.

    pts1/pts2: (K, 2); valid: optional (K,) bool. Tensors stay on their
    device; host arrays go to the card unless ``device`` names another.
    Solved in float64 (module docstring). Returns (H (3, 3) float32,
    inlier mask (K,) bool, inlier count).
    """
    dev = call_device(pts1, pts2, valid, device=device)
    p1 = as_tensor(pts1, dev, torch.float32).to(torch.float64)
    p2 = as_tensor(pts2, dev, torch.float32).to(torch.float64)
    v = (torch.ones((p1.shape[0],), dtype=torch.bool, device=dev) if valid is None
         else as_tensor(valid, dev, torch.bool))
    idx = sample_hypotheses(v, config.n_hypotheses, config.seed)
    H, inl, n = _ransac_homography(p1, p2, v, config.inlier_px, idx)
    return H.to(torch.float32), inl, n
