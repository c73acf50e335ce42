"""Perspective-n-Point: absolute camera pose from 3D-2D correspondences
(port of optical_flow_tpu/slam/pnp.py).

DLT linear solve with orthonormal R projection and the determinant sign fix,
batched over hypotheses; the multi-view front end chains keyframes onto the
map with it. Inputs are normalized camera coordinates (see
``epipolar.normalize_pixels``), float32 as in the JAX package.

The null vector of the (2K, 12) design matrix is the smallest eigenvalue's
eigenvector of its 12x12 normal matrix, formed in float64 (JAX: the SVD of
the design matrix in float32; see ``epipolar``). The 6-point RANSAC sets
come from ``track.pose.sample_hypotheses(..., k=6)``, and ``_pnp_ransac``
takes them as an argument.
"""

from __future__ import annotations

from typing import Tuple

import torch

from optical_flow_tpu_torch.pipeline.preprocess import _ieee_f32_matmul
from optical_flow_tpu_torch.slam.epipolar import _INF, _clip, _row, _scalar, _take
from optical_flow_tpu_torch.track.pose import sample_hypotheses
from optical_flow_tpu_torch.utils.device import as_tensor, call_device


def _pnp_dlt(X, x, w):
    """(R (..., 3, 3), t (..., 3)) from X (K, 3), x (K, 2) and weights w
    (..., K)."""
    K = X.shape[0]
    Xh = torch.cat([X, torch.ones((K, 1), dtype=X.dtype, device=X.device)], dim=1)  # (K, 4)
    z = torch.zeros((K, 4), dtype=X.dtype, device=X.device)
    r1 = torch.cat([Xh, z, -x[:, 0:1] * Xh], dim=1)  # (K, 12)
    r2 = torch.cat([z, Xh, -x[:, 1:2] * Xh], dim=1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2).to(torch.float64)
    _, ev = torch.linalg.eigh(A.mT @ A)
    P = ev[..., :, 0].to(X.dtype).reshape(ev.shape[:-2] + (3, 4))  # ascending: column 0
    M = P[..., :3]
    # orthonormalize: R = U V^T; the mean of the singular values estimates
    # the projective scale |lambda|
    u, s, vt2 = torch.linalg.svd(M)
    R0 = u @ vt2
    det = torch.linalg.det(R0)
    # The null vector's sign (P vs -P) cancels: forcing det(R) = +1 and
    # carrying the sign into the scale makes (R, t) invariant.
    R = R0 * det[..., None, None]
    t = P[..., 3] / (det * torch.mean(s, dim=-1))[..., None]
    return R, t


def pnp_dlt(X, x, w=None, *, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera pose from K >= 6 correspondences, float32.

    X: (K, 3) world points; x: (K, 2) normalized image points; w: optional
    (K,) weights. Tensors stay on their device; host arrays go to the card
    unless ``device`` names another. Returns (R (3, 3), t (3,)) with x ~
    pi(R X + t).
    """
    dev = call_device(X, x, w, device=device)
    X = as_tensor(X, dev, torch.float32)
    x = as_tensor(x, dev, torch.float32)
    w = (torch.ones((X.shape[0],), dtype=X.dtype, device=dev) if w is None
         else as_tensor(w, dev, X.dtype))
    with _ieee_f32_matmul():
        return _pnp_dlt(X, x, w)


def reprojection_errors(R, t, X, x) -> torch.Tensor:
    """Per-point reprojection error in normalized coords: R (..., 3, 3), t
    (..., 3) -> (..., K)."""
    Xc = X @ R.mT + t[..., None, :]
    z = Xc[..., 2:3]
    z = torch.where(torch.abs(z) > 1e-9, z, 1e-9)
    proj = Xc[..., :2] / z
    return torch.sqrt(torch.sum((proj - x) ** 2, dim=-1))


def _pnp_ransac(X, x, v, inlier_thresh: float, idx):
    """RANSAC over the given (n_hypotheses, 6) sets -> (R, t, inliers)."""
    K = X.shape[0]
    w = torch.zeros((idx.shape[0], K), dtype=X.dtype, device=X.device)
    w = w.scatter(1, idx, 1.0) * v
    with _ieee_f32_matmul():
        Rs, ts = _pnp_dlt(X, x, w)
        errs = reprojection_errors(Rs, ts, X, x)  # (n, K)
        errs_m = torch.where(v[None, :], errs, _INF)
        n_valid = v.sum()
        med_idx = torch.clamp_min(n_valid // 2, 0)
        med = _take(torch.sort(errs_m, dim=-1).values, med_idx)
        best = torch.argmin(med)
        t0 = _scalar(inlier_thresh, X)
        cap = 8.0 * t0  # never adapt the gate to a garbage scale
        base = _clip(2.5 * _row(med, best), t0, cap)

        def gate(e):
            # re-adapted per model: the current model's median residual
            # tracks the noise scale; a minimal sample's near-exact fit
            # must not freeze the gate below it
            med_all = _take(torch.sort(torch.where(v, e, _INF)).values, med_idx)
            return _clip(2.5 * med_all, base, cap)

        R, t = _row(Rs, best), _row(ts, best)
        for _ in range(3):
            e = reprojection_errors(R, t, X, x)
            cur = (e <= gate(e)) & v
            # floor at the 6 best residuals so the DLT never goes degenerate
            em = torch.where(v, e, _INF)
            k6 = em <= _take(torch.sort(em).values, torch.clamp_max(n_valid - 1, 5))
            cur = torch.where(cur.sum() >= 6, cur, k6 & v)
            R, t = _pnp_dlt(X, x, cur.to(X.dtype))
        e = reprojection_errors(R, t, X, x)
        final = (e <= gate(e)) & v
    return R, t, final


def pnp_ransac(
    X, x, valid=None, *, n_hypotheses: int = 256, inlier_thresh: float = 2e-3, seed: int = 0,
    device=None,
):
    """Robust PnP: 6-point DLT hypotheses in one batch, MEDSAC choice on the
    reprojection error, then three weighted refits on the consensus, with
    the essential RANSAC's noise-adaptive gate. Tensors stay on their
    device; host arrays go to the card unless ``device`` names another.

    Returns (R, t, inlier mask).
    """
    dev = call_device(X, x, valid, device=device)
    X = as_tensor(X, dev, torch.float32)
    x = as_tensor(x, dev, torch.float32)
    v = (torch.ones((X.shape[0],), dtype=torch.bool, device=dev) if valid is None
         else as_tensor(valid, dev, torch.bool))
    idx = sample_hypotheses(v, n_hypotheses, seed, k=6)
    return _pnp_ransac(X, x, v, inlier_thresh, idx)
