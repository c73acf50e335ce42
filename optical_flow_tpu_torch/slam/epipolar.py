"""Two-view epipolar geometry: essential-matrix RANSAC (8- and 5-point),
pose recovery, local pose refinement and triangulation (port of
optical_flow_tpu/slam/epipolar.py).

As in the JAX package, every 8-point hypothesis is drawn, solved and scored
in one batch; pose recovery tests the four (R, t) decompositions by one
batched cheirality count; triangulation is a batched per-point DLT. The
5-point solver (Stewenius action matrix) runs on the host in float64 numpy,
as JAX runs it, and its consensus refit runs on the call's device.

Convention: normalized camera coordinates (pixels pre-divided by focal,
principal point at 0; ``normalize_pixels``). x2^T E x1 = 0 with x = (u, v,
1); the recovered (R, t) maps the camera-1 frame to camera 2: X_2 = R X_1 +
t, |t| = 1.

Differences from the JAX package, none in what is computed:
- the 8-point sets come from ``track.pose.sample_hypotheses(..., k=8)`` (a
  CPU generator seeded by ``EssentialRansacConfig.seed``), not threefry;
  the solver takes them as an argument;
- the 8-point null vector is the smallest eigenvalue's eigenvector of the
  9x9 normal matrix, formed in float64 from the float32 design matrix
  (JAX: the SVD of the (K, 9) design matrix in float32). A batch of tall
  SVDs runs one matrix at a time in cuSOLVER; the float64 normal matrix
  keeps the null vector as accurate as the float32 SVD's;
- ``estimate_essential``, ``refine_pose``, ``triangulate`` and the refit of
  ``ransac_essential_5pt`` run in float32, as JAX forces them to; inside
  ``recover_pose`` the camera-1 matrix is float32 too (under x64 JAX's is
  float64 and promotes its triangulation);
- float32 matmuls run in full precision (no TF32) whatever the caller's
  global setting.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from optical_flow_tpu_torch.pipeline.preprocess import _ieee_f32_matmul
from optical_flow_tpu_torch.track.pose import _normalize_points as _hartley
from optical_flow_tpu_torch.track.pose import sample_hypotheses
from optical_flow_tpu_torch.utils.device import as_tensor, call_device, host_array

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class EssentialRansacConfig:
    n_hypotheses: int = 512
    # Inlier gate on the LINEAR Sampson distance in normalized coords
    # (~ pixels / focal): 2e-3 is ~0.8 px at focal 400.
    inlier_thresh: float = 2e-3
    seed: int = 0


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of ``like``'s dtype and device, filled on the device (no
    host copy)."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[..., i] for a 0-d index tensor, without a host sync."""
    return x.index_select(-1, i.reshape(1)).squeeze(-1)


def _row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor, without a host sync."""
    return x.index_select(0, i.reshape(1)).squeeze(0)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def normalize_pixels(pts, focal: float, cx: float, cy: float, *, device=None) -> torch.Tensor:
    """Pixel coords -> normalized camera coords, float32. A tensor stays on
    its device; a host array goes to the card unless ``device`` names
    another."""
    dev = call_device(pts, device=device)
    p = as_tensor(pts, dev, torch.float32)
    c = torch.stack([_scalar(cx, p), _scalar(cy, p)])
    return (p - c) / _scalar(focal, p)


def _eight_point(p1, p2, w):
    """Weighted, Hartley-normalized 8-point algorithm: E (..., 3, 3) with
    x2^T E x1 = 0, from K pairs (K, 2) in normalized camera coords and
    weights w (..., K). The essential structure (two equal singular values,
    the third zero) is enforced."""
    p1n, T1 = _hartley(p1, w)
    p2n, T2 = _hartley(p2, w)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    o = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], dim=-1)
    Aw = (A * w[..., None]).to(torch.float64)  # (..., K, 9)
    _, ev = torch.linalg.eigh(Aw.mT @ Aw)
    En = ev[..., :, 0].to(p1.dtype).reshape(ev.shape[:-2] + (3, 3))  # ascending: column 0
    E = T2.mT @ En @ T1  # denormalize
    u, s, vt2 = torch.linalg.svd(E)
    sm = 0.5 * (s[..., 0] + s[..., 1])
    d = torch.stack([sm, sm, torch.zeros_like(sm)], dim=-1)
    return u @ torch.diag_embed(d) @ vt2


def _sampson(E, p1, p2):
    """Linear Sampson distance per correspondence: E (..., 3, 3) -> (..., K),
    in the coordinates' units (normalized ~ pixels / focal)."""
    ones = torch.ones((p1.shape[0], 1), dtype=p1.dtype, device=p1.device)
    x1 = torch.cat([p1, ones], dim=-1)  # (K, 3)
    x2 = torch.cat([p2, ones], dim=-1)
    Ex1 = x1 @ E.mT  # (..., K, 3)
    Etx2 = x2 @ E
    num = torch.sum(x2 * Ex1, dim=-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return torch.sqrt(num / torch.clamp_min(den, 1e-12))


def _ransac_essential(p1, p2, valid, thresh, idx):
    """RANSAC over the given (n_hypotheses, 8) sets -> (E, inliers, count),
    in the points' dtype; ``thresh`` is a 0-d tensor of that dtype."""
    K = p1.shape[0]
    w = torch.zeros((idx.shape[0], K), dtype=p1.dtype, device=p1.device)
    w = w.scatter(1, idx, 1.0) * valid
    with _ieee_f32_matmul():
        Es = _eight_point(p1, p2, w)
        errs = _sampson(Es, p1, p2)  # (n, K)
        # Hypothesis selection by MEDIAN residual (MEDSAC), not inlier
        # count: a minimal sample of 8 true correspondences gives an (almost)
        # exact model whose median residual is ~0, while contaminated
        # samples score orders of magnitude worse.
        n_valid = valid.sum()
        med_idx = torch.clamp_min(n_valid // 2, 0)
        errs_masked = torch.where(valid[None, :], errs, _INF)
        med_scores = _take(torch.sort(errs_masked, dim=-1).values, med_idx)
        best = torch.argmin(med_scores)  # the first of equal medians
        # Noise-adaptive gate: 2.5x the winning median residual (~1.7 sigma
        # of the noise), capped at 8x the configured gate so that garbage
        # correspondences cannot declare everything an inlier.
        cap = 8.0 * thresh
        thresh = _clip(2.5 * _row(med_scores, best), thresh, cap)

        def floor8(e, cur):
            # refit support floor: fewer than 8 gated points leave the
            # system under-determined; fall back to the 8 smallest residuals
            em = torch.where(valid, e, _INF)
            k8 = em <= _take(torch.sort(em).values, torch.clamp_max(n_valid - 1, 7))
            return torch.where(cur.sum() >= 8, cur, k8 & valid)

        def gate(e):
            # re-adapted per model: the current model's median over all
            # valid points tracks the real noise scale (capped as above)
            med_all = _take(torch.sort(torch.where(valid, e, _INF)).values, med_idx)
            return _clip(2.5 * med_all, thresh, cap)

        # Trimmed-LS refits on the best half of the consensus: a random
        # outlier can sit on an epipolar line and pass any fixed gate.
        eb = _row(errs, best)
        cur = floor8(eb, (eb <= gate(eb)) & valid)
        E = _eight_point(p1, p2, cur.to(p1.dtype))
        for _ in range(6):
            e = _sampson(E, p1, p2)
            cur = floor8(e, (e <= gate(e)) & valid)
            es = torch.sort(torch.where(cur, e, _INF)).values
            med = _take(es, torch.clamp_min(cur.sum() // 2, 0))
            trim = floor8(e, cur & (e <= med))
            E = _eight_point(p1, p2, trim.to(p1.dtype))
        e = _sampson(E, p1, p2)
        final_inl = (e <= gate(e)) & valid
    return E, final_inl, final_inl.sum()


def estimate_essential(
    pts1, pts2, valid=None, config: EssentialRansacConfig = EssentialRansacConfig(), *,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RANSAC essential matrix from matched NORMALIZED points (K, 2), in
    float32. Tensors stay on their device; host arrays go to the card
    unless ``device`` names another.

    Returns (E (3, 3), inlier mask (K,), inlier count)."""
    dev = call_device(pts1, pts2, valid, device=device)
    p1 = as_tensor(pts1, dev, torch.float32)
    p2 = as_tensor(pts2, dev, torch.float32)
    v = (torch.ones((p1.shape[0],), dtype=torch.bool, device=dev) if valid is None
         else as_tensor(valid, dev, torch.bool))
    # with < 8 valid points the top 8 would take invalid rows and the
    # zero-weighted solve is under-determined (a garbage E)
    n_valid = int(v.sum())
    if n_valid < 8:
        raise ValueError(f"estimate_essential needs >= 8 valid correspondences, got {n_valid}")
    idx = sample_hypotheses(v, config.n_hypotheses, config.seed, k=8)
    return _ransac_essential(p1, p2, v, _scalar(config.inlier_thresh, p1), idx)


# ------------------------------------------------------------- 5-point solver
#
# Minimal essential-matrix solver (Nister's problem, solved with the
# Stewenius action-matrix method): exactly 5 correspondences give up to 10
# essential matrices, with the essential constraints (det E = 0 and
# 2 E E^T E - tr(E E^T) E = 0) enforced exactly. Host-side float64 numpy, as
# in the JAX package: the batched 10x10 non-symmetric eigendecomposition is
# a host-time step of hypothesis generation.

_MONOMIALS3 = np.array(
    [
        (3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1),
        (1, 0, 2), (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3),
        (2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1),
        (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
    ],
    np.int64,
)


def _monomials3():
    """Stewenius monomial order: x3 x2y x2z xy2 xyz xz2 y3 y2z yz2 z3 |
    x2 xy xz y2 yz z2 x y z 1 — leading 10, then the quotient-ring basis."""
    return _MONOMIALS3


def _poly_mul(a, b):
    """Multiply trivariate polynomials stored as (4, 4, 4) coefficient cubes
    (index = exponent of x, y, z)."""
    out = np.zeros((4, 4, 4))
    for i, j, k in np.argwhere(a):
        aijk = a[i, j, k]
        for p, q, r in np.argwhere(b):
            out[i + p, j + q, k + r] += aijk * b[p, q, r]
    return out


def five_point(p1, p2):
    """Up to 10 essential matrices from EXACTLY 5 correspondences in
    normalized camera coords ((5, 2) each). Returns (N, 3, 3) float64 numpy:
    ``five_point_batch`` with S = 1, near-duplicates removed."""
    p1 = host_array(p1).astype(np.float64)
    p2 = host_array(p2).astype(np.float64)
    if p1.shape != (5, 2) or p2.shape != (5, 2):
        raise ValueError(f"need exactly 5 pairs, got {p1.shape}, {p2.shape}")
    Es, mask = five_point_batch(p1[None], p2[None])
    out = []
    for E in Es[0][mask[0]]:
        if all(min(np.linalg.norm(E - F), np.linalg.norm(E + F)) > 1e-6 for F in out):
            out.append(E)
    return np.stack(out) if out else np.zeros((0, 3, 3))


def _poly_mul_batch(A, B):
    """Batched trivariate polynomial product over (S, 4, 4, 4) coefficient
    cubes, truncated to degree <= 3 per axis (every product the 5-point
    construction forms stays within the cube). Iterates only A's nonzero
    cells, each one multiply-accumulate over the whole batch."""
    out = np.zeros_like(B)
    nz = np.argwhere(np.any(A, axis=0))
    for p, q, r in nz:
        out[:, p:, q:, r:] += A[:, p, q, r, None, None, None] * B[:, : 4 - p, : 4 - q, : 4 - r]
    return out


def five_point_batch(p1s, p2s):
    """``five_point`` over S samples: (S, 5, 2) x2 -> (S, 10, 3, 3) float64
    essential matrices and a validity mask (S, 10). Every stage is batched:
    the SVD null spaces, the polynomial coefficients, the Gauss-Jordan solve
    (singular samples masked out, not raised), the 10x10 eigendecompositions
    and the root extraction. No per-sample dedup."""
    p1s = host_array(p1s).astype(np.float64)
    p2s = host_array(p2s).astype(np.float64)
    S = p1s.shape[0]
    if p1s.shape != (S, 5, 2) or p2s.shape != (S, 5, 2):
        raise ValueError(f"need (S,5,2) pairs, got {p1s.shape}, {p2s.shape}")
    ones = np.ones((S, 5, 1))
    q1 = np.concatenate([p1s, ones], axis=2)
    q2 = np.concatenate([p2s, ones], axis=2)
    A = np.einsum("ski,skj->skij", q2, q1).reshape(S, 5, 9)
    _, _, vt = np.linalg.svd(A)
    basis = vt[:, 5:9].reshape(S, 4, 3, 3)  # X, Y, Z, W per sample

    Epoly = np.zeros((3, 3, S, 4, 4, 4))
    Epoly[:, :, :, 1, 0, 0] = np.moveaxis(basis[:, 0], 0, -1)
    Epoly[:, :, :, 0, 1, 0] = np.moveaxis(basis[:, 1], 0, -1)
    Epoly[:, :, :, 0, 0, 1] = np.moveaxis(basis[:, 2], 0, -1)
    Epoly[:, :, :, 0, 0, 0] = np.moveaxis(basis[:, 3], 0, -1)

    pm = _poly_mul_batch
    det = np.zeros((S, 4, 4, 4))
    for (i, j, k), s in (
        ((0, 1, 2), +1), ((1, 2, 0), +1), ((2, 0, 1), +1),
        ((0, 2, 1), -1), ((1, 0, 2), -1), ((2, 1, 0), -1),
    ):
        det += s * pm(pm(Epoly[0, i], Epoly[1, j]), Epoly[2, k])

    EEt = np.zeros((3, 3, S, 4, 4, 4))
    for i in range(3):
        for j in range(3):
            for k in range(3):
                EEt[i, j] += pm(Epoly[i, k], Epoly[j, k])
    trace = EEt[0, 0] + EEt[1, 1] + EEt[2, 2]
    eqs = [det]
    for i in range(3):
        for j in range(3):
            acc = np.zeros((S, 4, 4, 4))
            for k in range(3):
                acc += pm(EEt[i, k], Epoly[k, j])
            eqs.append(2.0 * acc - pm(trace, Epoly[i, j]))

    mono = _monomials3()
    M = np.stack([[eq[:, dx, dy, dz] for dx, dy, dz in mono] for eq in eqs])  # (10, 20, S)
    M = np.moveaxis(M, -1, 0)  # (S, 10, 20)

    lead = M[:, :, :10]
    ok_s = np.abs(np.linalg.det(lead)) > 1e-300  # singular leading blocks
    B = np.zeros((S, 10, 10))
    if ok_s.any():
        B[ok_s] = np.linalg.solve(lead[ok_s], M[ok_s][:, :, 10:])
    # near-singular blocks can pass the det gate yet solve to inf/nan, and
    # an inf anywhere makes the batched eig raise for every sample: mask them
    finite = np.isfinite(B).all(axis=(1, 2))
    ok_s &= finite
    B = np.where(finite[:, None, None], B, 0.0)

    At = np.zeros((S, 10, 10))
    At[:, :6] = -B[:, :6]
    At[:, 6, 0] = 1.0
    At[:, 7, 1] = 1.0
    At[:, 8, 2] = 1.0
    At[:, 9, 6] = 1.0
    wvals, vecs = np.linalg.eig(At)  # (S, 10), (S, 10, 10)

    real = np.abs(wvals.imag) <= 1e-8 * np.maximum(1.0, np.abs(wvals.real))
    v = vecs.real  # (S, 10 basis, 10 eigvec): columns are eigenvectors
    v9 = v[:, 9, :]
    nz9 = np.abs(v9) > 1e-12
    denom = np.where(nz9, v9, 1.0)
    x = v[:, 6, :] / denom
    y = v[:, 7, :] / denom
    z = v[:, 8, :] / denom
    coef = np.stack([x, y, z, np.ones_like(x)], axis=1)  # (S, 4, 10)
    Es = np.einsum("scn,scij->snij", coef, basis)
    nrm = np.linalg.norm(Es, axis=(2, 3))
    good = real & nz9 & ok_s[:, None] & np.isfinite(nrm) & (nrm > 1e-12)
    Es = Es / np.where(good, nrm, 1.0)[:, :, None, None]
    return Es, good


def ransac_essential_5pt(
    pts1, pts2, valid=None, config: EssentialRansacConfig = EssentialRansacConfig(),
    n_samples: int = 256, *, device=None,
):
    """RANSAC over 5-point minimal hypotheses with the MEDSAC choice of the
    8-point path and its trimmed 8-point refit on the winning consensus.

    Hypotheses and their scores are float64 numpy on the host; the 5-point
    samples are ``np.random.RandomState(config.seed).choice``, as in the JAX
    package, so both draw the same samples. The float32 refit runs on the
    call's device (tensors stay on theirs; host arrays go to the card unless
    ``device`` names another). Returns (E, inliers, count) like
    ``estimate_essential``."""
    dev = call_device(pts1, pts2, valid, device=device)
    p1 = host_array(pts1).astype(np.float64)
    p2 = host_array(pts2).astype(np.float64)
    K = p1.shape[0]
    v = np.ones(K, bool) if valid is None else host_array(valid).astype(bool)
    live = np.flatnonzero(v)
    if len(live) < 5:
        raise ValueError(f"need >= 5 valid correspondences, got {len(live)}")
    rng = np.random.RandomState(config.seed)
    ids = np.stack([rng.choice(live, 5, replace=False) for _ in range(n_samples)])
    E_b, good = five_point_batch(p1[ids], p2[ids])
    E_all = E_b[good]  # (M, 3, 3)
    if len(E_all) == 0:
        raise RuntimeError("no 5-point hypothesis produced a valid model")

    x1 = np.concatenate([p1, np.ones((K, 1))], axis=1)  # (K, 3)
    x2 = np.concatenate([p2, np.ones((K, 1))], axis=1)
    Ex1 = np.einsum("mij,kj->mki", E_all, x1)  # (M, K, 3)
    Etx2 = np.einsum("mji,kj->mki", E_all, x2)
    num = np.einsum("ki,mki->mk", x2, Ex1) ** 2
    den = Ex1[:, :, 0] ** 2 + Ex1[:, :, 1] ** 2
    den += Etx2[:, :, 0] ** 2 + Etx2[:, :, 1] ** 2
    e_all = np.sqrt(num / np.maximum(den, 1e-12))  # linear Sampson, (M, K)
    med_idx = max(int(v.sum()) // 2, 0)
    meds = np.sort(np.where(v[None, :], e_all, np.inf), axis=1)[:, med_idx]
    best = int(np.argmin(meds))
    best_E, best_med = E_all[best], float(meds[best])

    # trimmed 8-point refit on the consensus, float32 on the device (the
    # 8-point path's loop and noise-adaptive gate, without its floor)
    p1t = torch.from_numpy(p1).to(device=dev, dtype=torch.float32)
    p2t = torch.from_numpy(p2).to(device=dev, dtype=torch.float32)
    vt = torch.from_numpy(v).to(dev)
    E = torch.from_numpy(best_E).to(device=dev, dtype=torch.float32)
    cap5 = 8.0 * float(config.inlier_thresh)
    base = _scalar(min(max(config.inlier_thresh, 2.5 * best_med), cap5), p1t)
    cap = _scalar(cap5, p1t)
    med_idx_t = torch.clamp_min(vt.sum() // 2, 0)

    def gate(e):
        med_all = _take(torch.sort(torch.where(vt, e, _INF)).values, med_idx_t)
        return _clip(2.5 * med_all, base, cap)

    with _ieee_f32_matmul():
        for _ in range(6):
            e = _sampson(E, p1t, p2t)
            cur = (e <= gate(e)) & vt
            es = torch.sort(torch.where(cur, e, _INF)).values
            med = _take(es, torch.clamp_min(cur.sum() // 2, 0))
            trim = cur & (e <= med)
            E = _eight_point(p1t, p2t, trim.to(torch.float32))
        e = _sampson(E, p1t, p2t)
        final = (e <= gate(e)) & vt
    return E, final, final.sum()


# ------------------------------------------------- local pose optimization
#
# The LO step of LO-RANSAC: Gauss-Newton on the sum of squared Sampson
# residuals over the 5 pose dofs (3 axis-angle for R, 2 tangent-plane for
# the unit translation). E = [t]_x R by construction at every iterate.


def _skew(t):
    z = torch.zeros_like(t[0])
    return torch.stack([
        torch.stack([z, -t[2], t[1]]),
        torch.stack([t[2], z, -t[0]]),
        torch.stack([-t[1], t[0], z]),
    ])


def _exp_so3(w):
    """Rodrigues: exp([w]_x), value- AND gradient-safe at w = 0.

    The epsilon must be large enough that the quotient-rule denominator
    (th2 + eps)^2 stays a NORMAL f32 (eps = 1e-24 squared underflows to 0
    and the forward derivative of (1-cos)/th2 is NaN, which would freeze
    every Gauss-Newton user of this function at the zero perturbation). At
    eps = 1e-12 the small-angle values are exact to f32: sin(1e-6)/1e-6 =
    1, (1-cos(1e-6))/1e-12 = 0.5.
    """
    th2 = torch.sum(w * w)
    th = torch.sqrt(th2 + 1e-12)
    K = _skew(w)
    a = torch.sin(th) / th
    b = (1.0 - torch.cos(th)) / (th2 + 1e-12)
    return torch.eye(3, dtype=w.dtype, device=w.device) + a * K + b * (K @ K)


def _tangent_basis(t):
    """(3, 2) orthonormal basis of the plane perpendicular to unit t."""
    # the axis least aligned with t seeds Gram-Schmidt (a one-hot row of
    # the identity, picked without a host sync)
    e = torch.nn.functional.one_hot(torch.argmin(torch.abs(t)), 3).to(t.dtype)
    b1 = e - torch.sum(e * t) * t
    b1 = b1 / torch.sqrt(torch.sum(b1 * b1))
    b2 = torch.linalg.cross(t, b1)
    return torch.stack([b1, b2], dim=-1)


def _sampson_signed(E, x1, x2):
    """Signed Sampson residual (K,), the least-squares objective; its
    absolute value is ``_sampson``."""
    Ex1 = x1 @ E.mT
    Etx2 = x2 @ E
    num = torch.sum(x2 * Ex1, dim=-1)
    den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
    return num / torch.sqrt(torch.clamp_min(den, 1e-12))


def _refine_pose_gn(R0, t0, x1, x2, w, iters: int):
    damp = 1e-10 * torch.eye(5, dtype=R0.dtype, device=R0.device)

    def residuals(theta, R, t):
        Rn = R @ _exp_so3(theta[:3])
        tn = t + _tangent_basis(t) @ theta[3:]
        tn = tn / torch.sqrt(torch.sum(tn * tn))
        return _sampson_signed(_skew(tn) @ Rn, x1, x2) * w

    R, t = R0, t0
    for _ in range(iters):
        z = torch.zeros((5,), dtype=R.dtype, device=R.device)
        r = residuals(z, R, t)
        J = torch.func.jacfwd(residuals)(z, R, t)  # (K, 5)
        H = J.mT @ J + damp
        g = J.mT @ r
        delta = -torch.linalg.solve_ex(H, g).result
        # accept only if the squared residual does not increase (plain GN
        # can overshoot near-degenerate inlier sets)
        r_new = residuals(delta, R, t)
        better = torch.sum(r_new * r_new) < torch.sum(r * r)
        delta = torch.where(better, delta, torch.zeros_like(delta))
        Rn = R @ _exp_so3(delta[:3])
        tn = t + _tangent_basis(t) @ delta[3:]
        R, t = Rn, tn / torch.sqrt(torch.sum(tn * tn))
    return R, t


def refine_pose(R, t, pts1, pts2, inliers=None, iters: int = 10, *, device=None):
    """Gauss-Newton local optimization of a calibrated relative pose (the LO
    in LO-RANSAC), float32.

    R/t: initial pose from ``recover_pose``; pts1/pts2: (K, 2) normalized
    correspondences; inliers: boolean (K,) support mask. Tensors stay on
    their device; host arrays go to the card unless ``device`` names
    another. Returns the refined (R, t (unit), E = [t]_x R).
    """
    dev = call_device(R, t, pts1, pts2, inliers, device=device)
    p1 = as_tensor(pts1, dev, torch.float32)
    p2 = as_tensor(pts2, dev, torch.float32)
    ones = torch.ones((p1.shape[0], 1), dtype=torch.float32, device=dev)
    x1 = torch.cat([p1, ones], -1)
    x2 = torch.cat([p2, ones], -1)
    w = ones[:, 0] if inliers is None else as_tensor(inliers, dev, torch.float32)
    R0 = as_tensor(R, dev, torch.float32)
    t0 = as_tensor(t, dev, torch.float32)
    with _ieee_f32_matmul():
        t0 = t0 / torch.sqrt(torch.sum(t0 * t0))
        Rn, tn = _refine_pose_gn(R0, t0, x1, x2, w, iters)
        return Rn, tn, _skew(tn) @ Rn


def _triangulate(P1, P2, p1, p2):
    """Batched DLT: P1/P2 (..., 3, 4), p1/p2 (K, 2) -> (..., K, 3)."""
    P1, P2 = torch.broadcast_tensors(P1[..., None, :, :], P2[..., None, :, :])  # (..., 1, 3, 4)
    rows = torch.stack([
        p1[:, 0:1] * P1[..., 2, :] - P1[..., 0, :],
        p1[:, 1:2] * P1[..., 2, :] - P1[..., 1, :],
        p2[:, 0:1] * P2[..., 2, :] - P2[..., 0, :],
        p2[:, 1:2] * P2[..., 2, :] - P2[..., 1, :],
    ], dim=-2)  # (..., K, 4, 4)
    _, _, vt = torch.linalg.svd(rows)
    X = vt[..., -1, :]
    # sign-PRESERVING scale guard: substituting +1e-12 for a tiny negative
    # X[3] would flip the point across the camera and could tip the
    # cheirality vote on low-parallax pairs
    w = X[..., 3]
    w = torch.where(torch.abs(w) > 1e-12, w, torch.where(w < 0, -1e-12, 1e-12).to(w.dtype))
    return X[..., :3] / w[..., None]


def triangulate(P1, P2, p1, p2, *, device=None) -> torch.Tensor:
    """Batched DLT triangulation, float32.

    P1/P2: (3, 4) projection matrices (normalized coords: [R | t]); p1/p2:
    (K, 2). Returns (K, 3) points in the camera-1 frame. Tensors stay on
    their device; host arrays go to the card unless ``device`` names
    another.
    """
    dev = call_device(P1, P2, p1, p2, device=device)
    f32 = torch.float32
    with _ieee_f32_matmul():
        return _triangulate(as_tensor(P1, dev, f32), as_tensor(P2, dev, f32),
                            as_tensor(p1, dev, f32), as_tensor(p2, dev, f32))


def recover_pose(E, p1, p2, inliers=None, *, device=None):
    """Decompose E into the (R, t) with the most points in front of both
    cameras (the first of equal counts). Tensors stay on their device; host
    arrays go to the card unless ``device`` names another.

    Returns (R (3, 3), t (3,), n_in_front). t has unit norm.
    """
    dev = call_device(E, p1, p2, inliers, device=device)
    E = as_tensor(E, dev)
    a = as_tensor(p1, dev, torch.float32)
    b = as_tensor(p2, dev, torch.float32)
    K = a.shape[0]
    mask = (torch.ones((K,), dtype=torch.bool, device=dev) if inliers is None
            else as_tensor(inliers, dev, torch.bool))
    with _ieee_f32_matmul():
        u, _, vt = torch.linalg.svd(E)
        # proper rotations
        u = u * torch.sign(torch.linalg.det(u))
        vt = vt * torch.sign(torch.linalg.det(vt))
        W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype).to(dev)
        Ra = u @ W @ vt
        Rb = u @ W.mT @ vt
        t = u[:, 2]
        Rs = torch.stack([Ra, Ra, Rb, Rb])
        ts = torch.stack([t, -t, t, -t])
        P1 = torch.eye(3, 4, dtype=torch.float32, device=dev)
        X = _triangulate(P1, torch.cat([Rs, ts[:, :, None]], dim=-1), a, b)  # (4, K, 3)
        z1 = X[..., 2]
        z2 = (X @ Rs.mT + ts[:, None, :])[..., 2]
        counts = torch.sum((z1 > 0) & (z2 > 0) & mask, dim=-1)
        best = torch.argmax(counts)  # the first of equal counts
        return _row(Rs, best), _row(ts, best), _row(counts, best)
