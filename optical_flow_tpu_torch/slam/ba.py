"""Bundle adjustment: Gauss-Newton with a Schur complement, on one device
(port of optical_flow_tpu/slam/ba.py).

Problem: cameras c = (axis-angle rotation r, translation t) in R^6, points
X in R^3, pinhole observations obs = (cam_idx, pt_idx, uv). Minimize
sum |pi(R_c X_p + t_c) - uv|^2 with pi(x, y, z) = f (x/z, y/z).

As in the JAX package:
- residuals and Jacobians of ALL observations in one batch:
  ``torch.func.jacfwd`` of ``project`` under ``torch.func.vmap``, as JAX
  takes ``jax.jacfwd`` under ``jax.vmap`` (both branches of
  ``_rodrigues``'s small-angle ``where`` are differentiated the same way);
- the normal equations assembled by ``index_add_`` (``segment_sum``):
  dense per-point 3x3 and per-camera 6x6 blocks;
- the point blocks eliminated per point (batched 3x3 eigendecompositions),
  and the REDUCED CAMERA SYSTEM S = Hcc - W Vinv W^T assembled over the
  track table (a static loop over the K track slots, O(P K^2)) and solved
  densely. W Vinv W^T is formed in each point's eigenbasis, where JAX
  forms W inv(V) W^T: the same value, without the roundoff that makes
  JAX's monocular solves chaotic (``_schur_reduce``).

Gauss-Newton with Levenberg damping and a fixed iteration count; camera 0
(and any ``fixed_cams``) is pinned inside the system. The solver runs in
the dtype of its inputs (float64 where the caller passes float64, as the
front end and ``WindowedBA`` do); float32 matmuls run without TF32.

On the card ``index_add_`` accumulates with atomics, so float64 sums come
in an order that may differ from run to run: the card is held to the CPU by
a tolerance, not by equality.

``sharded_bundle_adjust`` (points sharded over a mesh, the camera system
reduced across it) is not ported yet: it waits for the mesh over several
cards.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from optical_flow_tpu_torch.pipeline.preprocess import _ieee_f32_matmul
from optical_flow_tpu_torch.utils.device import as_tensor, call_device, host_array


class BAProblem(NamedTuple):
    cams: torch.Tensor  # (C, 6): axis-angle (3) + translation (3)
    points: torch.Tensor  # (P, 3)
    cam_idx: torch.Tensor  # (M,) integer
    pt_idx: torch.Tensor  # (M,) integer
    obs: torch.Tensor  # (M, 2) pixel observations
    focal: float = 1.0
    weight: Optional[torch.Tensor] = None  # (M,) optional per-observation weights
    # (M,) optional rectified-rig eye offsets: observation m was made by a
    # camera displaced baseline[m] along the host camera's +x axis (0 for
    # the host/left eye); residual = pi(R X + t - [b, 0, 0]) - uv.
    baseline: Optional[torch.Tensor] = None


def _problem_on(problem: BAProblem, device=None) -> BAProblem:
    """The problem's arrays as tensors on the call's device, each in its own
    dtype: tensors stay on their device, host arrays go to the card unless
    ``device`` names another."""
    dev = call_device(problem.cams, problem.points, problem.obs, device=device)
    return problem._replace(**{
        name: as_tensor(getattr(problem, name), dev)
        for name in ("cams", "points", "cam_idx", "pt_idx", "obs", "weight", "baseline")
        if getattr(problem, name) is not None
    })


def build_track_table(pt_idx, P: int, K: Optional[int] = None, valid=None) -> np.ndarray:
    """Host-side (numpy) observation table: (P, K) int32 of observation
    indices per point, in observation order, padded with -1. K defaults to
    the longest track.

    This is the sparsity structure of the W (camera-point) block: point p
    couples only the <= K cameras observing it, so the Schur complement
    assembles in O(P K^2).

    valid: optional (M,) bool; observations left out of the table
    (zero-weight padding rows, whose W blocks are exactly zero)."""
    pt = host_array(pt_idx).astype(np.int64)
    live = np.ones(len(pt), bool) if valid is None else host_array(valid).astype(bool)
    counts = np.bincount(pt[live], minlength=P)
    k_needed = int(counts.max()) if live.any() else 1
    if K is None:
        K = max(k_needed, 1)
    elif k_needed > K:
        raise ValueError(f"track length {k_needed} exceeds table width {K}")
    table = np.full((P, K), -1, np.int32)
    order = np.argsort(pt, kind="stable")
    order = order[live[order]]
    ps = pt[order]
    slot = np.arange(len(ps)) - np.searchsorted(ps, ps, side="left")  # rank within its point
    table[ps, slot] = order
    return table


def _hat(v):
    z = torch.zeros_like(v[0])
    return torch.stack([
        torch.stack([z, -v[2], v[1]]),
        torch.stack([v[2], z, -v[0]]),
        torch.stack([-v[1], v[0], z]),
    ])


def _rodrigues(r):
    """Axis-angle (3,) -> rotation matrix (3, 3), smooth at 0."""
    th2 = torch.sum(r * r)
    th = torch.sqrt(th2 + 1e-24)
    K = _hat(r / th)
    s, c = torch.sin(th), torch.cos(th)
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    R_big = eye + s * K + (1 - c) * (K @ K)
    R_small = eye + _hat(r)  # small-angle fallback: I + [r]x
    return torch.where(th2 > 1e-12, R_big, R_small)


def project(cam, X, focal, baseline=0.0):
    """Pinhole projection of one point by one camera; ``baseline`` shifts
    the eye along the camera's +x axis (a rectified rig's right eye). Batch
    it with ``torch.func.vmap``."""
    R = _rodrigues(cam[:3])
    xc = R @ X + cam[3:]
    z = torch.where(torch.abs(xc[2]) > 1e-9, xc[2], 1e-9)
    return focal * torch.stack([xc[0] - baseline, xc[1]]) / z


def _residual_jac(cam, X, uv, focal, baseline):
    """(r (2,), J_cam (2, 6), J_pt (2, 3)) by forward-mode differentiation
    of ``project``."""

    def res(c, x):
        return project(c, x, focal, baseline) - uv

    r = res(cam, X)
    Jc, Jp = torch.func.jacfwd(res, argnums=(0, 1))(cam, X)
    return r, Jc, Jp


def _baselines(problem: BAProblem):
    if problem.baseline is not None:
        return problem.baseline
    return torch.zeros(problem.obs.shape[:1], dtype=problem.obs.dtype, device=problem.obs.device)


def _focal(problem: BAProblem):
    return torch.full((), problem.focal, dtype=problem.points.dtype, device=problem.points.device)


def _segment_sum(data, ids, n: int):
    """``jax.ops.segment_sum``: rows of data summed into n segments."""
    out = torch.zeros((n,) + data.shape[1:], dtype=data.dtype, device=data.device)
    return out.index_add_(0, ids, data)


def _assemble(problem: BAProblem, C: int, P: int, table, residual_jac=None):
    """Per-observation residuals/Jacobians and block accumulations.

    table: (P, K) observation indices per point, -1-padded
    (``build_track_table``), the W block's sparsity structure. Padded slots
    carry zero W blocks and camera index 0, so they contribute exact zeros.

    residual_jac: override for the per-observation (r, J_cam, J_pt)
    function (a 9-DOF visual-inertial variant holds (C, 9) states in
    problem.cams); everything downstream is width-generic."""
    if residual_jac is None:
        residual_jac = _residual_jac
    r, Jc, Jp = torch.func.vmap(residual_jac, in_dims=(0, 0, 0, None, 0))(
        problem.cams[problem.cam_idx], problem.points[problem.pt_idx],
        problem.obs, _focal(problem), _baselines(problem),
    )
    if problem.weight is not None:
        w = problem.weight[:, None]
        r = r * w
        Jc = Jc * w[..., None]
        Jp = Jp * w[..., None]
    Hcc = _segment_sum(torch.einsum("mki,mkj->mij", Jc, Jc), problem.cam_idx, C)  # (C, 6, 6)
    Hpp = _segment_sum(torch.einsum("mki,mkj->mij", Jp, Jp), problem.pt_idx, P)  # (P, 3, 3)
    bc = _segment_sum(torch.einsum("mki,mk->mi", Jc, r), problem.cam_idx, C)
    bp = _segment_sum(torch.einsum("mki,mk->mi", Jp, r), problem.pt_idx, P)
    # W blocks gathered per (point, track slot): (P, K, 6, 3), memory
    # O(observations), never O(P C)
    Wm = torch.einsum("mki,mkj->mij", Jc, Jp)  # (M, 6, 3)
    mask = table >= 0
    tt = torch.where(mask, table, 0)
    Wp = Wm[tt] * mask[..., None, None]
    camT = torch.where(mask, problem.cam_idx[tt], 0)
    return Hcc, Hpp, bc, bp, Wp, camT, r


def _schur_reduce(Hpp, bp, Wp, camT, lam, C: int):
    """Reduced camera system of a point set.

    S_partial = - sum_p W_p Vinv_p W_p^T, assembled per track-slot pair
    (k, q) and scatter-added into camera blocks: O(P K^2) work. The camera
    block width D comes from Wp (..., D, 3).

    Each point block V = Hpp + lam I is inverted through its eigenvectors U,
    and W Vinv W^T formed as (W U) diag(1/ev) (W U)^T (the JAX package forms
    W inv(V) W^T). A point seen once has no depth but lam along its ray
    (ev ~ 1e-6 where the others are ~1e3): W is orthogonal to that ray, and
    only the projected form keeps the roundoff of the huge 1/ev out of S.
    Formed the other way, S is off by O(1e-2) and indefinite (measured
    eigenvalue -6e-3 at lam = 1e-6), so the scale gauge takes
    roundoff-sized steps: WindowedBA's monocular trajectory lands anywhere
    from 0.003 to 0.57 off the truth under 1e-15 relative changes of its
    input, and on the card it diverged. Projected, the same changes move
    it by 1e-9. Where V is well conditioned both forms agree to roundoff."""
    P, K = camT.shape
    D = Wp.shape[-2]
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    ev, U = torch.linalg.eigh(Hpp + lam * eye3[None])  # (P, 3), (P, 3, 3)
    Y = Wp @ U[:, None]  # (P, K, D, 3): W in V's eigenbasis
    Yd = Y / ev[:, None, None, :]  # W U diag(1/ev)
    S = torch.zeros((C * C, D, D), dtype=Hpp.dtype, device=Hpp.device)
    for k in range(K):  # static loop; K = the longest track
        contrib = -torch.einsum("pil,pqjl->pqij", Yd[:, k], Y)  # (P, K, D, D)
        seg = camT[:, k][:, None] * C + camT  # (P, K) flat camera-pair ids
        S = S + _segment_sum(contrib.reshape(P * K, D, D), seg.reshape(P * K), C * C)
    S = S.reshape(C, C, D, D).permute(0, 2, 1, 3)  # (C, D, C, D)
    Ub = torch.einsum("pji,pj->pi", U, bp)  # U^T bp
    rhs = _segment_sum(
        torch.einsum("pkil,pl->pki", Yd, Ub).reshape(P * K, D), camT.reshape(P * K), C,
    )  # (C, D): + W Vinv bp
    Vinv = (U / ev[:, None, :]) @ U.mT  # (P, 3, 3)
    return S, rhs, Vinv


def _solve_cameras(Hcc, bc, S_partial, rhs_partial, lam, fixed=None, fixed_dofs=None,
                   precondition=False):
    """Dense solve of the reduced camera system
    S = blockdiag(Hcc + lam I) - W Vinv W^T (the latter is S_partial).

    fixed: optional (C,) bool, cameras whose delta is held at 0; defaults to
    camera 0 only (the gauge anchor). fixed_dofs: optional (C*D,) bool
    overriding the per-camera mask with per-DOF pins.

    precondition: symmetric Jacobi scaling D^-1/2 S D^-1/2 before the
    solve, for float32 systems whose rows mix units with widely spread
    information weights."""
    C, D = Hcc.shape[0], Hcc.shape[-1]
    block = Hcc + lam * torch.eye(D, dtype=Hcc.dtype, device=Hcc.device)[None]
    S = S_partial.reshape(C, D, C, D).clone()
    c = torch.arange(C, device=Hcc.device)
    S[c, :, c, :] = S[c, :, c, :] + block
    S = S.reshape(C * D, C * D)
    rhs = (-bc + rhs_partial).reshape(C * D)
    # Gauge fix INSIDE the system: pinned cameras' rows/cols become the
    # identity, so the point back-substitution sees the pinned solution.
    if fixed_dofs is not None:
        free = ~fixed_dofs
    else:
        if fixed is None:
            fixed = c == 0
        free = torch.repeat_interleave(~fixed, D)  # (C D,) True where the solve is live
    keep = free[:, None] & free[None, :]
    S = torch.where(keep, S, 0.0)
    S = S + torch.diag(torch.where(free, 0.0, 1.0).to(S.dtype))
    rhs = torch.where(free, rhs, 0.0)
    if precondition:
        d = torch.sqrt(torch.clamp_min(torch.abs(torch.diagonal(S)), 1e-12))
        S = S / (d[:, None] * d[None, :])
        return (torch.linalg.solve_ex(S, rhs / d).result / d).reshape(C, D)
    return torch.linalg.solve_ex(S, rhs).result.reshape(C, D)


def _back_substitute(Vinv, Wp, camT, bp, delta_c):
    """Point updates given the camera updates."""
    corr = torch.einsum("pkij,pki->pj", Wp, delta_c[camT])  # (P, 3)
    return torch.einsum("pij,pj->pi", Vinv, -(bp + corr))


def _gn_step(problem: BAProblem, lam, C: int, P: int, table, fixed=None):
    Hcc, Hpp, bc, bp, Wp, camT, r = _assemble(problem, C, P, table)
    S_partial, rhs_partial, Vinv = _schur_reduce(Hpp, bp, Wp, camT, lam, C)
    delta_c = _solve_cameras(Hcc, bc, S_partial, rhs_partial, lam, fixed=fixed)
    delta_p = _back_substitute(Vinv, Wp, camT, bp, delta_c)
    cams = problem.cams + delta_c
    points = problem.points + delta_p
    return problem._replace(cams=cams, points=points), torch.mean(r * r)


def _huber_sqrt_weights(problem: BAProblem, delta):
    """IRLS sqrt-weights for the Huber loss at scale ``delta`` px: 1 inside
    the quadratic zone, sqrt(delta/r) beyond (``_assemble`` multiplies both
    the residual and the Jacobians by the weight, so the least-squares
    weight is its square)."""
    pred = torch.func.vmap(project, in_dims=(0, 0, None, 0))(
        problem.cams[problem.cam_idx], problem.points[problem.pt_idx], _focal(problem),
        _baselines(problem),
    )
    rn = torch.sqrt(torch.sum((pred - problem.obs) ** 2, dim=-1))
    return torch.sqrt(torch.clamp_max(delta / torch.clamp_min(rn, 1e-12), 1.0))


def bundle_adjust(
    problem: BAProblem,
    iters: int = 10,
    lam: float = 1e-3,
    fixed_cams=None,
    robust_delta=None,
    *,
    device=None,
) -> Tuple[BAProblem, torch.Tensor]:
    """Gauss-Newton BA; returns (refined problem, per-iteration mean squared
    residual (iters,)).

    The problem's tensors stay on their device; host arrays go to the card
    unless ``device`` names another. The observation table (W-block
    sparsity) is built on the host from pt_idx.

    fixed_cams: optional (C,) bool mask of cameras held constant (windowed
    BA); camera 0 is always pinned as the gauge anchor.

    robust_delta: optional Huber scale in PIXELS: observations whose
    reprojection error exceeds it are IRLS-downweighted by delta/r each
    iteration, so gross mismatches cannot drag the solution."""
    problem = _problem_on(problem, device)
    dev = problem.points.device
    dtype = problem.points.dtype
    P = problem.points.shape[0]
    C = problem.cams.shape[0]
    valid = None if problem.weight is None else host_array(problem.weight) > 0
    table = torch.from_numpy(build_track_table(problem.pt_idx, P, valid=valid)).to(dev)
    fixed = torch.arange(C, device=dev) == 0
    if fixed_cams is not None:
        fixed = fixed | as_tensor(fixed_cams, dev, torch.bool)
    lam = torch.full((), lam, dtype=dtype, device=dev)
    robust = robust_delta is not None
    if robust and problem.weight is None:
        problem = problem._replace(
            weight=torch.ones(problem.obs.shape[:1], dtype=problem.obs.dtype, device=dev))
    delta = torch.full((), robust_delta, dtype=dtype, device=dev) if robust else None
    base_w = problem.weight
    hist = []
    with _ieee_f32_matmul():
        for _ in range(iters):
            prob = problem
            if robust:
                # IRLS: reweight at the CURRENT estimate each iteration, from
                # the caller's base weights (padding zeros stay zero)
                prob = prob._replace(weight=base_w * _huber_sqrt_weights(prob, delta))
            prob, msr = _gn_step(prob, lam, C, P, table, fixed=fixed)
            problem = prob._replace(weight=base_w)
            hist.append(msr)
    return problem, (torch.stack(hist) if hist else torch.zeros((0,), dtype=dtype, device=dev))


def reprojection_rmse(problem: BAProblem, *, device=None) -> torch.Tensor:
    """RMS pixel reprojection error; zero-weight (padding) observations are
    left out of the mean. Tensors stay on their device; host arrays go to
    the card unless ``device`` names another."""
    problem = _problem_on(problem, device)
    pred = torch.func.vmap(project, in_dims=(0, 0, None, 0))(
        problem.cams[problem.cam_idx], problem.points[problem.pt_idx], _focal(problem),
        _baselines(problem),
    )
    sq = torch.sum((pred - problem.obs) ** 2, dim=-1)
    if problem.weight is None:
        return torch.sqrt(torch.mean(sq))
    live = (problem.weight > 0).to(sq.dtype)
    return torch.sqrt(torch.sum(sq * live) / torch.clamp_min(torch.sum(live), 1))
