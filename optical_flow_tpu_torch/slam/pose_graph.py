"""Pose-graph optimization, loop-closure detection and relocalization (port
of optical_flow_tpu/slam/pose_graph.py).

Keyframe poses are nodes; relative-pose measurements (odometry, and loop
closures from place recognition plus geometric verification) are edges.
Gauss-Newton with the first pose fixed distributes the accumulated drift
around every cycle, over SE(3) (``PoseGraph``) or over similarities
(``Sim3PoseGraph``, which also corrects monocular scale drift).

Pose convention: T_i = (R_i, t_i) maps WORLD -> CAMERA i (X_c = R X_w + t),
as ``epipolar.recover_pose`` and ``pnp_dlt``. An edge (i, j) measures
T_ij = T_j * T_i^{-1} (camera-j-from-camera-i).

Differences from the JAX package, none in what is computed:
- both Gauss-Newton loops run in float64 (JAX: float32) on the call's
  device: the Jacobian is ``torch.func.jacfwd`` of the stacked residuals,
  the step a dense solve of the damped normal equations, and a step is
  kept only if it lowers the residual sum (one ``torch.where``, no host
  sync). Results come back as float32 numpy, as JAX returns them. Where
  the two sums of a step are nearly equal, float32 and float64 can keep
  different steps; the tests compare the optimized poses at a stated
  tolerance;
- ``jax.image.resize(..., "linear")`` (an antialiasing triangle filter on
  downsampling) is two matmuls with the weight matrices JAX's
  ``scale_and_translate`` builds (``_resize_weights``), and
  ``map_coordinates(order=1, mode="nearest")`` is written out as a
  bilinear gather with clamped taps (``_bilinear_nearest``);
- ``umeyama_alignment`` runs in float64 numpy on the host (JAX: one
  float32 SVD on its device).

Entry points that take images (``thumbnail_descriptor``,
``place_descriptor``, ``verify_loop_closure``, ``relocalize``,
``measure_loop_sim3``) and the graphs' ``optimize`` run on the call's
device: tensors stay on theirs, host arrays go to the card unless
``device`` names another. Their results are host numpy, as in JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from optical_flow_tpu_torch.pipeline.preprocess import _ieee_f32_matmul
from optical_flow_tpu_torch.slam.epipolar import _exp_so3
from optical_flow_tpu_torch.utils.device import as_tensor, call_device, host_array

_exp_so3_batch = torch.func.vmap(_exp_so3)


def _log_so3(R: torch.Tensor) -> torch.Tensor:
    """Axis-angle of rotation matrices (..., 3, 3) -> (..., 3), value- and
    gradient-safe at the identity, where every graph residual lives (an
    arccos(trace) form has an infinite derivative there). Like every
    skew-part formula it degrades as theta -> pi."""
    v = 0.5 * torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )  # sin(theta) * axis
    c = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5, -1.0, 1.0)
    s = torch.sqrt(torch.sum(v * v, dim=-1) + 1e-12)  # floored: theta/s -> 1 at identity
    return v * (torch.atan2(s, c) / s)[..., None]


def relative_pose(Ri, ti, Rj, tj):
    """T_j * T_i^{-1}: the pose of camera j relative to camera i (host
    float32)."""
    Ri, ti, Rj, tj = (host_array(a).astype(np.float32) for a in (Ri, ti, Rj, tj))
    R = Rj @ Ri.T
    t = tj - R @ ti
    return R, t


def _edge_residuals(Rs, ts, ei, ej, Rm, tm):
    Ri, ti = Rs[ei], ts[ei]
    Rj, tj = Rs[ej], ts[ej]
    Rrel = Rj @ Ri.mT
    trel = tj - (Rrel @ ti[..., None])[..., 0]
    Re = Rm.mT @ Rrel
    te = (Rm.mT @ (trel - tm)[..., None])[..., 0]
    return torch.cat([_log_so3(Re), te], dim=-1)  # (E, 6)


def _gauss_newton(residuals, apply, state, n_free: int, iters: int):
    """`iters` damped Gauss-Newton steps on the flat parameter vector of
    size n_free (left perturbations of every pose but the first); a step is
    kept only where it lowers the residual sum."""
    ref = state[-1]
    eye = torch.eye(n_free, dtype=ref.dtype, device=ref.device)
    for _ in range(iters):
        z = torch.zeros((n_free,), dtype=ref.dtype, device=ref.device)
        r = residuals(z, *state)
        J = torch.func.jacfwd(residuals)(z, *state)
        H = J.mT @ J + 1e-8 * eye
        delta = -torch.linalg.solve_ex(H, J.mT @ r).result
        r_new = residuals(delta, *state)
        ok = torch.sum(r_new * r_new) < torch.sum(r * r)
        delta = torch.where(ok, delta, torch.zeros_like(delta))
        state = apply(delta, *state)
    return state


def _optimize_pose_graph(Rs, ts, ei, ej, Rm, tm, wt, iters: int):
    N = Rs.shape[0]

    def apply(theta, Rs, ts):
        delta = torch.cat([theta.new_zeros((1, 6)), theta.reshape(-1, 6)])
        dR = _exp_so3_batch(delta[:, :3])
        return dR @ Rs, (dR @ ts[..., None])[..., 0] + delta[:, 3:]

    def residuals(theta, Rs, ts):
        Rn, tn = apply(theta, Rs, ts)
        return (_edge_residuals(Rn, tn, ei, ej, Rm, tm) * wt[:, None]).reshape(-1)

    return _gauss_newton(residuals, apply, (Rs, ts), (N - 1) * 6, iters)


def _f64(x, dev):
    return torch.from_numpy(np.asarray(x, np.float64)).to(dev)


def _idx(x, dev):
    return torch.from_numpy(np.asarray(x, np.int64)).to(dev)


@dataclasses.dataclass
class PoseGraph:
    """Nodes: (N, 3, 3) rotations + (N, 3) translations (world->cam).
    Edges: index lists + measured relative poses + scalar weights."""

    Rs: np.ndarray
    ts: np.ndarray
    ei: List[int] = dataclasses.field(default_factory=list)
    ej: List[int] = dataclasses.field(default_factory=list)
    Rm: List[np.ndarray] = dataclasses.field(default_factory=list)
    tm: List[np.ndarray] = dataclasses.field(default_factory=list)
    wt: List[float] = dataclasses.field(default_factory=list)

    def add_edge(self, i: int, j: int, R_ij, t_ij, weight: float = 1.0):
        self.ei.append(int(i))
        self.ej.append(int(j))
        self.Rm.append(host_array(R_ij).astype(np.float32))
        self.tm.append(host_array(t_ij).astype(np.float32))
        self.wt.append(float(weight))

    @staticmethod
    def from_odometry(Rs, ts, weight: float = 1.0) -> "PoseGraph":
        """Chain graph: consecutive relative poses measured from the given
        (possibly drifted) trajectory itself."""
        Rs = host_array(Rs).astype(np.float32)
        ts = host_array(ts).astype(np.float32)
        g = PoseGraph(Rs=Rs.copy(), ts=ts.copy())
        for i in range(len(Rs) - 1):
            R_ij, t_ij = relative_pose(Rs[i], ts[i], Rs[i + 1], ts[i + 1])
            g.add_edge(i, i + 1, R_ij, t_ij, weight)
        return g

    def optimize(self, iters: int = 12, *, device=None) -> Tuple[np.ndarray, np.ndarray]:
        """Gauss-Newton in float64 on the call's device (the card unless
        ``device`` names another); returns optimized float32 (Rs, ts).
        Pose 0 is the gauge."""
        if not self.ei:
            return self.Rs.copy(), self.ts.copy()
        dev = call_device(device=device)
        Rn, tn = _optimize_pose_graph(
            _f64(self.Rs, dev), _f64(self.ts, dev), _idx(self.ei, dev), _idx(self.ej, dev),
            _f64(np.stack(self.Rm), dev), _f64(np.stack(self.tm), dev), _f64(self.wt, dev),
            iters,
        )
        return host_array(Rn).astype(np.float32), host_array(tn).astype(np.float32)

    def residual_norms(self, *, device=None) -> np.ndarray:
        """Per-edge residual magnitudes (se3 norm) at the current poses."""
        if not self.Rm:
            return np.zeros((0,), np.float32)
        dev = call_device(device=device)
        f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)  # noqa: E731
        r = _edge_residuals(f32(self.Rs), f32(self.ts), _idx(self.ei, dev), _idx(self.ej, dev),
                            f32(np.stack(self.Rm)), f32(np.stack(self.tm)))
        return host_array(torch.linalg.norm(r, dim=-1))


# ------------------------------------------------------------ place index


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of ``jax.image.resize(..., "linear")``
    along one axis (``scale_and_translate``'s ``compute_weight_mat``: a
    triangle kernel widened by 1/scale when downsampling, columns
    normalized, samples outside the input zeroed), built in float64."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def _resize_linear(x: torch.Tensor, size: int) -> torch.Tensor:
    """(H, W) float32 -> (size, size), as ``jax.image.resize(x, (size,
    size), "linear")``: an axis whose length does not change is left as it
    is."""
    H, W = x.shape
    with _ieee_f32_matmul():
        if H != size:
            x = torch.from_numpy(_resize_weights(H, size)).to(x.device).mT @ x
        if W != size:
            x = x @ torch.from_numpy(_resize_weights(W, size)).to(x.device)
    return x


def thumbnail_descriptor(img, size: int = 16, *, device=None) -> np.ndarray:
    """Tiny normalized-intensity global descriptor (zero mean, unit norm)
    for loop-closure candidate proposal: nearby viewpoints of the same
    place correlate strongly at 16x16."""
    dev = call_device(img, device=device)
    d = _resize_linear(as_tensor(img, dev, torch.float32), size).reshape(-1)
    d = d - torch.mean(d)
    n = torch.linalg.norm(d)
    return host_array(d / torch.clamp_min(n, 1e-9))


def _bilinear_nearest(F: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    """``map_coordinates(F, [yy, xx], order=1, mode="nearest")``: bilinear
    taps at floor and floor + 1 along each axis, each tap index clamped to
    the array, the four products summed in JAX's order."""
    H, W = F.shape
    y0, x0 = torch.floor(yy), torch.floor(xx)
    wy1, wx1 = yy - y0, xx - x0
    wy0, wx0 = 1 - wy1, 1 - wx1
    iy0, ix0 = y0.to(torch.int64), x0.to(torch.int64)
    iy = [iy0.clamp(0, H - 1), (iy0 + 1).clamp(0, H - 1)]
    ix = [ix0.clamp(0, W - 1), (ix0 + 1).clamp(0, W - 1)]
    out = None
    for a, wy in enumerate((wy0, wy1)):
        for b, wx in enumerate((wx0, wx1)):
            term = (wy * wx) * F[iy[a], ix[b]]
            out = term if out is None else out + term
    return out


def _fourier_mellin(x: torch.Tensor, size: int, n_rho: int, n_theta: int) -> torch.Tensor:
    x = _resize_linear(x, size)
    x = x - torch.mean(x)
    # a Hann window keeps the border discontinuity out of the spectrum
    n = torch.arange(size, dtype=torch.float32, device=x.device)
    hann = 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / (size - 1))
    x = x * hann[:, None] * hann[None, :]
    F = torch.abs(torch.fft.fftshift(torch.fft.fft2(x)))
    # log-polar resample of the upper half-plane: rotation -> shift along
    # theta, scale -> shift along log-rho
    c = size / 2.0
    rho = torch.exp(torch.linspace(math.log(2.0), math.log(c * 0.9), n_rho,
                                   dtype=torch.float32, device=x.device))
    th = torch.arange(n_theta, dtype=torch.float32, device=x.device) * (math.pi / n_theta)
    yy = c + rho[:, None] * torch.sin(th)[None, :]
    xx = c + rho[:, None] * torch.cos(th)[None, :]
    L = torch.log1p(_bilinear_nearest(F, yy, xx))
    L = L - torch.mean(L)
    # a second |FFT|: the rotation/scale shifts become phase, discarded
    M = torch.abs(torch.fft.fft2(L))
    # low frequencies carry the place identity
    M = torch.cat([M[:6], M[-5:]], dim=0)
    M = torch.cat([M[:, :8], M[:, -7:]], dim=1)
    v = M.reshape(-1)
    return v / torch.clamp_min(torch.linalg.norm(v), 1e-9)


def place_descriptor(img, size: int = 64, n_rho: int = 24, n_theta: int = 32, *,
                     device=None) -> np.ndarray:
    """Global place-recognition descriptor tolerant to in-plane rotation,
    scale, translation and brightness/contrast (Fourier-Mellin): |FFT| is
    translation invariant, its log-polar resampling turns rotation and
    scale into shifts, and a second |FFT| makes those invariant too."""
    dev = call_device(img, device=device)
    return host_array(_fourier_mellin(as_tensor(img, dev, torch.float32), size, n_rho, n_theta))


def propose_loop_candidates(
    descriptors, min_separation: int = 10, max_candidates: int = 5
) -> List[Tuple[int, int, float]]:
    """(i, j, distance) pairs with |i - j| >= min_separation, closest
    first: candidates for geometric verification."""
    D = np.stack([host_array(d) for d in descriptors])
    N = len(D)
    dist = np.linalg.norm(D[:, None, :] - D[None, :, :], axis=-1)
    ii, jj = np.triu_indices(N, k=min_separation)
    if len(ii) == 0:
        return []
    order = np.argsort(dist[ii, jj])[:max_candidates]
    return [(int(ii[k]), int(jj[k]), float(dist[ii[k], jj[k]])) for k in order]


def verify_loop_closure(
    img_i, img_j, focal: float, cx: float, cy: float, *,
    min_inliers: int = 30, max_corners: int = 300, device=None,
) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """Geometric verification of a loop candidate: corners on img_i,
    sparse-LK matches into img_j (kernel K2 builds both pyramids on the
    card), 5-point essential RANSAC and LO pose refinement. Returns (R_ij,
    t_ij (unit), n_inliers), camera-j-from-camera-i with unobservable
    translation scale, or None if support is too weak."""
    from optical_flow_tpu_torch.slam.epipolar import (
        estimate_essential,
        normalize_pixels,
        ransac_essential_5pt,
        recover_pose,
        refine_pose,
    )
    from optical_flow_tpu_torch.track import good_features_to_track, track_features

    dev = call_device(img_i, img_j, device=device)
    img_i = as_tensor(img_i, dev, torch.float32)
    img_j = as_tensor(img_j, dev, torch.float32)
    pts, valid = good_features_to_track(img_i, max_corners, 0.01, 8)
    new, status, _ = track_features(img_i, img_j, pts)
    ok = valid & status
    if int(ok.sum()) < 8:
        return None
    p1 = normalize_pixels(pts, focal, cx, cy)
    p2 = normalize_pixels(new, focal, cx, cy)
    try:
        E, inl, count = ransac_essential_5pt(p1, p2, valid=ok)
    except (RuntimeError, np.linalg.LinAlgError):
        # every minimal sample degenerate, or an eig blow-up: the 8-point
        # batch is the fallback
        E, inl, count = estimate_essential(p1, p2, valid=ok)
    if int(count) < min_inliers:
        return None
    R0, t0, _ = recover_pose(E, p1[inl], p2[inl])
    R1, t1, _ = refine_pose(R0, t0, p1, p2, inliers=inl)
    return host_array(R1), host_array(t1), int(count)


# ----------------------------------------------------------- relocalization


def relocalize(
    frame, keyframes, kf_tracks, points, focal: float, cx: float, cy: float, *,
    min_inliers: int = 20, device=None,
) -> Optional[Tuple[np.ndarray, np.ndarray, int, int]]:
    """Recover the pose of a lost frame against an existing map: the
    closest keyframe by thumbnail descriptor, its observations of the map
    points (kf_tracks[k]: (P, 2) pixels) sparse-LK-tracked into the frame,
    robust PnP against the (P, 3) world points. Returns (R, t,
    keyframe_index, n_inliers), world->camera, or None when tracking or PnP
    support is too weak."""
    from optical_flow_tpu_torch.slam.epipolar import normalize_pixels
    from optical_flow_tpu_torch.slam.pnp import pnp_ransac
    from optical_flow_tpu_torch.track import track_features

    dev = call_device(frame, *keyframes, device=device)
    frame = as_tensor(frame, dev, torch.float32)
    d = thumbnail_descriptor(frame)
    dists = [float(np.linalg.norm(thumbnail_descriptor(as_tensor(k, dev)) - d))
             for k in keyframes]
    best = int(np.argmin(dists))
    new, status, _ = track_features(as_tensor(keyframes[best], dev, torch.float32), frame,
                                    as_tensor(kf_tracks[best], dev, torch.float32))
    if int(status.sum()) < 6:
        return None
    xn = normalize_pixels(new, focal, cx, cy)
    R, t, inl = pnp_ransac(as_tensor(points, dev, torch.float32), xn, valid=status)
    n = int(inl.sum())
    if n < min_inliers:
        return None
    return host_array(R), host_array(t), best, n


# ------------------------------------------------------------- Sim(3) graph
#
# Monocular SLAM accumulates SCALE drift that an SE(3) graph cannot express.
# The Sim(3) graph optimizes similarities S = (s, R, t), X_cam = s R X_w + t,
# with per-edge residuals [log_so3(Re), te, log(se)] of E = Sm^-1 * Sj * Si^-1
# (Strasdat's ScaViSLAM formulation): they vanish iff the constraint holds and
# have full-rank Jacobians, which is all Gauss-Newton needs.


def sim3_compose(a, b):
    """(s, R, t) of A∘B (apply B first): X -> sa Ra (sb Rb X + tb) + ta."""
    sa, Ra, ta = a
    sb, Rb, tb = b
    return (sa * sb, Ra @ Rb, sa * (Ra @ tb) + ta)


def sim3_inverse(a):
    s, R, t = a
    return (1.0 / s, R.T, -(R.T @ t) / s)


def _sim3_edge_residuals(ss, Rs, ts, ei, ej, sm, Rm, tm):
    si, Ri, ti = ss[ei], Rs[ei], ts[ei]
    sj, Rj, tj = ss[ej], Rs[ej], ts[ej]
    # Sj * Si^-1 = (sj/si, Rj Ri^T, tj - (sj/si) Rj Ri^T ti)
    srel = sj / si
    Rrel = Rj @ Ri.mT
    trel = tj - srel[:, None] * (Rrel @ ti[..., None])[..., 0]
    # Sm^-1 * rel = (srel/sm, Rm^T Rrel, Rm^T (trel - tm) / sm)
    se = srel / sm
    Re = Rm.mT @ Rrel
    te = (Rm.mT @ (trel - tm)[..., None])[..., 0] / sm[:, None]
    return torch.cat([_log_so3(Re), te, torch.log(se)[:, None]], dim=-1)  # (E, 7)


def _optimize_sim3_graph(ss, Rs, ts, ei, ej, sm, Rm, tm, wt, iters: int):
    N = Rs.shape[0]

    def apply(theta, ss, Rs, ts):
        # left perturbation: S_i <- (e^sigma_i, Exp(w_i), delta_i) ∘ S_i
        d = torch.cat([theta.new_zeros((1, 7)), theta.reshape(-1, 7)])
        dR = _exp_so3_batch(d[:, :3])
        es = torch.exp(d[:, 6])
        return es * ss, dR @ Rs, es[:, None] * (dR @ ts[..., None])[..., 0] + d[:, 3:6]

    def residuals(theta, ss, Rs, ts):
        s2, R2, t2 = apply(theta, ss, Rs, ts)
        r = _sim3_edge_residuals(s2, R2, t2, ei, ej, sm, Rm, tm)
        return (r * wt[:, None]).reshape(-1)

    return _gauss_newton(residuals, apply, (ss, Rs, ts), (N - 1) * 7, iters)


@dataclasses.dataclass
class Sim3PoseGraph:
    """Pose graph over similarity transforms (s, R, t); node 0 is the gauge
    (it fixes the global scale as well as the frame)."""

    ss: np.ndarray  # (N,)
    Rs: np.ndarray  # (N, 3, 3)
    ts: np.ndarray  # (N, 3)
    ei: List[int] = dataclasses.field(default_factory=list)
    ej: List[int] = dataclasses.field(default_factory=list)
    sm: List[float] = dataclasses.field(default_factory=list)
    Rm: List[np.ndarray] = dataclasses.field(default_factory=list)
    tm: List[np.ndarray] = dataclasses.field(default_factory=list)
    wt: List[float] = dataclasses.field(default_factory=list)

    def add_edge(self, i, j, s_ij, R_ij, t_ij, weight: float = 1.0):
        self.ei.append(int(i))
        self.ej.append(int(j))
        self.sm.append(float(s_ij))
        self.Rm.append(host_array(R_ij).astype(np.float32))
        self.tm.append(host_array(t_ij).astype(np.float32))
        self.wt.append(float(weight))

    @staticmethod
    def from_se3_odometry(Rs, ts) -> "Sim3PoseGraph":
        """Start from an SE(3) trajectory (all scales 1) with chain edges
        measured from the trajectory itself."""
        Rs = host_array(Rs).astype(np.float32)
        ts = host_array(ts).astype(np.float32)
        g = Sim3PoseGraph(ss=np.ones(len(Rs), np.float32), Rs=Rs.copy(), ts=ts.copy())
        for i in range(len(Rs) - 1):
            R_ij, t_ij = relative_pose(Rs[i], ts[i], Rs[i + 1], ts[i + 1])
            g.add_edge(i, i + 1, 1.0, R_ij, t_ij)
        return g

    def optimize(self, iters: int = 15, *, device=None):
        """Gauss-Newton in float64 on the call's device (the card unless
        ``device`` names another); returns float32 (ss, Rs, ts), pose 0
        fixed."""
        if not self.ei:
            return self.ss.copy(), self.Rs.copy(), self.ts.copy()
        dev = call_device(device=device)
        # the measured scales pass through float32, as JAX stores them
        sm = np.asarray(self.sm, np.float32)
        ss, Rs, ts = _optimize_sim3_graph(
            _f64(self.ss, dev), _f64(self.Rs, dev), _f64(self.ts, dev),
            _idx(self.ei, dev), _idx(self.ej, dev), _f64(sm, dev),
            _f64(np.stack(self.Rm), dev), _f64(np.stack(self.tm), dev),
            _f64(np.asarray(self.wt, np.float32), dev), iters,
        )
        return tuple(host_array(x).astype(np.float32) for x in (ss, Rs, ts))

    def centers(self, ss=None, Rs=None, ts=None) -> np.ndarray:
        """Camera centers in the world frame: -(1/s) R^T t."""
        ss = self.ss if ss is None else ss
        Rs = self.Rs if Rs is None else Rs
        ts = self.ts if ts is None else ts
        return np.stack([-(R.T @ t) / s for s, R, t in zip(ss, Rs, ts)])


def umeyama_alignment(X, Y, w=None):
    """Least-squares similarity between matched 3D point sets (Umeyama
    1991): (s, R, t) minimizing sum w ||(s R X + t) - Y||^2, in float64 on
    the host (R and t returned as float32). w: optional (K,) weights."""
    X = host_array(X).astype(np.float32).astype(np.float64)
    Y = host_array(Y).astype(np.float32).astype(np.float64)
    K = X.shape[0]
    w = np.ones(K) if w is None else host_array(w).astype(np.float32).astype(np.float64)
    wsum = max(float(np.sum(w)), 1e-9)
    mx = np.sum(X * w[:, None], axis=0) / wsum
    my = np.sum(Y * w[:, None], axis=0) / wsum
    Xc, Yc = X - mx, Y - my
    cov = (Yc * w[:, None]).T @ Xc / wsum
    U, D, Vt = np.linalg.svd(cov)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U) * np.linalg.det(Vt))])
    R = U @ S @ Vt
    var_x = np.sum(w[:, None] * Xc * Xc) / wsum
    s = np.sum(D * np.diag(S)) / max(var_x, 1e-12)
    t = my - s * (R @ mx)
    return float(s), R.astype(np.float32), t.astype(np.float32)


def measure_loop_sim3(
    img_i, img_j, obs_i, obs_j, points, R_i, t_i, R_j, t_j, *,
    min_support: int = 12, max_scale: float = 4.0, device=None,
) -> Optional[Tuple[float, np.ndarray, np.ndarray, int]]:
    """Measure a loop edge as a full similarity S_ji = (s, R, t), X_j = s R
    X_i + t, mapping keyframe i's local-map coordinates to keyframe j's.

    Keyframe i's landmark pixels (``obs_i``: [(pid, absolute pixel)]) are
    sparse-LK-tracked into frame j, each tracked position is associated
    one-to-one with keyframe j's nearest landmark observation (``obs_j``)
    within 3 px, and the two local point clouds are aligned by a trimmed
    Umeyama fit. No triangulation is involved, so the measurement holds at
    an exact revisit (zero i-j baseline). Returns (s, R, t, n_support) or
    None when support is too weak or the scale implausible (> max_scale
    drift)."""
    from optical_flow_tpu_torch.track import track_features

    match_radius = 3.0  # px: corner re-detection jitter at the revisit

    A = [(p, px) for p, px in obs_i if p in points]
    B = [(p, px) for p, px in obs_j if p in points]
    if len(A) < min_support or len(B) < min_support:
        return None
    R_i, t_i = host_array(R_i).astype(np.float64), host_array(t_i).astype(np.float64)
    R_j, t_j = host_array(R_j).astype(np.float64), host_array(t_j).astype(np.float64)

    # i's landmarks carried into frame j by LK
    dev = call_device(img_i, img_j, device=device)
    a_px = np.asarray([host_array(px) for _, px in A], np.float32)
    a_j, sa, _ = track_features(as_tensor(img_i, dev, torch.float32),
                                as_tensor(img_j, dev, torch.float32), a_px)
    a_j = host_array(a_j).astype(np.float32)
    sa = host_array(sa)
    if sa.sum() < min_support:
        return None

    # greedy nearest-neighbour association, one-to-one, gated at match_radius
    b_px = np.asarray([host_array(px) for _, px in B], np.float32)
    d = np.linalg.norm(a_j[:, None, :] - b_px[None, :, :], axis=-1)
    d[~sa] = np.inf
    pairs = []
    used_b = np.zeros(len(B), bool)
    for ai in np.argsort(d.min(axis=1)):
        row = np.where(used_b, np.inf, d[ai])
        bi = int(np.argmin(row))
        # gate on the MASKED distance: once every B is used the row is all
        # inf and argmin degenerates to 0
        if row[bi] <= match_radius:
            used_b[bi] = True
            pairs.append((ai, bi))
    if len(pairs) < min_support:
        return None
    ia = np.asarray([a for a, _ in pairs])
    ib = np.asarray([b for _, b in pairs])

    Xa = np.stack([points[A[a][0]] for a in ia])
    Xb = np.stack([points[B[b][0]] for b in ib])
    X_i_loc = Xa @ R_i.T + t_i  # i's local map, i's scale
    X_j_loc = Xb @ R_j.T + t_j  # j's local map, j's scale
    w = (X_i_loc[:, 2] > 0.1) & (X_j_loc[:, 2] > 0.1)
    if w.sum() < min_support:
        return None
    # trimmed Umeyama: align, drop residuals beyond 2.5x the median, re-align
    s, R, t = umeyama_alignment(X_i_loc, X_j_loc, w.astype(np.float32))
    r = np.linalg.norm(s * (X_i_loc @ R.T) + t - X_j_loc, axis=1)
    med = np.median(r[w])
    w2 = w & (r <= 2.5 * max(med, 1e-9))
    if w2.sum() < min_support:
        return None
    s, R, t = umeyama_alignment(X_i_loc, X_j_loc, w2.astype(np.float32))
    if not (1.0 / max_scale < s < max_scale):
        return None
    return float(s), R, t, int(w2.sum())
