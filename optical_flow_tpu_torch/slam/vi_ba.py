"""Tightly-coupled visual-inertial bundle adjustment on one device (port of
optical_flow_tpu/slam/vi_ba.py).

The preintegrated IMU deltas of ``slam/imu.py`` become factors inside
bundle adjustment, refined jointly with the reprojection residuals. State
per keyframe is 9-DOF, the axis-angle rotation r and translation t of the
world->cam pose (as in ``ba.BAProblem``) plus the world-frame velocity v,
or 15-DOF with per-keyframe bias deltas (dbg, dba) relative to the
preintegration's linearization point: first-order bias corrections of the
deltas and between-keyframe random-walk factors, so biases may drift on
long logs. Gravity is a known constant (from ``visual_inertial_alignment*``).
Between keyframes i -> i+1 the factor has 9 residuals:

    r_R = Log(dR_i^T  R_i R_{i+1}^T)                       (body frame)
    r_v = R_i (v_{i+1} - v_i - g T_i)            - dv_i
    r_p = R_i (c_{i+1} - c_i - v_i T_i - g T_i^2/2) - dp_i

with R_i the world->cam rotation, c_i = -R_i^T t_i the camera centre and
body == camera. Each block is scaled by an information weight (1/sigma)
against pixel-unit reprojection residuals.

The structure of ``slam/ba.py``: the reprojection Jacobians of all
observations in one ``torch.func.vmap`` batch at width 6 (vision never
sees velocities or biases), the points eliminated by the port's eigenbasis
Schur complement (``ba._schur_reduce``), and the IMU factors, which never
touch points, added to the REDUCED camera system as (i, i), (i, i+1),
(i+1, i), (i+1, i+1) blocks of the dense (C D)^2 solve, Jacobi-
preconditioned (``ba._solve_cameras(..., precondition=True)``): its rows
mix pixels, rad, m/s and m. Gauss-Newton with Levenberg damping and a fixed
iteration count, in the dtype of the inputs; float32 matmuls run without
TF32. A uniformly rescaled monocular solution has the same reprojection
residuals but violates the metric deltas, so VI-BA pulls the map back to
metric scale.

Gauge: keyframe 0's POSE is pinned; its velocity stays live.

``sharded_vi_bundle_adjust`` shards the points and observations over a
mesh as ``ba.sharded_bundle_adjust`` does: the visual camera system is
summed across the mesh at width 6, and the IMU factors, whose inputs are
replicated, are added once after the sum (summing them would count them
once a shard).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from optical_flow_tpu_torch.parallel.mesh import FlowMesh, gather_slots
from optical_flow_tpu_torch.pipeline.preprocess import _ieee_f32_matmul
from optical_flow_tpu_torch.slam.ba import (
    BAProblem,
    _assemble,
    _back_substitute,
    _huber_sqrt_weights,
    _problem_on,
    _rodrigues,
    _schur_reduce,
    _segment_sum,
    _solve_cameras,
    build_track_table,
    check_shardable,
    mesh_reduce,
    shard_rows,
    shard_tables,
)
from optical_flow_tpu_torch.slam.frontend import _rotmat_to_axis_angle
from optical_flow_tpu_torch.slam.imu import (
    _exp_so3,
    _log_so3,
    preintegrate,
    preintegrate_with_bias_jacobians,
    visual_inertial_alignment_with_bias,
)
from optical_flow_tpu_torch.utils.device import as_tensor, call_device, host_array


class VIBAProblem(NamedTuple):
    """Visual-inertial BA problem over C keyframes and P points: the visual
    part of ``ba.BAProblem`` with D-wide states (D = 9, or 15 in bias-state
    mode) and one preintegrated interval per consecutive keyframe pair."""

    # (C, 9): axis-angle r, translation t, velocity v; or (C, 15) with the
    # per-keyframe bias deltas (dbg, dba) appended (needs bias_jac)
    states: torch.Tensor
    points: torch.Tensor  # (P, 3)
    cam_idx: torch.Tensor  # (M,) integer
    pt_idx: torch.Tensor  # (M,) integer
    obs: torch.Tensor  # (M, 2) pixel observations
    dR: torch.Tensor  # (C-1, 3, 3) preintegrated rotations
    dv: torch.Tensor  # (C-1, 3)
    dp: torch.Tensor  # (C-1, 3)
    interval_T: torch.Tensor  # (C-1,) interval durations [s]
    gravity: torch.Tensor  # (3,) world gravity (an acceleration, e.g. (0, -9.81, 0))
    focal: float = 1.0
    weight: Optional[torch.Tensor] = None  # (M,) optional per-observation weights
    baseline: Optional[torch.Tensor] = None  # (M,) optional rig eye offsets
    # information weights (1/sigma) of the (rotation, velocity, position)
    # blocks, in (rad, m/s, m)^-1 against pixel-unit reprojection
    imu_weight: Optional[torch.Tensor] = None  # (3,)
    # bias-state mode: (C-1, 5, 3, 3) first-order bias Jacobians of each
    # interval, [J_dR_bg, J_dv_bg, J_dv_ba, J_dp_bg, J_dp_ba]
    # (``imu.preintegrate_with_bias_jacobians``); each factor gains 6
    # random-walk residuals w_rw (b_{i+1} - b_i) / sqrt(T_i)
    bias_jac: Optional[torch.Tensor] = None
    bias_rw_weight: Optional[torch.Tensor] = None  # (2,): (gyro, accel) 1/sigma_rw


DEFAULT_IMU_WEIGHT = (1e3, 1e2, 1e3)
# Bias random-walk information (1/sigma per sqrt-second), sized for a
# consumer MEMS IMU (gyro sigma_rw ~ 1e-3 rad/s/sqrt(s), accel ~ 1e-2
# m/s^2/sqrt(s)); pass the sensor's own for a calibrated solve.
DEFAULT_BIAS_RW_WEIGHT = (1e3, 1e2)

_TENSOR_FIELDS = ("states", "points", "cam_idx", "pt_idx", "obs", "dR", "dv", "dp", "interval_T",
                  "gravity", "weight", "baseline", "imu_weight", "bias_jac", "bias_rw_weight")


def _vi_problem_on(problem: VIBAProblem, device=None) -> VIBAProblem:
    """The problem's arrays as tensors on the call's device, each in its own
    dtype: tensors stay on their device, host arrays go to the card unless
    ``device`` names another."""
    dev = call_device(problem.states, problem.points, problem.obs, device=device)
    return problem._replace(**{name: as_tensor(getattr(problem, name), dev)
                               for name in _TENSOR_FIELDS if getattr(problem, name) is not None})


def _imu_residual(si, sj, dR, dv, dp, T, g, w3):
    """The 9 preintegration residuals between consecutive states, each block
    scaled by its information weight."""
    Ri = _rodrigues(si[:3])
    Rj = _rodrigues(sj[:3])
    ci = -Ri.T @ si[3:6]
    cj = -Rj.T @ sj[3:6]
    vi, vj = si[6:9], sj[6:9]
    r_rot = _log_so3(dR.T @ (Ri @ Rj.T))
    r_vel = Ri @ (vj - vi - g * T) - dv
    r_pos = Ri @ (cj - ci - vi * T - 0.5 * g * T * T) - dp
    return torch.cat([w3[0] * r_rot, w3[1] * r_vel, w3[2] * r_pos])


def _imu_residual_jac(si, sj, dR, dv, dp, T, g, w3):
    r = _imu_residual(si, sj, dR, dv, dp, T, g, w3)
    Ji, Jj = torch.func.jacfwd(_imu_residual, argnums=(0, 1))(si, sj, dR, dv, dp, T, g, w3)
    return r, Ji, Jj


def _imu_residual15(si, sj, dR, dv, dp, T, g, w3, Jb, wrw):
    """Bias-state variant (15-DOF states): the 9 preintegration residuals at
    first-order bias-corrected deltas
        dR(dbg_i) = dR Exp(J_dR_bg dbg_i)
        dv(db_i)  = dv + J_dv_bg dbg_i + J_dv_ba dba_i   (dp likewise)
    plus 6 bias random-walk residuals wrw (b_{i+1} - b_i) / sqrt(T_i). Jb:
    (5, 3, 3) [J_dR_bg, J_dv_bg, J_dv_ba, J_dp_bg, J_dp_ba]."""
    dbg_i, dba_i = si[9:12], si[12:15]
    dR_c = dR @ _exp_so3(Jb[0] @ dbg_i)
    dv_c = dv + Jb[1] @ dbg_i + Jb[2] @ dba_i
    dp_c = dp + Jb[3] @ dbg_i + Jb[4] @ dba_i
    r9 = _imu_residual(si, sj, dR_c, dv_c, dp_c, T, g, w3)  # reads si[:9] only
    inv_sqT = torch.rsqrt(torch.clamp_min(T, 1e-6))
    r_bg = (sj[9:12] - si[9:12]) * (wrw[0] * inv_sqT)
    r_ba = (sj[12:15] - si[12:15]) * (wrw[1] * inv_sqT)
    return torch.cat([r9, r_bg, r_ba])


def _imu_residual_jac15(si, sj, dR, dv, dp, T, g, w3, Jb, wrw):
    r = _imu_residual15(si, sj, dR, dv, dp, T, g, w3, Jb, wrw)
    Ji, Jj = torch.func.jacfwd(_imu_residual15, argnums=(0, 1))(si, sj, dR, dv, dp, T, g, w3,
                                                               Jb, wrw)
    return r, Ji, Jj


def _weights(given, default, like):
    return given if given is not None else torch.tensor(default, dtype=like.dtype,
                                                        device=like.device)


def _imu_system(problem: VIBAProblem, C: int):
    """Gauss-Newton contribution of the IMU factors to the camera system:
    (H (C, D, C, D), b (C, D), mean square residual). H carries the
    off-diagonal (i, i+1) blocks, so the caller adds it to the dense part of
    the reduced system."""
    s = problem.states
    w3 = _weights(problem.imu_weight, DEFAULT_IMU_WEIGHT, s)
    if s.shape[1] == 15:
        if problem.bias_jac is None:
            raise ValueError("15-DOF states need bias_jac (preintegrate_with_bias_jacobians)")
        wrw = _weights(problem.bias_rw_weight, DEFAULT_BIAS_RW_WEIGHT, s)
        r, Ji, Jj = torch.func.vmap(_imu_residual_jac15,
                                    in_dims=(0, 0, 0, 0, 0, 0, None, None, 0, None))(
            s[:-1], s[1:], problem.dR, problem.dv, problem.dp, problem.interval_T,
            problem.gravity, w3, problem.bias_jac, wrw)
    else:
        r, Ji, Jj = torch.func.vmap(_imu_residual_jac, in_dims=(0, 0, 0, 0, 0, 0, None, None))(
            s[:-1], s[1:], problem.dR, problem.dv, problem.dp, problem.interval_T,
            problem.gravity, w3)
    i_idx = torch.arange(C - 1, device=s.device)
    j_idx = i_idx + 1
    # the four (row, col) block families of each binary factor
    Hm = torch.cat([torch.einsum("mki,mkj->mij", Ji, Ji), torch.einsum("mki,mkj->mij", Ji, Jj),
                    torch.einsum("mki,mkj->mij", Jj, Ji), torch.einsum("mki,mkj->mij", Jj, Jj)])
    seg = torch.cat([i_idx * C + i_idx, i_idx * C + j_idx, j_idx * C + i_idx, j_idx * C + j_idx])
    D = s.shape[1]
    H = _segment_sum(Hm, seg, C * C).reshape(C, C, D, D).permute(0, 2, 1, 3)  # (C, D, C, D)
    bm = torch.cat([torch.einsum("mki,mk->mi", Ji, r), torch.einsum("mki,mk->mi", Jj, r)])
    b = _segment_sum(bm, torch.cat([i_idx, j_idx]), C)
    return H, b, torch.mean(r * r)


def _vis_problem(problem: VIBAProblem, weight) -> BAProblem:
    """The pose-only (width 6) visual problem of a VI problem."""
    return BAProblem(cams=problem.states[:, :6], points=problem.points, cam_idx=problem.cam_idx,
                     pt_idx=problem.pt_idx, obs=problem.obs, focal=problem.focal, weight=weight,
                     baseline=problem.baseline)


def _assemble_vis(problem: VIBAProblem, C: int, P: int, table):
    """Visual blocks at WIDTH 6, the pose columns only: velocities and
    biases have exactly zero reprojection Jacobians, so the caller embeds
    the 6-wide blocks into the D-wide camera system instead of carrying
    known zeros through every observation."""
    return _assemble(_vis_problem(problem, problem.weight), C, P, table)


def _embed6(M, D: int, axes):
    """Zero-embed width-6 pose blocks into width-D state blocks along the
    given axes (positions 0..5 of each D-wide slot)."""
    pad = [0] * (2 * M.ndim)
    for ax in axes:
        pad[2 * (M.ndim - 1 - ax) + 1] = D - 6  # F.pad lists the last axis first
    return F.pad(M, pad)


def _gn_step_vi(shards, lam, C: int, tables, fixed_dofs, reduce=None):
    """One Gauss-Newton step over point shards (``ba._gn_step``'s layout):
    each shard's visual terms at width 6 on its device, summed by
    ``reduce`` (None: the one shard's own), then the IMU system of the
    replicated states added once, the D-wide cameras solved on the device of
    the sum and each shard's points back-substituted. Returns (the shards
    updated, the visual and the IMU mean square residuals)."""
    D = shards[0].states.shape[1]
    terms, local = [], []
    for prob, table in zip(shards, tables):
        Hcc6, Hpp, bc6, bp, Wp6, camT, r = _assemble_vis(prob, C, prob.points.shape[0], table)
        S6, rhs6, Vinv = _schur_reduce(Hpp, bp, Wp6, camT, lam.to(Hpp.device), C)
        terms.append((Hcc6, bc6, S6, rhs6, torch.mean(r * r)))
        local.append((Vinv, Wp6, camT, bp))
    Hcc6, bc6, S6, rhs6, msr_vis = terms[0] if reduce is None else reduce(terms)
    home = _vi_on(shards[0], Hcc6.device)
    H_imu, b_imu, msr_imu = _imu_system(home, C)
    delta_c = _solve_cameras(
        _embed6(Hcc6, D, (1, 2)), _embed6(bc6, D, (1,)) + b_imu,
        _embed6(S6, D, (1, 3)) + H_imu, _embed6(rhs6, D, (1,)), lam,
        fixed_dofs=fixed_dofs, precondition=True,
    )
    out = []
    for prob, (Vinv, Wp6, camT, bp) in zip(shards, local):
        dc = delta_c.to(prob.states.device)
        delta_p = _back_substitute(Vinv, Wp6, camT, bp, dc[:, :6])
        out.append(prob._replace(states=prob.states + dc, points=prob.points + delta_p))
    return out, msr_vis, msr_imu


def _vi_on(problem: VIBAProblem, device) -> VIBAProblem:
    """The replicated (IMU) fields of a shard on ``device``."""
    if problem.states.device == device:
        return problem
    return problem._replace(**{name: getattr(problem, name).to(device)
                               for name in ("states", "dR", "dv", "dp", "interval_T", "gravity",
                                            "imu_weight", "bias_jac", "bias_rw_weight")
                               if getattr(problem, name) is not None})


def _huber_weights_vi(prob: VIBAProblem, base_w, delta):
    """IRLS sqrt-weights of the visual residuals; the IMU factors are never
    downweighted (they are not associations that can be wrong, and
    robustifying them would open the scale gauge again)."""
    return base_w * _huber_sqrt_weights(_vis_problem(prob, base_w), delta)


def vi_bundle_adjust(
    problem: VIBAProblem,
    iters: int = 12,
    lam: float = 1e-3,
    fixed_states=None,
    robust_delta=None,
    *,
    device=None,
) -> Tuple[VIBAProblem, torch.Tensor]:
    """Joint Gauss-Newton over the states and points with IMU factors.

    Returns (refined problem, (iters, 2) history of the mean square visual
    and IMU residuals). The problem's tensors stay on their device; host
    arrays go to the card unless ``device`` names another. The observation
    table is built on the host from pt_idx.

    fixed_states: optional (C,) bool of keyframes whose POSE is held;
    keyframe 0's pose is always pinned as the gauge anchor. Velocities and
    biases are never pinned.

    robust_delta: optional Huber scale in PIXELS: visual observations whose
    reprojection error exceeds it are IRLS-downweighted each iteration
    (``ba.bundle_adjust``'s semantics); the IMU factors never are."""
    problem = _vi_problem_on(problem, device)
    dev = problem.points.device
    dtype = problem.points.dtype
    C, D = problem.states.shape
    P = problem.points.shape[0]
    if C < 2:
        raise ValueError("VI-BA needs >= 2 keyframes (one IMU interval)")
    valid = None if problem.weight is None else host_array(problem.weight) > 0
    table = torch.from_numpy(build_track_table(problem.pt_idx, P, valid=valid)).to(dev)
    pinned = np.zeros(C, bool)
    pinned[0] = True
    if fixed_states is not None:
        pinned |= host_array(fixed_states).astype(bool)
    dofs = np.zeros((C, D), bool)
    dofs[pinned, :6] = True  # pose pinned; velocity (and biases) live
    fixed_dofs = torch.from_numpy(dofs.reshape(-1)).to(dev)
    lam = torch.full((), lam, dtype=dtype, device=dev)
    robust = robust_delta is not None
    if robust and problem.weight is None:
        problem = problem._replace(weight=torch.ones(problem.obs.shape[:1], dtype=problem.obs.dtype,
                                                     device=dev))
    delta = torch.full((), robust_delta, dtype=dtype, device=dev) if robust else None
    base_w = problem.weight
    hist = []
    with _ieee_f32_matmul():
        for _ in range(iters):
            prob = problem
            if robust:
                prob = prob._replace(weight=_huber_weights_vi(prob, base_w, delta))
            (prob,), msr_vis, msr_imu = _gn_step_vi([prob], lam, C, [table], fixed_dofs)
            problem = prob._replace(weight=base_w)
            hist.append(torch.stack([msr_vis, msr_imu]))
    return problem, (torch.stack(hist) if hist else torch.zeros((0, 2), dtype=dtype, device=dev))


def sharded_vi_bundle_adjust(
    problem: VIBAProblem,
    mesh: FlowMesh,
    iters: int = 12,
    lam: float = 1e-3,
) -> Tuple[VIBAProblem, torch.Tensor]:
    """VI-BA with the points and observations sharded over every slot of
    the mesh and the states, IMU deltas and gravity replicated (the
    contract of ``ba.sharded_bundle_adjust``: P and M divisible by
    ``mesh.size``, pt_idx LOCAL to each shard's point slice; every process
    passes the whole problem and returns it whole). The visual camera
    system is summed across the mesh; the IMU factors are assembled once
    from the replicated states after the sum. Keyframe 0's pose is pinned.
    Returns (refined problem, (iters, 2) history: the shards' mean of the
    visual mean square residual, and the IMU's)."""
    check_shardable(problem.points.shape[0], problem.obs.shape[0], mesh)
    if problem.states.shape[1] == 15 and problem.bias_jac is None:
        raise ValueError("15-DOF states need bias_jac (preintegrate_with_bias_jacobians)")
    problem = _vi_problem_on(problem, mesh.home)
    n = mesh.size
    C, D = problem.states.shape
    P_local, M_local = problem.points.shape[0] // n, problem.obs.shape[0] // n
    tables = shard_tables(problem.pt_idx, P_local, M_local, n)
    dtype = problem.points.dtype
    shards, shard_t = [], []
    for d in mesh.local_slots():
        dev = mesh.devices.flat[d]
        shards.append(_vi_on(problem, dev)._replace(**{
            name: shard_rows(getattr(problem, name), d, n, dev)
            for name in ("points", "cam_idx", "pt_idx", "obs", "weight", "baseline")
            if getattr(problem, name) is not None}))
        shard_t.append(torch.from_numpy(tables[d]).to(dev))
    dofs = np.zeros((C, D), bool)
    dofs[0, :6] = True  # the gauge anchor; velocities (and biases) live
    fixed_dofs = torch.from_numpy(dofs.reshape(-1)).to(mesh.home)
    lam = torch.full((), lam, dtype=dtype, device=mesh.home)
    reduce = mesh_reduce(mesh)
    hist = []
    with _ieee_f32_matmul():
        for _ in range(iters):
            shards, msr_vis, msr_imu = _gn_step_vi(shards, lam, C, shard_t, fixed_dofs,
                                                   reduce=reduce)
            hist.append(torch.stack([msr_vis, msr_imu]))
    points = torch.cat(gather_slots([s.points for s in shards], mesh.ranks.reshape(-1), mesh))
    return (problem._replace(states=shards[0].states.to(mesh.home), points=points),
            torch.stack(hist) if hist else torch.zeros((0, 2), dtype=dtype, device=mesh.home))


def vi_problem_from_ba(
    ba_problem,
    velocities,
    dR,
    dv,
    dp,
    interval_T,
    gravity,
    imu_weight=DEFAULT_IMU_WEIGHT,
    bias_jac=None,
    bias_rw_weight=DEFAULT_BIAS_RW_WEIGHT,
    *,
    device=None,
) -> VIBAProblem:
    """Lift a visual ``ba.BAProblem`` (consecutive-keyframe cameras) into a
    ``VIBAProblem``, given initial velocities and the preintegrated
    (bias-corrected) deltas of each consecutive interval. Every array takes
    the dtype of the cameras, on the BA problem's device (host arrays: the
    card unless ``device`` names another).

    bias_jac: optional (C-1, 5, 3, 3) first-order bias Jacobians
    (``imu.preintegrate_with_bias_jacobians``); with them the states are
    15-DOF, the bias deltas (dbg, dba) starting at zero and coupled across
    keyframes by random-walk factors of weight ``bias_rw_weight`` (None:
    the default)."""
    base = _problem_on(ba_problem, device)
    dev, dtype = base.cams.device, base.cams.dtype

    def t(x):
        return as_tensor(x, dev, dtype)

    states = torch.cat([base.cams, t(velocities)], -1)
    if bias_jac is not None:
        states = torch.cat([states, states.new_zeros((states.shape[0], 6))], -1)
    return VIBAProblem(
        states=states, points=base.points, cam_idx=base.cam_idx, pt_idx=base.pt_idx, obs=base.obs,
        dR=t(dR), dv=t(dv), dp=t(dp), interval_T=t(interval_T), gravity=t(gravity),
        focal=base.focal, weight=base.weight, baseline=base.baseline, imu_weight=t(imu_weight),
        bias_jac=None if bias_jac is None else t(bias_jac),
        bias_rw_weight=None if bias_jac is None or bias_rw_weight is None else t(bias_rw_weight),
    )


def group_imu_by_keyframes(t, gyro, accel, kf_t):
    """Slice a continuous IMU log into padded per-keyframe-interval arrays
    (the layout ``preintegrate`` and ``visual_inertial_alignment_with_bias``
    batch over).

    t: (N,) sorted sample timestamps; gyro/accel: (N, 3); kf_t: (K,)
    keyframe timestamps. Sample k covers [t_k, t_{k+1}) and belongs to the
    interval holding t_k; samples outside [kf_t[0], kf_t[-1]) are dropped.
    Returns numpy (gyro (K-1, W, 3), accel (K-1, W, 3), dt (K-1, W), valid
    (K-1, W))."""
    t = np.asarray(t, np.float64)
    kf_t = np.asarray(kf_t, np.float64)
    gyro = np.asarray(gyro, np.float64)
    accel = np.asarray(accel, np.float64)
    if len(t) < 2:
        raise ValueError("need >= 2 IMU samples")
    if len(kf_t) < 2:
        raise ValueError("need >= 2 keyframe timestamps")
    dt_all = np.diff(t)
    dt_all = np.append(dt_all, dt_all[-1])  # the last sample carries its period
    seg = np.searchsorted(kf_t, t, side="right") - 1  # interval of each sample
    K = len(kf_t)
    live = (seg >= 0) & (seg < K - 1)
    # live samples stable-sorted by interval; a sample's slot is its rank
    # within its interval (no per-sample Python loop: hour-long 200 Hz logs
    # are ~1e6 samples)
    idx = np.nonzero(live)[0]
    idx = idx[np.argsort(seg[idx], kind="stable")]
    segs = seg[idx]
    counts = np.bincount(segs, minlength=K - 1)
    W = max(int(counts.max()), 1) if len(idx) else 1
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slots = np.arange(len(idx)) - np.repeat(starts, counts)
    g_out = np.zeros((K - 1, W, 3))
    a_out = np.zeros((K - 1, W, 3))
    h_out = np.zeros((K - 1, W))
    ok = np.zeros((K - 1, W), bool)
    g_out[segs, slots] = gyro[idx]
    a_out[segs, slots] = accel[idx]
    h_out[segs, slots] = dt_all[idx]
    ok[segs, slots] = True
    return g_out, a_out, h_out, ok


def refine_slam_with_imu(
    result,
    focal,
    imu_t,
    gyro,
    accel,
    kf_t,
    *,
    gravity_mag: float = 9.81,
    imu_weight=DEFAULT_IMU_WEIGHT,
    iters: int = 12,
    lam: float = 1e-3,
    estimate_accel_bias: bool = True,
    robust_delta=3.0,
    bias_states: bool = False,
    bias_rw_weight=DEFAULT_BIAS_RW_WEIGHT,
    device=None,
):
    """Tightly-coupled VI refinement of a finished ``incremental_slam``
    solution: the SlamResult carries its own observations, so the raw IMU
    log is grouped by the keyframe timestamps and ``refine_with_imu`` runs
    on it.

    result: a SlamResult (monocular up to scale, or stereo); imu_t, gyro,
    accel: the continuous IMU log; kf_t: (K,) capture timestamps of
    ``result.keyframes``. Returns (refined VIBAProblem, info dict): metric
    poses in ``out.states[:, :6]``, the metric map in ``out.points``.

    robust_delta defaults to 3 px (Huber IRLS on the visual residuals), as
    the final global BA does: the exported observations span every
    association ever made. Pass None for squared loss."""
    if result.cam_idx is None or len(result.cam_idx) == 0:
        raise ValueError("SlamResult carries no observations to refine")
    g, a, h, ok = group_imu_by_keyframes(imu_t, gyro, accel, kf_t)
    if not ok.any(axis=1).all():
        raise ValueError("an inter-keyframe interval has no IMU samples")
    return refine_with_imu(
        result.poses, result.trans, result.points, result.cam_idx, result.pt_idx, result.obs,
        focal, g, a, h, ok, gravity_mag=gravity_mag, imu_weight=imu_weight, iters=iters,
        lam=lam, estimate_accel_bias=estimate_accel_bias, baseline=result.obs_baseline,
        robust_delta=robust_delta, bias_states=bias_states, bias_rw_weight=bias_rw_weight,
        device=device,
    )


def refine_with_imu(
    poses,
    trans,
    points,
    cam_idx,
    pt_idx,
    obs,
    focal,
    gyro,
    accel,
    dt,
    valid=None,
    *,
    gravity_mag: float = 9.81,
    imu_weight=DEFAULT_IMU_WEIGHT,
    iters: int = 12,
    lam: float = 1e-3,
    estimate_accel_bias: bool = True,
    baseline=None,
    robust_delta=None,
    bias_states: bool = False,
    bias_rw_weight=DEFAULT_BIAS_RW_WEIGHT,
    device=None,
):
    """End-to-end tightly-coupled refinement of a monocular solution.

    Gyro and accel bias estimation and the linear VI alignment
    (``imu.visual_inertial_alignment_with_bias``) set metric scale, gravity
    and velocities; the visual solution is rescaled to metric; then
    ``vi_bundle_adjust`` refines poses, velocities and points against the
    reprojection and preintegration factors, in float32.

    poses/trans: (K, 3, 3)/(K, 3) world->cam keyframe poses (up to scale);
    points (P, 3); cam_idx/pt_idx/obs the keyframe observations
    (``ba.BAProblem`` layout); gyro/accel/dt/valid the interval IMU logs.
    baseline: optional (M,) rig eye offsets; a stereo solution is already
    metric, so it is not rescaled (``scale_applied`` 1) and the alignment
    supplies gravity, velocities and biases only.

    estimate_accel_bias: pass False on rotation-poor trajectories (accel
    bias separates from gravity only when the body rotates about varied
    axes). bias_states: carry per-keyframe bias deltas (15-DOF states) with
    random-walk coupling of weight ``bias_rw_weight``; the info dict then
    holds per-keyframe absolute biases.

    Rotations go from matrices to axis-angle and back in float64 on the host
    (``frontend._rotmat_to_axis_angle``), as cv2.Rodrigues does in the JAX
    package. Host arrays go to the card unless ``device`` names another.
    Returns (refined VIBAProblem, info dict with scale, gravity, biases and
    the residual history)."""
    dev = call_device(poses, points, obs, device=device)
    live = (np.ones(host_array(dt).shape, bool) if valid is None
            else host_array(valid).astype(bool))
    T = np.sum(host_array(dt).astype(np.float64) * live, axis=-1)  # (K-1,)
    s, g, vels, bg, ba_bias, rms = visual_inertial_alignment_with_bias(
        poses, trans, T, gyro, accel, dt, valid, gravity_mag=gravity_mag,
        estimate_accel_bias=estimate_accel_bias, device=dev,
    )
    corrected_gyro = host_array(gyro).astype(np.float32) - np.asarray(bg, np.float32)
    corrected_accel = host_array(accel).astype(np.float32) - np.asarray(ba_bias, np.float32)
    bias_jac = None
    if bias_states:
        dR, dv, dp, bias_jac = preintegrate_with_bias_jacobians(corrected_gyro, corrected_accel,
                                                                dt, live, device=dev)
    else:
        dR, dv, dp = preintegrate(corrected_gyro, corrected_accel, dt, live, device=dev)
    s_apply = s
    if baseline is not None and np.any(host_array(baseline) != 0):
        # stereo: the solution is ALREADY metric (rig-anchored) and the
        # baseline residuals assume fixed metric units; the alignment's noisy
        # s (~1) would push the init off metric and fight the rig
        s_apply = 1.0
    cams = np.concatenate([
        np.stack([_rotmat_to_axis_angle(R) for R in host_array(poses).astype(np.float64)]),
        s_apply * host_array(trans).astype(np.float64),  # metric translations
    ], axis=-1)
    base = BAProblem(
        cams=as_tensor(cams, dev, torch.float32),
        points=as_tensor(s_apply * host_array(points).astype(np.float64), dev, torch.float32),
        cam_idx=as_tensor(cam_idx, dev, torch.int64), pt_idx=as_tensor(pt_idx, dev, torch.int64),
        obs=as_tensor(obs, dev, torch.float32),
        baseline=None if baseline is None else as_tensor(baseline, dev, torch.float32),
        focal=focal,
    )
    prob = vi_problem_from_ba(base, vels, dR, dv, dp, T, g, imu_weight=imu_weight,
                              bias_jac=bias_jac, bias_rw_weight=bias_rw_weight)
    out, hist = vi_bundle_adjust(prob, iters=iters, lam=lam, robust_delta=robust_delta)
    info = {
        "scale": float(s),
        "scale_applied": float(s_apply),
        "gravity": np.asarray(g),
        "gyro_bias": np.asarray(bg),
        "accel_bias": np.asarray(ba_bias),
        "alignment_rms": float(rms),
        "history": host_array(hist),
    }
    if bias_states:
        # absolute per-keyframe biases: the one-shot estimate plus the
        # solved per-keyframe deltas
        st = host_array(out.states)
        info["gyro_bias_per_kf"] = np.asarray(bg)[None] + st[:, 9:12]
        info["accel_bias_per_kf"] = np.asarray(ba_bias)[None] + st[:, 12:15]
    return out, info


def states_to_poses(states) -> Tuple[np.ndarray, np.ndarray]:
    """(C, >= 6) states -> float64 world->cam rotations (C, 3, 3) and
    translations (C, 3) on the host (the float64 counterpart of
    cv2.Rodrigues)."""
    st = torch.from_numpy(host_array(states).astype(np.float64))
    return np.stack([_rodrigues(x[:3]).numpy() for x in st]), st[:, 3:6].numpy().copy()
