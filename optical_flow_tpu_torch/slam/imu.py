"""IMU preintegration and monocular visual-inertial alignment (port of
optical_flow_tpu/slam/imu.py).

- ``preintegrate``: Forster-style relative IMU deltas (dR, dv, dp) over
  keyframe intervals. JAX runs one ``lax.scan`` over the samples under
  ``vmap``; the port forms every step's rotation at once (they depend on
  no carried state), then runs one Python loop over the samples for the
  carried products and sums, each step batched over every interval (the
  flattened leading axes), in float32 as JAX forces it.
- ``preintegrate_with_bias_jacobians``: the deltas plus their first-order
  bias Jacobians, from one primal pass and 6 forward-mode tangents
  (``torch.func.jvp`` under ``torch.func.vmap``, as JAX's
  ``jax.linearize`` + ``vmap``).
- ``estimate_gyro_bias``: Gauss-Newton on the SO(3) residuals between the
  preintegrated rotations and the relative visual rotations; residuals and
  their 3-column Jacobian on the device (``torch.func.jacfwd``), the
  least-squares step on the host in float64.
- ``visual_inertial_alignment`` and ``visual_inertial_alignment_with_bias``:
  the linear initialization of metric scale, gravity and velocities (host
  numpy, as in JAX); in the bias variant only the deltas and their
  accelerometer-bias Jacobian touch the device.

Conventions: body frame == camera frame; the accelerometer measures
specific force a_b = R_bw (a_w - g_w); vision poses are world->cam (R_i,
t_i) with camera centre c_i = -R_i^T t_i.

Host arrays go to the card unless ``device`` names another; tensors stay
on their device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from optical_flow_tpu_torch.utils.device import as_tensor, call_device, host_array


def _hat(w):
    """(..., 3) -> (..., 3, 3) skew matrices [w]x."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1),
    ], -2)


def _exp_so3(w):
    """Axis-angle (..., 3) -> SO(3) (..., 3, 3), smooth at 0 (a series below
    th^2 = 1e-12).

    ``torch.where`` differentiates both branches, as ``jax.jacrev`` does: the
    large-angle branch divides by a CLAMPED th2 and th carries 1e-24 inside
    its sqrt, so that at w == 0 exactly (a stationary gyro log) the untaken
    (1 - cos)/th2 cannot put a NaN into the gyro-bias Jacobian."""
    th2 = torch.sum(w * w, -1)[..., None, None]
    th = torch.sqrt(th2 + 1e-24)
    K = _hat(w)
    A = torch.where(th2 > 1e-12, torch.sin(th) / th, 1.0 - th2 / 6.0)
    B = torch.where(th2 > 1e-12, (1.0 - torch.cos(th)) / torch.clamp_min(th2, 1e-12),
                    0.5 - th2 / 24.0)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + A * K + B * (K @ K)


def _log_so3(R):
    """SO(3) (..., 3, 3) -> axis-angle (..., 3) for angles below pi/2, smooth
    and differentiable at 0: w = 2 sin(th) axis from the skew part, th =
    arcsin(|w| / 2), scaled by th / (2 sin th) or its series. (The arccos of
    the trace has an infinite derivative at the identity.)"""
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    x2 = torch.sum(w * w, -1, keepdim=True) * 0.25 + 1e-24  # sin^2(th); eps keeps sqrt smooth
    x = torch.sqrt(x2)
    th = torch.arcsin(torch.clamp(x, 0.0, 1.0 - 1e-7))
    scale = torch.where(x2 > 1e-12, th / (2.0 * x), 0.5 + x2 / 12.0)
    return w * scale


def _imu_inputs(gyro, accel, dt, valid, device):
    """The IMU arrays as tensors on the call's device: float32 samples and
    periods (accel None stays None), a bool mask (all True by default)."""
    dev = call_device(gyro, accel, dt, device=device)
    dt = as_tensor(dt, dev, torch.float32)
    valid = (torch.ones(dt.shape, dtype=torch.bool, device=dev) if valid is None
             else as_tensor(valid, dev, torch.bool))
    accel = None if accel is None else as_tensor(accel, dev, torch.float32)
    return as_tensor(gyro, dev, torch.float32), accel, dt, valid


def _integrate(gyro, accel, dt, valid):
    """The preintegration loop on (B, N, 3) samples and (B, N) periods and
    mask: one step a sample, batched over the B intervals. The step
    rotations depend on no carried state, so they are formed for all steps
    at once; the products and sums are carried in JAX's order."""
    B, N = dt.shape
    R = torch.eye(3, dtype=gyro.dtype, device=gyro.device).expand(B, 3, 3)
    v = torch.zeros((B, 3), dtype=gyro.dtype, device=gyro.device)
    p = torch.zeros_like(v)
    h = torch.where(valid, dt, 0.0)[..., None]
    # midpoint rotation for the accel term (VINS-style): start-of-step Euler
    # leaves an O(w h) bias on the gravity-scale accel integral (13% scale
    # error on a 1.6 rad/s spin at 200 Hz; midpoint < 1%)
    E_mid = _exp_so3(gyro * (0.5 * h))
    E = _exp_so3(gyro * h)
    for n in range(N):
        hn = h[:, n]
        a_w = ((R @ E_mid[:, n]) @ accel[:, n, :, None])[..., 0]
        p = p + v * hn + 0.5 * a_w * hn * hn
        v = v + a_w * hn
        R = R @ E[:, n]
    return R, v, p


def preintegrate(gyro, accel, dt, valid=None, *, device=None):
    """Relative IMU deltas over (batched) sample windows.

    gyro, accel: (..., N, 3) body-frame angular rate and specific force; dt:
    (..., N) sample periods; valid: optional (..., N) bool, padded samples
    (ragged intervals batched to one length) contribute identity.

    Returns float32 (dR (..., 3, 3), dv (..., 3), dp (..., 3)): the body pose
    change with gravity and initial velocity removed,
        R_{i+1} = R_i dR,  v_{i+1} = v_i + g T + R_i dv,
        p_{i+1} = p_i + v_i T + 1/2 g T^2 + R_i dp
    (R_i body->world; ``visual_inertial_alignment`` handles the world->cam
    flip)."""
    gyro, accel, dt, valid = _imu_inputs(gyro, accel, dt, valid, device)
    lead = dt.shape[:-1]
    N = dt.shape[-1]
    R, v, p = _integrate(gyro.reshape(-1, N, 3), accel.reshape(-1, N, 3), dt.reshape(-1, N),
                         valid.reshape(-1, N))
    return R.reshape(lead + (3, 3)), v.reshape(lead + (3,)), p.reshape(lead + (3,))


def preintegrate_with_bias_jacobians(gyro, accel, dt, valid=None, *, device=None):
    """Preintegrated deltas plus their FIRST-ORDER bias Jacobians (the
    correction terms of a bias-state VI-BA).

    gyro/accel are the (already bias-corrected) interval windows of
    ``preintegrate``; the Jacobians are d(deltas)/d(delta-bias) at
    delta-bias = 0, by forward-mode differentiation through the
    preintegration loop itself: one primal pass and 6 tangents. The
    rotation Jacobian is in the Exp-correction chart dR(dbg) ~= dR
    Exp(J_dR_bg dbg): for dR(e) = dR0 Exp(J e), dRdot = dR0 [J e]x, so J's
    columns are vee(dR0^T dRdot).

    Returns (dR, dv, dp, J) with J a (..., 5, 3, 3) stack ordered [J_dR_bg,
    J_dv_bg, J_dv_ba, J_dp_bg, J_dp_ba], the layout ``VIBAProblem.bias_jac``
    carries."""
    gyro, accel, dt, valid = _imu_inputs(gyro, accel, dt, valid, device)

    def deltas(b):
        return preintegrate(gyro - b[:3], accel - b[3:], dt, valid)

    zero = torch.zeros(6, dtype=torch.float32, device=dt.device)
    eye = torch.eye(6, dtype=torch.float32, device=dt.device)
    # the primal depends on no batched input, so vmap runs it once
    (dR0, dv0, dp0), (dRd, dvd, dpd) = torch.func.vmap(
        lambda t: torch.func.jvp(deltas, (zero,), (t,)))(eye)
    dR0, dv0, dp0 = dR0[0], dv0[0], dp0[0]
    S = torch.einsum("...ji,k...jl->k...il", dR0, dRd)  # (6, ..., 3, 3)
    S = 0.5 * (S - S.mT)  # exact skew (float32 hygiene)
    w = torch.stack([S[..., 2, 1], S[..., 0, 2], S[..., 1, 0]], -1)
    Jr = torch.movedim(w, 0, -1)  # (..., 3, 6); its accel columns are zero
    Jv = torch.movedim(dvd, 0, -1)
    Jp = torch.movedim(dpd, 0, -1)
    J = torch.stack([Jr[..., :3], Jv[..., :3], Jv[..., 3:], Jp[..., :3], Jp[..., 3:]], -3)
    return dR0, dv0, dp0, J


def _rotation_residuals(bg, gyro, dt, valid, R_rel_vis):
    """Log(dR_i(bg)^T RelVis_i) stacked over the intervals: what
    ``estimate_gyro_bias`` drives to zero. gyro (M, N, 3), dt and valid (M,
    N), R_rel_vis (M, 3, 3) body-frame relative visual rotations."""
    M, N = dt.shape
    R = torch.eye(3, dtype=gyro.dtype, device=gyro.device).expand(M, 3, 3)
    E = _exp_so3((gyro - bg) * torch.where(valid, dt, 0.0)[..., None])  # every step at once
    for n in range(N):
        R = R @ E[:, n]
    return _log_so3(R.mT @ R_rel_vis)


def _rotation_residuals_and_jac(bg, gyro, dt, valid, R_rel_vis):
    """(residuals (M, 3), their Jacobian (M, 3, 3) in bg): one primal pass and
    3 forward-mode tangents."""

    def f(b):
        r = _rotation_residuals(b, gyro, dt, valid, R_rel_vis)
        return r, r

    J, r = torch.func.jacfwd(f, has_aux=True)(bg)
    return r, J


def estimate_gyro_bias(poses, gyro, dt, valid=None, iters: int = 3, *, device=None):
    """Gyroscope bias from visual rotations (the bias-free measurement).

    poses: (K, 3, 3) world->cam visual keyframe rotations; gyro: (K-1, N, 3)
    body-rate samples per keyframe interval (padded to one length); dt:
    (K-1, N); valid: optional (K-1, N) bool for the padding.

    Gauss-Newton on r_i(bg) = Log(dR_i(bg)^T R_i^bw R_{i+1}^wb): each
    iteration preintegrates the rotations again with the corrected gyro and
    takes one step with their 3-column Jacobian. Returns bg (3,) float64 in
    rad/s."""
    poses = host_array(poses).astype(np.float32)
    gyro, _, dt, valid = _imu_inputs(gyro, None, dt, valid, device)
    # relative visual rotation between body frames: with world->cam poses[i]
    # and body == cam, R^wb_i = poses[i]^T, so
    # dR_vis_i = (R^wb_i)^T R^wb_{i+1} = poses[i] @ poses[i+1]^T
    R_rel = torch.from_numpy(
        np.stack([poses[i] @ poses[i + 1].T for i in range(len(poses) - 1)])).to(dt.device)
    bg = torch.zeros(3, dtype=torch.float32, device=dt.device)
    for _ in range(iters):
        r, J = _rotation_residuals_and_jac(bg, gyro, dt, valid, R_rel)
        Jf = host_array(J).reshape(-1, 3).astype(np.float64)
        rf = host_array(r).reshape(-1).astype(np.float64)
        step, *_ = np.linalg.lstsq(Jf, -rf, rcond=None)
        bg = bg + torch.from_numpy(step.astype(np.float32)).to(bg.device)
    return host_array(bg).astype(np.float64)


def visual_inertial_alignment(
    poses, trans, interval_T, dv, dp, *, gravity_mag: float | None = None
) -> Tuple[float, np.ndarray, np.ndarray, float]:
    """Monocular VI initialization: metric scale, gravity and velocities
    (host numpy in float64).

    poses, trans: (K, 3, 3), (K, 3) world->cam visual keyframe poses
    (``SlamResult.poses``/``.trans``, up-to-scale translations).
    interval_T: (K-1,) total time of each keyframe interval.
    dv, dp: (K-1, 3) preintegrated deltas between consecutive keyframes.

    Solves, linearly in (s, g, v_0..v_{K-1}):
        s (c_{i+1} - c_i) = v_i T_i + 1/2 g T_i^2 + R_i^wb dp_i
        v_{i+1} - v_i     = g T_i + R_i^wb dv_i
    with c_i the visual camera centres and R_i^wb = poses[i]^T. Returns
    (scale, gravity (3,), velocities (K, 3), rms residual). With
    gravity_mag, g is projected to that norm and the other unknowns solved
    again (the VINS-style refinement)."""
    poses = host_array(poses).astype(np.float64)
    trans = host_array(trans).astype(np.float64)
    T = host_array(interval_T).astype(np.float64)
    dv = host_array(dv).astype(np.float64)
    dp = host_array(dp).astype(np.float64)
    K = len(poses)
    if K < 3:
        raise ValueError("alignment needs >= 3 keyframes")
    centers = np.stack([-R.T @ t for R, t in zip(poses, trans)])
    Rwb = np.stack([R.T for R in poses])  # body->world

    # unknowns x = [s, g(3), v_0..v_{K-1} (3K)]
    n = 1 + 3 + 3 * K
    rows_A, rows_b = [], []
    for i in range(K - 1):
        Ti = T[i]
        A = np.zeros((3, n))  # position rows
        A[:, 0] = centers[i + 1] - centers[i]
        A[:, 1:4] = -0.5 * Ti * Ti * np.eye(3)
        A[:, 4 + 3 * i : 7 + 3 * i] = -Ti * np.eye(3)
        rows_A.append(A)
        rows_b.append(Rwb[i] @ dp[i])
        A = np.zeros((3, n))  # velocity rows
        A[:, 1:4] = -Ti * np.eye(3)
        A[:, 4 + 3 * i : 7 + 3 * i] = -np.eye(3)
        A[:, 4 + 3 * (i + 1) : 7 + 3 * (i + 1)] = np.eye(3)
        rows_A.append(A)
        rows_b.append(Rwb[i] @ dv[i])
    A = np.concatenate(rows_A)
    b = np.concatenate(rows_b)
    x, *_ = np.linalg.lstsq(A, b, rcond=None)
    if gravity_mag is not None:
        # g onto the sphere |g| = gravity_mag, the rest solved again with g
        # fixed (one step of the tangent-space refinement)
        g = x[1:4]
        g = g / max(np.linalg.norm(g), 1e-12) * gravity_mag
        A2 = np.delete(A, [1, 2, 3], axis=1)
        b2 = b - A[:, 1:4] @ g
        x2, *_ = np.linalg.lstsq(A2, b2, rcond=None)
        x = np.concatenate([x2[:1], g, x2[1:]])
    resid = A @ x - b
    rms = float(np.sqrt(np.mean(resid**2)))
    return float(x[0]), x[1:4].copy(), x[4:].reshape(K, 3).copy(), rms


def visual_inertial_alignment_with_bias(
    poses,
    trans,
    interval_T,
    gyro,
    accel,
    dt,
    valid=None,
    *,
    gravity_mag: float | None = 9.81,
    estimate_accel_bias: bool = True,
    gyro_iters: int = 3,
    device=None,
):
    """VI initialization under sensor biases.

    The visual inputs of ``visual_inertial_alignment``, with raw interval IMU
    logs instead of deltas: gyro/accel (K-1, N, 3), dt (K-1, N), valid
    optional padding mask.

    (1) the gyro bias from visual rotations (``estimate_gyro_bias``); (2)
    preintegration again with the corrected gyro, and d(dv, dp)/d(ba) by
    forward-mode differentiation (exact: the deltas are linear in the
    accelerometer); (3) the linear alignment with accelerometer-bias
    columns. ba and g separate only when the body ROTATES; with gravity_mag,
    g is held on its sphere and (s, ba, v) solved again, 4 times.

    Returns (scale, gravity (3,), velocities (K, 3), bg (3,), ba (3,),
    rms)."""
    gyro = host_array(gyro).astype(np.float32)
    accel = host_array(accel).astype(np.float32)
    dt_np = host_array(dt).astype(np.float32)
    valid = np.ones(dt_np.shape, bool) if valid is None else host_array(valid).astype(bool)
    bg = estimate_gyro_bias(poses, gyro, dt_np, valid, iters=gyro_iters, device=device)
    corrected, accel_t, dt_t, valid_t = _imu_inputs(gyro - bg.astype(np.float32), accel, dt_np,
                                                    valid, device)

    def deltas(ba):
        _, dv, dp = preintegrate(corrected, accel_t - ba, dt_t, valid_t)
        return (dv, dp), (dv, dp)

    (Jdv, Jdp), (dv0, dp0) = torch.func.jacfwd(deltas, has_aux=True)(
        torch.zeros(3, dtype=torch.float32, device=dt_t.device))
    dv0, dp0, Jdv, Jdp = (host_array(x).astype(np.float64) for x in (dv0, dp0, Jdv, Jdp))

    poses_np = host_array(poses).astype(np.float64)
    trans_np = host_array(trans).astype(np.float64)
    T = host_array(interval_T).astype(np.float64)
    K = len(poses_np)
    if K < 3:
        raise ValueError("alignment needs >= 3 keyframes")
    centers = np.stack([-R.T @ t for R, t in zip(poses_np, trans_np)])
    Rwb = np.stack([R.T for R in poses_np])
    nb = 3 if estimate_accel_bias else 0

    def solve(g_fix=None):
        """One linear solve. g_fix None: g free (3 columns). Otherwise g =
        g_fix + B w, B an orthonormal tangent basis at g_fix (2 columns):
        the |g|-sphere parametrization that removes the radial (g, ba) gauge
        freedom of the free system under weak rotation (VINS
        RefineGravity). Unknowns: [s, g-part, ba?, v_0..v_{K-1}]."""
        if g_fix is None:
            ng, B, g0 = 3, np.eye(3), np.zeros(3)
        else:
            g0 = g_fix
            k = g0 / np.linalg.norm(g0)
            t0 = np.array([1.0, 0.0, 0.0])
            if abs(k[0]) > 0.9:
                t0 = np.array([0.0, 1.0, 0.0])
            b1 = np.cross(k, t0)
            b1 /= np.linalg.norm(b1)
            b2 = np.cross(k, b1)
            ng, B = 2, np.stack([b1, b2], axis=1)
        n = 1 + ng + nb + 3 * K
        rows_A, rows_b = [], []
        for i in range(K - 1):
            Ti = T[i]
            A = np.zeros((3, n))
            A[:, 0] = centers[i + 1] - centers[i]
            A[:, 1 : 1 + ng] = -0.5 * Ti * Ti * B
            if nb:
                # dp(ba) = dp0 + Jdp ba: the ba term moves to the unknowns
                A[:, 1 + ng : 4 + ng] = -Rwb[i] @ Jdp[i]
            A[:, 1 + ng + nb + 3 * i : 4 + ng + nb + 3 * i] = -Ti * np.eye(3)
            rows_A.append(A)
            rows_b.append(Rwb[i] @ dp0[i] + 0.5 * Ti * Ti * g0)
            A = np.zeros((3, n))
            A[:, 1 : 1 + ng] = -Ti * B
            if nb:
                A[:, 1 + ng : 4 + ng] = -Rwb[i] @ Jdv[i]
            A[:, 1 + ng + nb + 3 * i : 4 + ng + nb + 3 * i] = -np.eye(3)
            A[:, 1 + ng + nb + 3 * (i + 1) : 4 + ng + nb + 3 * (i + 1)] = np.eye(3)
            rows_A.append(A)
            rows_b.append(Rwb[i] @ dv0[i] + Ti * g0)
        A = np.concatenate(rows_A)
        b = np.concatenate(rows_b)
        x, *_ = np.linalg.lstsq(A, b, rcond=None)
        g = g0 + B @ x[1 : 1 + ng]
        ba_est = x[1 + ng : 4 + ng].copy() if nb else np.zeros(3)
        v_est = x[1 + ng + nb :].reshape(K, 3).copy()
        rms_est = float(np.sqrt(np.mean((A @ x - b) ** 2)))
        return float(x[0]), g, ba_est, v_est, rms_est

    if gravity_mag is None:
        s, g, ba, v, rms = solve(None)
    else:
        # the direction from the free solve, then 4 iterations on the |g|
        # sphere, each basis taken at the renormalized g
        _, g, _, _, _ = solve(None)
        for _ in range(4):
            g = g / max(np.linalg.norm(g), 1e-12) * gravity_mag
            s, g, ba, v, rms = solve(g)
        g = g / max(np.linalg.norm(g), 1e-12) * gravity_mag
    return s, g, v, np.asarray(bg), ba, rms
