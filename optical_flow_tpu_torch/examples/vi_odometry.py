"""Tightly-coupled visual-inertial refinement (port of
examples/vi_odometry.py): metric scale from an IMU.

A monocular SLAM solution is defined only up to scale — and on top of
that, real IMUs carry gyro/accel biases that corrupt naive integration.
This demo builds an up-to-scale visual solution of a known trajectory,
injects realistic sensor biases into its IMU log, and runs the full
tightly-coupled pipeline (`slam.vi_ba.refine_with_imu`):

  1. gyro bias from the bias-free visual rotations (Gauss-Newton),
  2. the linear VI alignment with accel-bias columns + |g| refinement
     -> scale, gravity, velocities,
  3. metric rescale, then JOINT visual-inertial bundle adjustment:
     9-DOF states (pose + velocity), reprojection AND preintegration
     factors through the same sparse-Schur machinery as `slam/ba.py`.

Prints the recovered scale/biases and the absolute (metric!) trajectory
error before and after the joint refinement — no oracle scale fit
anywhere.

With --bias-drift, the injected gyro bias WALKS over the log (real MEMS
behavior): the frozen-bias 9-DOF solve visibly degrades while
`bias_states=True` (15-DOF states with per-keyframe bias deltas +
random-walk factors) tracks the walk and recovers — both are printed
for comparison.

The scene is the JAX package's tests/test_vi_ba.py::_make_scene (8
keyframes 0.5 s apart on an analytic trajectory, 120 landmarks seen by
all, the exact 200 Hz IMU log), copied here as ``make_scene``.

  python -m optical_flow_tpu_torch.examples.vi_odometry [--scale 3.0] [--bias-drift] [--device cpu]
"""

import argparse
import sys

import numpy as np

G_W = np.asarray([0.0, -9.81, 0.0])
FOCAL = 500.0


def trajectory(t):
    """Analytic trajectory: center, world acceleration, world->cam R."""
    import cv2

    om = 2 * np.pi / 8.0
    r, a = 0.4, 0.1
    t = np.asarray(t, np.float64)
    c = np.stack(
        [r * np.sin(om * t), a * (1 - np.cos(2 * om * t)), r * (1 - np.cos(om * t))], -1)
    acc = np.stack(
        [-r * om * om * np.sin(om * t), 4 * a * om * om * np.cos(2 * om * t),
         r * om * om * np.cos(om * t)], -1)

    def rot(ti):
        # time-varying rotation about two different axes (bias estimation
        # needs the axis variety; see slam/imu.py)
        ry, _ = cv2.Rodrigues(np.asarray([0.0, 0.25 * np.sin(om * ti), 0.0]))
        rx, _ = cv2.Rodrigues(np.asarray([0.15 * np.sin(2 * om * ti + 0.5), 0.0, 0.0]))
        return rx @ ry  # world->cam

    R = np.stack([rot(ti) for ti in np.atleast_1d(t)])
    return c, acc, R


def make_scene(K=8, dt_kf=0.5, rate=200.0, seed=0):
    """K keyframes on the analytic trajectory, a landmark cloud observed
    by all of them, and the exact IMU log of each interval."""
    import cv2

    rng = np.random.RandomState(seed)
    kf_t = np.arange(K) * dt_kf
    centers, _, poses = trajectory(kf_t)
    trans = np.einsum("kij,kj->ki", poses, -centers)
    X = np.stack([rng.uniform(-1.2, 1.2, 120), rng.uniform(-0.9, 0.9, 120),
                  rng.uniform(3.0, 6.0, 120)], -1)
    P = len(X)
    Xc = np.einsum("kij,pj->kpi", poses, X) + trans[:, None, :]
    uv_all = FOCAL * Xc[..., :2] / Xc[..., 2:3]
    cam_idx = np.repeat(np.arange(K), P)
    pt_idx = np.tile(np.arange(P), K)
    # IMU: numeric gyro from the relative-rotation log, analytic accel
    n = int(round(dt_kf * rate))
    h = 1.0 / rate
    gyro = np.zeros((K - 1, n, 3))
    accel = np.zeros((K - 1, n, 3))
    dt = np.full((K - 1, n), h)
    for i in range(K - 1):
        for s in range(n):
            t0 = kf_t[i] + s * h
            _, _, R0 = trajectory(t0)
            _, _, R1 = trajectory(t0 + h)
            w, _ = cv2.Rodrigues(R0[0] @ R1[0].T)
            gyro[i, s] = w.ravel() / h
            _, am, Rm = trajectory(t0 + 0.5 * h)
            accel[i, s] = Rm[0] @ (am - G_W)
    return {"kf_t": kf_t, "poses": poses, "trans": trans, "centers": centers, "X": X,
            "cam_idx": np.asarray(cam_idx, np.int32), "pt_idx": np.asarray(pt_idx, np.int32),
            "obs": uv_all.reshape(K * P, 2), "gyro": gyro, "accel": accel, "dt": dt}


def scale_of(states, sc):
    """Mean trajectory-scale ratio vs ground truth (c_0 = 0 by design), and
    the estimated centers."""
    import cv2

    est = np.stack([-cv2.Rodrigues(np.asarray(s[:3], np.float64))[0].T @ np.asarray(s[3:6])
                    for s in states])
    num = np.linalg.norm(est[1:], axis=1)
    den = np.linalg.norm(sc["centers"][1:], axis=1)
    return float(np.mean(num / den)), est


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=3.0,
                    help="true metric scale of the visual solution")
    ap.add_argument("--vis-noise", type=float, default=1.0,
                    help="visual-solution noise level (x the default)")
    ap.add_argument("--bias-drift", action="store_true",
                    help="let the gyro bias WALK over the log and compare "
                    "frozen-bias vs bias-state (15-DOF) refinement")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import cv2

    from optical_flow_tpu_torch.slam.vi_ba import refine_with_imu
    from optical_flow_tpu_torch.utils.device import canonical_device, host_array

    device = canonical_device(args.device)
    sc = make_scene()
    s_true = args.scale
    bg = np.asarray([0.01, -0.008, 0.012])  # rad/s
    ba = np.asarray([0.08, -0.05, 0.10])  # m/s^2

    # a realistic visual solution: small pose/point errors (as windowed BA
    # on noisy tracks would leave) on top of the unknown global scale
    rng = np.random.RandomState(11)
    nz = args.vis_noise
    poses_n = np.stack([cv2.Rodrigues(cv2.Rodrigues(R)[0].ravel() + rng.randn(3) * 2e-3 * nz)[0]
                        for R in sc["poses"]])
    trans_n = sc["trans"] / s_true + rng.randn(*sc["trans"].shape) * 2e-3 * nz
    X_n = sc["X"] / s_true + rng.randn(*sc["X"].shape) * 3e-3 * nz

    gyro_log = sc["gyro"] + bg
    if args.bias_drift:
        # bias walk: b(t) = bg + slope*t (a linear stand-in; see
        # tests/test_vi_ba_bias_states.py)
        slope = np.asarray([0.016, -0.012, 0.014])
        h = sc["dt"][0, 0]
        t = (sc["kf_t"][:-1][:, None] + np.arange(sc["dt"].shape[1])[None, :] * h)[..., None]
        gyro_log = gyro_log + slope * t

    common = (poses_n, trans_n, X_n, sc["cam_idx"], sc["pt_idx"], sc["obs"], FOCAL,
              gyro_log, sc["accel"] + ba, sc["dt"])
    out, info = refine_with_imu(*common, iters=12, device=device)
    if args.bias_drift:
        out_b, info_b = refine_with_imu(*common, iters=12, bias_states=True,
                                        bias_rw_weight=(1e2, 1e2), device=device)
    scale, est = scale_of(host_array(out.states), sc)
    err = np.linalg.norm(est - sc["centers"], axis=1)
    # alignment-only metric trajectory: the noisy visual centers x scale
    cen_n = np.stack([-R.T @ t for R, t in zip(poses_n, trans_n)])
    init_err = np.linalg.norm(cen_n * info["scale"] - sc["centers"], axis=1)
    print(f"true metric scale        : {s_true:.3f}")
    print(f"alignment-recovered scale: {info['scale']:.3f}")
    print(f"gyro bias  true/est      : {bg} / {host_array(info['gyro_bias']).round(4)}")
    print(f"accel bias true/est      : {ba} / {host_array(info['accel_bias']).round(3)}")
    print(f"gravity (world)          : {host_array(info['gravity']).round(3)}")
    print(f"mean |center err| metric : align-only {init_err.mean():.4f} m"
          f" -> joint VI-BA {err.mean():.4f} m")
    print(f"final trajectory scale   : {scale:.4f} (1.0 = metric)")
    if args.bias_drift:
        _, est_b = scale_of(host_array(out_b.states), sc)
        err_b = np.linalg.norm(est_b - sc["centers"], axis=1)
        per_kf = host_array(info_b["gyro_bias_per_kf"])
        walk = per_kf[-1] - per_kf[0]
        print()
        print("-- gyro bias walks over the log --")
        print(f"frozen-bias (9-DOF)  err : {err.mean():.4f} m")
        print(f"bias-state (15-DOF)  err : {err_b.mean():.4f} m")
        print(f"solved bias walk         : {walk.round(4)} rad/s "
              f"(true {tuple(slope)} x {sc['kf_t'][-1]:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
