"""Interop with the standard optical-flow and SLAM evaluation formats (the
port's own copy of optical_flow_tpu/utils/interop.py, numpy only; the
KITTI PNG functions import cv2 when called).

- Middlebury `.flo`: the interchange format of the dense-flow benchmarks
  (Middlebury/Sintel/KITTI tooling): magic float 202021.25, int32
  width/height, row-major interleaved (u, v) float32.
- KITTI 16-bit flow PNG: channels (u, v, valid), u16 = flow * 64 + 2^15.
- TUM trajectory text: the format of the TUM-RGBD and evo evaluation tools,
  one `timestamp tx ty tz qx qy qz qw` line per pose, CAMERA-TO-WORLD
  (SlamResult stores world->cam); with nearest-timestamp association, ATE
  and RPE, what `python -m optical_flow_tpu_torch slam --out-tum/--eval-tum`
  uses.
"""

from __future__ import annotations

import numpy as np

_FLO_MAGIC = 202021.25


def save_flo(path, u, v) -> None:
    """Write a dense flow field as Middlebury .flo."""
    u = np.asarray(u, np.float32)
    v = np.asarray(v, np.float32)
    if u.ndim != 2 or u.shape != v.shape:
        raise ValueError(f"u/v must be matching (H, W); got {u.shape} {v.shape}")
    H, W = u.shape
    with open(path, "wb") as f:
        np.float32(_FLO_MAGIC).tofile(f)
        np.asarray([W, H], np.int32).tofile(f)
        np.stack([u, v], axis=-1).astype("<f4").tofile(f)


def load_flo(path):
    """Read a Middlebury .flo file -> (u (H, W), v (H, W)) float32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, 1)
        if magic.size != 1 or magic[0] != np.float32(_FLO_MAGIC):
            raise ValueError(f"{path}: not a .flo file (magic {magic})")
        W, H = np.fromfile(f, np.int32, 2)
        data = np.fromfile(f, "<f4", int(W) * int(H) * 2)
    if data.size != W * H * 2:
        raise ValueError(f"{path}: truncated .flo payload")
    uv = data.reshape(int(H), int(W), 2)
    return uv[..., 0].copy(), uv[..., 1].copy()


def save_kitti_flow(path, u, v, valid=None) -> None:
    """Write flow as a KITTI 16-bit PNG: channels (u, v, valid) with
    u16 = flow * 64 + 2^15 (the KITTI devkit encoding, +-512 px range);
    `path` should end in .png. Requires cv2 (16-bit PNG encoder)."""
    import cv2

    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    if u.ndim != 2 or u.shape != v.shape:
        raise ValueError(f"u/v must be matching (H, W); got {u.shape} {v.shape}")
    if valid is None:
        valid = np.ones(u.shape, bool)
    enc = lambda f: np.clip(f * 64.0 + 2.0 ** 15, 0, 65535).astype(np.uint16)
    img = np.stack(
        [np.asarray(valid, np.uint16), enc(v), enc(u)], axis=-1
    )  # cv2 writes BGR: file channels come out (u, v, valid)
    if not cv2.imwrite(str(path), img):
        raise IOError(f"cv2.imwrite failed for {path}")


def load_kitti_flow(path):
    """Read a KITTI flow PNG -> (u, v, valid) — inverse of
    `save_kitti_flow`; invalid pixels carry flow 0."""
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img is None or img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint16:
        raise ValueError(f"{path}: not a KITTI 16-bit flow PNG")
    valid = img[..., 0] > 0
    dec = lambda c: (img[..., c].astype(np.float64) - 2.0 ** 15) / 64.0
    u = np.where(valid, dec(2), 0.0)
    v = np.where(valid, dec(1), 0.0)
    return u, v, valid


def rotation_to_quaternion(R) -> np.ndarray:
    """(3,3) rotation -> unit quaternion (qx, qy, qz, qw), TUM order.

    Shepperd's method (branch on the largest diagonal term) — stable for
    every rotation, unlike the naive trace formula near 180 degrees."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        qx = 0.25 * s
        qw = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 1] + R[1, 0]) / s
        qz = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        qy = 0.25 * s
        qw = (R[0, 2] - R[2, 0]) / s
        qx = (R[0, 1] + R[1, 0]) / s
        qz = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        qz = 0.25 * s
        qw = (R[1, 0] - R[0, 1]) / s
        qx = (R[0, 2] + R[2, 0]) / s
        qy = (R[1, 2] + R[2, 1]) / s
    q = np.asarray([qx, qy, qz, qw])
    return q / np.linalg.norm(q)


def save_tum_trajectory(path, timestamps, poses, trans) -> None:
    """Write world->cam keyframe poses as a TUM trajectory file.

    timestamps: (K,) seconds; poses/trans: (K,3,3)/(K,3) world->cam
    (`SlamResult.poses/.trans`). TUM wants camera-to-world: the camera
    center c = -R^T t and orientation R^T, as
    `timestamp tx ty tz qx qy qz qw` — consumable by evo/TUM tooling
    (`evo_traj tum <path>`)."""
    timestamps = np.asarray(timestamps, np.float64)
    poses = np.asarray(poses, np.float64)
    trans = np.asarray(trans, np.float64)
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for ts, R, t in zip(timestamps, poses, trans):
            c = -R.T @ t
            q = rotation_to_quaternion(R.T)
            f.write(
                f"{ts:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )


def load_tum_trajectory(path):
    """Read a TUM trajectory -> (timestamps (K,), poses (K,3,3) world->cam,
    trans (K,3)) — the inverse of `save_tum_trajectory`."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(x) for x in line.split()])
    if not rows:
        raise ValueError(f"{path}: empty TUM trajectory")
    arr = np.asarray(rows, np.float64)
    if arr.shape[1] != 8:
        raise ValueError(f"{path}: expected 8 columns, got {arr.shape[1]}")
    ts = arr[:, 0]
    cs = arr[:, 1:4]
    qs = arr[:, 4:8]
    poses = np.stack([_quaternion_to_rotation(q).T for q in qs])  # world->cam
    trans = np.stack([-R @ c for R, c in zip(poses, cs)])
    return ts, poses, trans


def associate_by_timestamp(ts_a, ts_b, max_diff: float = 0.02):
    """Greedy nearest-timestamp association (the TUM tooling's rule):
    returns (idx_a, idx_b) index arrays of matched pairs with
    |ts_a - ts_b| <= max_diff, each pose used at most once."""
    ts_a = np.asarray(ts_a, np.float64)
    ts_b = np.asarray(ts_b, np.float64)
    cands = [
        (abs(ta - tb), i, j)
        for i, ta in enumerate(ts_a)
        for j, tb in enumerate(ts_b)
        if abs(ta - tb) <= max_diff
    ]
    cands.sort()
    used_a, used_b = set(), set()
    ia, ib = [], []
    for _, i, j in cands:
        if i in used_a or j in used_b:
            continue
        used_a.add(i)
        used_b.add(j)
        ia.append(i)
        ib.append(j)
    ia = np.asarray(ia, np.int64)
    ib = np.asarray(ib, np.int64)
    order = np.argsort(ia)
    return ia[order], ib[order]


def ate_rmse(est_centers, ref_centers, *, align: str = "sim3"):
    """Absolute trajectory error (the TUM/evo headline metric).

    est_centers/ref_centers: (K, 3) camera centers, index-associated.
    align: 'sim3' (Umeyama with scale — monocular convention), 'se3'
    (rigid only — stereo/VI metric convention), or 'none'.
    Returns (rmse, per_pose_errors (K,), (s, R, t) applied to est)."""
    est = np.asarray(est_centers, np.float64)
    ref = np.asarray(ref_centers, np.float64)
    if est.shape != ref.shape or est.ndim != 2 or est.shape[1] != 3:
        raise ValueError(f"need matching (K, 3); got {est.shape} {ref.shape}")
    if align == "none":
        s, R, t = 1.0, np.eye(3), np.zeros(3)
    else:
        mu_e, mu_r = est.mean(0), ref.mean(0)
        E, F = est - mu_e, ref - mu_r
        U, D, Vt = np.linalg.svd(F.T @ E / len(est))
        S = np.eye(3)
        if np.linalg.det(U) * np.linalg.det(Vt) < 0:
            S[2, 2] = -1.0
        R = U @ S @ Vt
        var_e = (E * E).sum() / len(est)
        s = float(np.trace(np.diag(D) @ S) / max(var_e, 1e-18)) if align == "sim3" else 1.0
        t = mu_r - s * R @ mu_e
    aligned = (s * (R @ est.T)).T + t
    err = np.linalg.norm(aligned - ref, axis=1)
    return float(np.sqrt(np.mean(err**2))), err, (s, R, t)


def rpe_stats(est_poses, est_trans, ref_poses, ref_trans, delta: int = 1):
    """Relative pose error over pose pairs (i, i+delta): drift per step,
    immune to global alignment. est/ref poses are world->cam (K,3,3) with
    translations (K,3). Returns dict with translational RMSE (units of
    the trajectories) and rotational RMSE (radians)."""
    eP = np.asarray(est_poses, np.float64)
    eT = np.asarray(est_trans, np.float64)
    rP = np.asarray(ref_poses, np.float64)
    rT = np.asarray(ref_trans, np.float64)
    K = len(eP)
    if not (len(eT) == len(rP) == len(rT) == K) or K <= delta:
        raise ValueError("need matching trajectories longer than delta")
    terrs, rerrs = [], []
    for i in range(K - delta):
        # relative motion cam_i -> cam_{i+d}: T_rel = T_{i+d} T_i^{-1}
        def rel(P, T):
            Ri, ti = P[i], T[i]
            Rj, tj = P[i + delta], T[i + delta]
            R = Rj @ Ri.T
            t = tj - R @ ti
            return R, t

        Re, te = rel(eP, eT)
        Rr, tr = rel(rP, rT)
        dR = Re.T @ Rr
        dt = te - tr
        terrs.append(np.linalg.norm(dt))
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1.0, 1.0))
        rerrs.append(ang)
    terrs = np.asarray(terrs)
    rerrs = np.asarray(rerrs)
    return {
        "trans_rmse": float(np.sqrt(np.mean(terrs**2))),
        "rot_rmse_rad": float(np.sqrt(np.mean(rerrs**2))),
        "n_pairs": len(terrs),
    }


def _quaternion_to_rotation(q) -> np.ndarray:
    x, y, z, w = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.asarray(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )
