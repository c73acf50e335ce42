"""A dry run of the distributed surface over an n-slot mesh (port of
``__graft_entry__.dryrun_multichip``), in three legs:

  1. the full pipeline step, preprocess -> diff features -> the sharded
     pyramidal flow -> gesture, on a mesh with a real frames axis (frame
     parallelism and 2-D tiling with halo exchange);
  2. sharded 15-DOF visual-inertial BA: points and observations sharded
     over the mesh, the camera system summed across it, the states, IMU
     factors and bias Jacobians replicated;
  3. the sparse tracker on a textured pair.

    python -c "from optical_flow_tpu_torch.dryrun import dryrun_multichip; dryrun_multichip(4)"
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from optical_flow_tpu_torch.config import FlowConfig, GestureConfig, PreprocessConfig
from optical_flow_tpu_torch.parallel.mesh import FlowMesh, flow_mesh, mesh_factorization
from optical_flow_tpu_torch.parallel.sharded_flow import sharded_coarse_to_fine
from optical_flow_tpu_torch.pipeline.gesture import detect_gesture
from optical_flow_tpu_torch.pipeline.preprocess import diff_features, preprocess_frame
from optical_flow_tpu_torch.slam.ba import BAProblem
from optical_flow_tpu_torch.slam.imu import preintegrate_with_bias_jacobians
from optical_flow_tpu_torch.slam.vi_ba import sharded_vi_bundle_adjust, vi_problem_from_ba
from optical_flow_tpu_torch.track.sparse_lk import SparseLKConfig, track_features


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> dict:
    """Run the three legs on an ``n_devices``-slot mesh over ``devices``
    (default: the cards of this process, repeated to fill the slots) and
    return what each produced; any failure raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass devices=['cpu'] * n to run on the CPU")
        devices = [f"cuda:{i % torch.cuda.device_count()}" for i in range(n_devices)]
    frames_n, rows_n, cols_n = mesh_factorization(n_devices)
    if frames_n == 1 and n_devices % 2 == 0:
        # mesh_factorization maximizes the spatial grid, so its frames axis
        # is degenerate; this run certifies frame parallelism, so a real
        # frames axis is forced where the count allows
        frames_n = 2
        f2, r2, c2 = mesh_factorization(n_devices // 2)
        rows_n, cols_n = f2 * r2, c2
    mesh = flow_mesh(frames_n, rows_n, cols_n, devices=devices)
    u, v, votes = _pipeline_step(mesh, frames_n)
    vi = _sharded_vi_ba(mesh)
    tracked = _sparse_lk(mesh.home)
    return {"mesh": dict(mesh.shape), "flow_shape": tuple(u.shape), "votes": votes.tolist(),
            **vi, "tracked": tracked}


def _pipeline_step(mesh: FlowMesh, frames_n: int):
    """Leg 1: B frames (a warm-up pair plus one pair a frames shard) through
    preprocess, diff features, the sharded flow and the gesture."""
    B = 2 * frames_n + 2
    H = W = 64
    pre = PreprocessConfig(size=(H, W), faithful_uint8=False)
    # the production warp pairing: clamped quantized shift_sep tiles
    flow_cfg = FlowConfig(levels=3, warp_clamp=4.0, warp_impl="shift_sep")
    rng = np.random.RandomState(0)
    frames = torch.from_numpy(rng.rand(B, 72, 96, 3).astype(np.float32) * 255.0).to(mesh.home)
    grays = preprocess_frame(frames, pre)
    diffs = diff_features(grays[1:], grays[:-1], pre)
    u, v = sharded_coarse_to_fine(diffs[:-1], diffs[1:], mesh, flow_cfg.levels, config=flow_cfg,
                                  min_tile=8)
    votes = detect_gesture(u, v, GestureConfig()).votes
    if tuple(u.shape) != (B - 2, H, W):
        raise AssertionError(f"flow of shape {tuple(u.shape)}")
    if not (torch.isfinite(u).all() and torch.isfinite(v).all()):
        raise AssertionError("the sharded flow is not finite")
    return u, v, votes


def _sharded_vi_ba(mesh: FlowMesh) -> dict:
    """Leg 2: sharded bias-state VI-BA on a synthetic scene: a camera
    moving at constant velocity with no rotation, every point seen by every
    keyframe, an exact IMU log (accel = -g)."""
    C, P_pts = 4, 2 * mesh.size  # points divide the mesh
    dt_kf, rate = 0.5, 100.0
    vel = np.asarray([0.2, 0.0, 0.1])
    g_w = np.asarray([0.0, -9.81, 0.0])
    centers = vel[None, :] * (np.arange(C) * dt_kf)[:, None]
    cams = np.concatenate([np.zeros((C, 3)), -centers], -1)  # R = I
    rng = np.random.RandomState(0)
    X = np.stack([rng.uniform(-1.0, 1.0, P_pts), rng.uniform(-0.8, 0.8, P_pts),
                  rng.uniform(3.0, 5.0, P_pts)], -1)
    focal = 300.0
    # observations grouped by owning shard (point-major), pt_idx shard-local
    pt_idx = np.repeat(np.arange(P_pts), C)
    cam_idx = np.tile(np.arange(C), P_pts)
    Xc = X[:, None, :] + cams[None, :, 3:6]
    obs = (focal * Xc[..., :2] / Xc[..., 2:3]).reshape(P_pts * C, 2)
    n = int(dt_kf * rate)
    gyro = np.zeros((C - 1, n, 3), np.float32)
    accel = np.tile((-g_w).astype(np.float32), (C - 1, n, 1))
    dt = np.full((C - 1, n), 1.0 / rate, np.float32)
    dR, dv, dp, J = preintegrate_with_bias_jacobians(gyro, accel, dt, device=mesh.home)
    pert = cams.copy()
    pert[1:, 3:] += rng.randn(C - 1, 3) * 0.01

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=mesh.home)

    base = BAProblem(cams=t(pert), points=t(X + rng.randn(*X.shape) * 0.01),
                     cam_idx=t(cam_idx, torch.int64),
                     pt_idx=t(pt_idx % (P_pts // mesh.size), torch.int64), obs=t(obs), focal=focal)
    prob = vi_problem_from_ba(base, np.tile(vel, (C, 1)), dR, dv, dp, np.full(C - 1, dt_kf), g_w,
                              bias_jac=J)
    if prob.states.shape != (C, 15):
        raise AssertionError(f"states of shape {tuple(prob.states.shape)}")
    out, hist = sharded_vi_bundle_adjust(prob, mesh, iters=2)
    if not (torch.isfinite(out.states).all() and torch.isfinite(out.points).all()):
        raise AssertionError("the sharded VI-BA is not finite")
    return {"vi_states": tuple(out.states.shape), "vi_history": hist.tolist()}


def _sparse_lk(device) -> int:
    """Leg 3: the sparse tracker on a textured pair shifted by (1, 2) px."""
    rng = np.random.RandomState(1)
    img1 = rng.rand(96, 128).astype(np.float32) * 255.0
    img2 = np.roll(img1, (1, 2), axis=(0, 1))
    pts = np.stack([rng.uniform(20, 108, 16), rng.uniform(20, 76, 16)], -1).astype(np.float32)
    new_pts, status, _ = track_features(img1, img2, pts, SparseLKConfig(win=15, max_level=1),
                                        device=device)
    if not torch.isfinite(new_pts).all():
        raise AssertionError("the tracked points are not finite")
    if not status.any():
        raise AssertionError("no feature tracked on texture")
    return int(status.sum())
