"""Structure from motion from gray frames: tracks -> pose -> 3D map ->
bundle-adjusted reconstruction (port of optical_flow_tpu/slam/frontend.py).

Shi-Tomasi corners seeded on the first frame are tracked with pyramidal
sparse LK (``track_features``, whose two tracking pyramids kernel K2 builds
on the card), the essential matrix and relative pose come from batched
RANSAC, the inlier tracks are triangulated, intermediate keyframes are
localized by PnP, and the Schur-complement bundle adjuster refines cameras
and points in float64. Everything runs on the call's device: tensors stay
on theirs, host frames go to the card unless ``device`` names another.
Results are host numpy, as the JAX package returns them; ``problem`` is the
refined ``BAProblem`` of device tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from optical_flow_tpu_torch.slam.ba import BAProblem, bundle_adjust, reprojection_rmse
from optical_flow_tpu_torch.slam.epipolar import (
    EssentialRansacConfig,
    estimate_essential,
    normalize_pixels,
    recover_pose,
    triangulate,
)
from optical_flow_tpu_torch.slam.pnp import pnp_dlt
from optical_flow_tpu_torch.track import good_features_to_track, track_features
from optical_flow_tpu_torch.track.sparse_lk import SparseLKConfig
from optical_flow_tpu_torch.utils.device import as_tensor, call_device


@dataclasses.dataclass
class MultiViewReconstruction:
    cams: np.ndarray  # (N, 6) axis-angle + translation (camera 0 = identity)
    points: np.ndarray  # (P, 3) in the camera-0 frame
    tracks: np.ndarray  # (N, P, 2) pixel observations of the kept tracks
    rmse_before: float
    rmse_after: float
    problem: BAProblem


@dataclasses.dataclass
class TwoViewReconstruction:
    R: np.ndarray  # (3, 3) cam1 -> cam2 rotation
    t: np.ndarray  # (3,) unit-norm translation
    points: np.ndarray  # (P, 3) in the camera-1 frame
    pts1: np.ndarray  # (P, 2) pixel observations in frame 1
    pts2: np.ndarray  # (P, 2) pixel observations in frame 2
    rmse_before: float
    rmse_after: float
    problem: BAProblem  # the refined BA problem


def _rotmat_to_axis_angle(R: np.ndarray) -> np.ndarray:
    cos = np.clip((np.trace(R) - 1) / 2, -1, 1)
    th = np.arccos(cos)
    if th < 1e-8:
        return np.zeros(3)
    if th > np.pi - 1e-3:
        # near 180 deg the antisymmetric part vanishes; take the axis from
        # the dominant column of (R + I)/2 = axis axis^T (stable branch)
        M = (R + np.eye(3)) / 2.0
        c = int(np.argmax(np.diag(M)))
        axis = M[:, c] / max(np.sqrt(M[c, c]), 1e-12)
        axis /= np.linalg.norm(axis)
        # sign from the largest antisymmetric component, if any
        anti = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        if np.dot(anti, axis) < 0:
            axis = -axis
        return axis * th
    axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / (2 * np.sin(th))
    return axis * th


def _init_two_view(n_a, n_b, mask, ransac):
    """Essential -> pose -> triangulation -> cheirality keep on normalized
    correspondences (K, 2) tensors. Returns (R, t, X, sel) with sel (host
    int64) indexing the K slots, or None when fewer than 16 points survive
    any stage."""
    E, inl, _ = estimate_essential(n_a, n_b, mask, ransac)
    inl = inl & mask
    if int(inl.sum()) < 16:
        return None
    R, t, _ = recover_pose(E, n_a[inl], n_b[inl])
    P1 = torch.eye(3, 4, dtype=torch.float32, device=n_a.device)
    P2 = torch.cat([R, t[:, None]], dim=1)
    X = triangulate(P1, P2, n_a[inl], n_b[inl])
    z_a = X[:, 2]
    z_b = (X @ R.mT + t)[:, 2]
    keep = ((z_a > 1e-6) & (z_b > 1e-6)).cpu().numpy()
    if keep.sum() < 16:
        return None
    sel = np.flatnonzero(inl.cpu().numpy())[keep]
    return R.cpu().numpy(), t.cpu().numpy(), X[torch.from_numpy(keep).to(X.device)], sel


def _refine_ba(cams, X, cam_idx, pt_idx, obs, focal, ba_iters):
    """Assemble + run BA in float64 on X's device; returns (problem,
    rmse_before, rmse_after), keeping whichever model reprojects better."""
    dev = X.device
    prob = BAProblem(
        torch.from_numpy(cams).to(dev), X.to(torch.float64),
        torch.from_numpy(cam_idx).to(dev), torch.from_numpy(pt_idx).to(dev), obs, focal,
    )
    rmse0 = float(reprojection_rmse(prob))
    refined, _ = bundle_adjust(prob, iters=ba_iters, lam=1e-3)
    rmse1 = float(reprojection_rmse(refined))
    if not np.isfinite(rmse1) or rmse1 > rmse0:
        return prob, rmse0, rmse0
    return refined, rmse0, rmse1


def two_view_reconstruct(
    img1,
    img2,
    focal: float,
    cx: Optional[float] = None,
    cy: Optional[float] = None,
    max_corners: int = 300,
    ba_iters: int = 8,
    lk_config: SparseLKConfig = SparseLKConfig(),
    ransac: EssentialRansacConfig = EssentialRansacConfig(),
    *,
    device=None,
) -> Optional[TwoViewReconstruction]:
    """Structure from motion on one gray frame pair (H, W).

    Returns None when too few inlier tracks survive (< 16).
    """
    dev = call_device(img1, img2, device=device)
    img1 = as_tensor(img1, dev)
    img2 = as_tensor(img2, dev)
    h, w = img1.shape[-2:]
    cx = w / 2.0 if cx is None else cx
    cy = h / 2.0 if cy is None else cy

    pts, valid = good_features_to_track(img1, max_corners, 0.01, 8)
    new, status, _ = track_features(img1, img2, pts, lk_config)
    ok = status & valid
    if int(ok.sum()) < 16:
        return None

    n1 = normalize_pixels(pts, focal, cx, cy)
    n2 = normalize_pixels(new, focal, cx, cy)
    init = _init_two_view(n1, n2, ok, ransac)
    if init is None:
        return None
    R, t, X, sel = init
    sel_t = torch.from_numpy(sel).to(dev)
    p1_px = pts[sel_t]
    p2_px = new[sel_t]

    # the BA problem in pixel units (cameras: axis-angle + t)
    P = X.shape[0]
    cams = np.zeros((2, 6))
    cams[1, :3] = _rotmat_to_axis_angle(R)
    cams[1, 3:] = t
    cam_idx = np.concatenate([np.zeros(P, np.int32), np.ones(P, np.int32)])
    pt_idx = np.concatenate([np.arange(P, dtype=np.int32)] * 2)
    c = torch.tensor([cx, cy], dtype=torch.float64).to(dev)
    obs = torch.cat([p1_px.to(torch.float64) - c, p2_px.to(torch.float64) - c])
    refined, rmse0, rmse1 = _refine_ba(cams, X, cam_idx, pt_idx, obs, focal, ba_iters)

    return TwoViewReconstruction(
        R=R, t=t, points=refined.points.cpu().numpy(), pts1=p1_px.cpu().numpy(),
        pts2=p2_px.cpu().numpy(), rmse_before=rmse0, rmse_after=rmse1, problem=refined,
    )


def multi_view_reconstruct(
    frames,
    focal: float,
    cx: Optional[float] = None,
    cy: Optional[float] = None,
    max_corners: int = 300,
    ba_iters: int = 8,
    lk_config: SparseLKConfig = SparseLKConfig(),
    ransac: EssentialRansacConfig = EssentialRansacConfig(),
    *,
    device=None,
) -> Optional[MultiViewReconstruction]:
    """Incremental SfM over N >= 3 gray frames (the keyframe chain).

    Corners seeded on frame 0 are tracked through every frame (chained
    sparse LK, each link ``track_features(frames[i-1], frames[i], ...)``
    with its own two K2 pyramids; a track dies when any link fails); the
    widest-baseline pair (0, N-1) initializes pose and map by the essential
    matrix; intermediate keyframes are localized against the map by DLT PnP;
    one global Schur-complement BA refines all cameras and points. Returns
    None when fewer than 16 tracks survive.
    """
    N = len(frames)
    if N < 3:
        raise ValueError("multi_view_reconstruct needs >= 3 frames")
    dev = call_device(*frames, device=device)
    frames = [as_tensor(f, dev) for f in frames]
    h, w = frames[0].shape[-2:]
    cx = w / 2.0 if cx is None else cx
    cy = h / 2.0 if cy is None else cy

    # --- track chains ------------------------------------------------------
    pts0, alive = good_features_to_track(frames[0], max_corners, 0.01, 8)
    tracks = [pts0]
    for i in range(1, N):
        new, status, _ = track_features(frames[i - 1], frames[i], tracks[i - 1], lk_config)
        tracks.append(new)
        alive = alive & status
    if int(alive.sum()) < 16:
        return None
    tracks = torch.stack(tracks)  # (N, K, 2)

    # --- two-view init on the widest baseline (0, N-1) ---------------------
    norm = [normalize_pixels(tracks[i], focal, cx, cy) for i in range(N)]
    init = _init_two_view(norm[0], norm[-1], alive, ransac)
    if init is None:
        return None
    R_last, t_last, X, sel = init  # sel indexes the K corner slots
    P = len(sel)
    sel_t = torch.from_numpy(sel).to(dev)

    # --- localize intermediate frames by PnP -------------------------------
    cams = np.zeros((N, 6))
    cams[N - 1, :3] = _rotmat_to_axis_angle(R_last)
    cams[N - 1, 3:] = t_last
    for i in range(1, N - 1):
        Ri, ti = pnp_dlt(X, norm[i][sel_t])
        cams[i, :3] = _rotmat_to_axis_angle(Ri.cpu().numpy())
        cams[i, 3:] = ti.cpu().numpy()

    # --- global BA ---------------------------------------------------------
    cam_idx = np.repeat(np.arange(N, dtype=np.int32), P)
    pt_idx = np.tile(np.arange(P, dtype=np.int32), N)
    kept = tracks[:, sel_t]  # (N, P, 2)
    c = torch.tensor([cx, cy], dtype=torch.float64).to(dev)
    obs = (kept.to(torch.float64) - c).reshape(N * P, 2)
    refined, rmse0, rmse1 = _refine_ba(cams, X, cam_idx, pt_idx, obs, focal, ba_iters)

    return MultiViewReconstruction(
        cams=refined.cams.cpu().numpy(), points=refined.points.cpu().numpy(),
        tracks=kept.cpu().numpy(), rmse_before=rmse0, rmse_after=rmse1, problem=refined,
    )
