"""Incremental visual SLAM: the mapper's pieces as one system (port of
optical_flow_tpu/slam/incremental.py).

    corners -> sparse-LK tracks (re-seeding, an appearance drift gate and
               descriptor-based occlusion revival, slam/descriptors.py)
            -> essential-matrix bootstrap (E + cheirality + LO refinement)
            -> PnP keyframe chaining against the live map
            -> triangulation of newly matured tracks
            -> sliding-window BA with track retirement (slam/window.py)
            -> place recognition + geometric loop verification
            -> Sim(3) pose-graph drift correction (slam/pose_graph.py), the
               loop edges carrying Umeyama-measured scale
            -> one global BA over every keyframe after a closed loop

With ``stereo_baseline`` the frames are rectified (left, right) pairs: the
map is metric from frame 0's pair and new landmarks get stereo depth at
their first keyframe (slam/stereo.py).

The device work runs on the call's device (``device``: the card unless it
names another; a tensor frame keeps its own): every frame's tracking
pyramid is built once by kernel K2 and serves two tracking steps, and the
stereo and loop-closure matches build theirs the same way. The bookkeeping
is host numpy, as in the JAX package, and ``SlamResult`` holds numpy
arrays. The host reads device results (track status, inlier counts) at
every frame and keyframe; that is expected and measured (chip_smoke.py
phase 14). As in JAX, batched solves over a varying number of rows are
padded to a multiple of 64 (``_pad64``) and the padded rows are invalid:
they enter no count and no consensus.

Differences from the JAX package: the 8-point and PnP RANSAC sets come
from the port's CPU sampler (slam/epipolar.py, slam/pnp.py), so a whole run
is not bit-equal to JAX's; the graph and the global BA solve in float64.

Monocular caveat: ``window`` must cover a meaningful fraction of any loop
you expect to close; poses frozen out of the window keep their drift.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from optical_flow_tpu_torch.slam.descriptors import (
    match_descriptors,
    ncc_scores,
    patch_descriptors,
)
from optical_flow_tpu_torch.slam.epipolar import (
    EssentialRansacConfig,
    _exp_so3,
    estimate_essential,
    ransac_essential_5pt,
    recover_pose,
    refine_pose,
    triangulate,
)
from optical_flow_tpu_torch.slam.pnp import pnp_ransac, reprojection_errors
from optical_flow_tpu_torch.slam.pose_graph import (
    Sim3PoseGraph,
    _log_so3,
    measure_loop_sim3,
    place_descriptor,
    propose_loop_candidates,
    verify_loop_closure,
)
from optical_flow_tpu_torch.slam.window import WindowedBA
from optical_flow_tpu_torch.utils.device import as_tensor, call_device, host_array


def _aa_to_R(aa) -> np.ndarray:
    return _exp_so3(torch.from_numpy(np.asarray(aa, np.float32))).numpy()


def _R_to_aa(R) -> np.ndarray:
    return _log_so3(torch.from_numpy(np.asarray(R, np.float32))).numpy()


@dataclasses.dataclass
class SlamResult:
    poses: np.ndarray  # (N_kf, 3, 3) world->cam rotations, loop-corrected
    trans: np.ndarray  # (N_kf, 3)
    points: np.ndarray  # (P, 3) map points (world = keyframe-0 camera frame)
    keyframes: List[int]  # source frame index of each keyframe
    loop_edges: List[tuple]  # (i, j, n_inliers) accepted loop closures
    rmse: Optional[float]  # final BA reprojection RMSE (px)
    # the keyframe observations behind the map, in ``ba.BAProblem`` layout
    # (obs centred at the principal point; pt_idx rows of ``points``;
    # obs_baseline nonzero for stereo right-eye measurements)
    cam_idx: Optional[np.ndarray] = None  # (M,) int32
    pt_idx: Optional[np.ndarray] = None  # (M,) int32
    obs: Optional[np.ndarray] = None  # (M, 2)
    obs_baseline: Optional[np.ndarray] = None  # (M,)

    def centers(self) -> np.ndarray:
        return np.stack([-R.T @ t for R, t in zip(self.poses, self.trans)])


def _collect_observations(kf_obs, rig_obs, row_of, cx, cy, stereo_baseline):
    """Every live map point's observations in ``ba.BAProblem`` layout:
    (cam_idx, pt_idx, obs centred at the principal point, baseline), the
    one assembly both the final global BA and the SlamResult export use
    (kf_obs pixels are absolute; rig_obs are centred, with the rig
    baseline)."""
    ci, pi, uv, bl = [], [], [], []
    for kf_i, obs_list in enumerate(kf_obs):
        for p, px in obs_list:
            if p in row_of:
                ci.append(kf_i)
                pi.append(row_of[p])
                uv.append(np.asarray(px, np.float64) - [cx, cy])
                bl.append(0.0)
    for p, kf_i, uv_r in rig_obs:
        if p in row_of:
            ci.append(kf_i)
            pi.append(row_of[p])
            uv.append(np.asarray(uv_r, np.float64))
            bl.append(float(stereo_baseline))
    return ci, pi, uv, bl


def _pad64(*arrays):
    """Pad the row count of host arrays to a multiple of 64 (zero rows,
    which every caller treats as invalid and slices off); returns the
    padded arrays and the true count."""
    n = arrays[0].shape[0]
    m = -(-max(n, 1) // 64) * 64
    if m == n:
        return arrays + (n,)
    out = []
    for a in arrays:
        pad = np.zeros((m - n,) + a.shape[1:], a.dtype)
        out.append(np.concatenate([np.asarray(a), pad]))
    return tuple(out) + (n,)


def incremental_slam(
    frames,
    focal: float,
    cx: Optional[float] = None,
    cy: Optional[float] = None,
    *,
    max_corners: int = 300,
    min_tracks: int = 60,
    window: int = 5,
    ba_iters: int = 4,
    # keyframes of baseline before a track is triangulated: adjacent
    # keyframes' parallax is usually too thin
    triangulate_after: int = 2,
    loop_min_separation: int = 6,
    loop_min_inliers: int = 40,
    # the bootstrap pair must have real parallax (median track disparity,
    # px): a thin-baseline map leaves point depths ill-conditioned
    bootstrap_min_disparity: float = 8.0,
    # adaptive keyframes: a frame becomes a keyframe once the median track
    # disparity since the last keyframe exceeds this (px), or the live
    # track set thins below min_tracks; 0 = every frame is a keyframe
    kf_min_disparity: float = 0.0,
    # appearance drift gate: a track whose NCC against its anchor falls
    # below this dies even though LK reports status 1; 0 disables the gate
    # and revival
    track_ncc_gate: float = 0.25,
    # revival: a fresh corner whose descriptor mutually matches a dead map
    # track's anchor at >= this NCC, and lies within revive_px_radius of the
    # landmark's reprojection, revives that landmark
    revive_min_ncc: float = 0.8,
    revive_px_radius: float = 20.0,
    # after a verified loop closure, re-anchor the map to the corrected
    # poses and run one global BA
    final_global_ba: bool = True,
    # rectified stereo rig: frames are (left, right) pairs or (2, H, W)
    # stacks and the map is metric in baseline units
    stereo_baseline: Optional[float] = None,
    stereo_max_dy: float = 1.5,
    ransac: EssentialRansacConfig = EssentialRansacConfig(),
    device=None,
) -> Optional[SlamResult]:
    """Run the incremental pipeline over gray frames, a list or any
    iterator: frames are consumed streaming and only keyframe frames are
    kept (for relocalization and loop closure). By default every frame
    becomes a keyframe; set kf_min_disparity for adaptive keyframes on real
    video. Frames go to ``device`` (default: the card; a tensor frame keeps
    its device), and without a card the default raises. Returns None when
    the bootstrap pair can't produce a map."""
    from optical_flow_tpu_torch.track import good_features_to_track, track_features
    from optical_flow_tpu_torch.track.sparse_lk import build_tracking_pyramid

    it = iter(frames)
    dev = None

    def _next():
        nonlocal dev
        try:
            f = next(it)
        except StopIteration:
            return None
        if stereo_baseline is not None:
            if isinstance(f, (tuple, list)):
                l, r = f
            else:
                if f.shape[0] != 2:
                    raise ValueError(
                        "stereo frames must be (left, right) pairs or "
                        f"(2, H, W) stacks, got shape {tuple(f.shape)}"
                    )
                l, r = f[0], f[1]
        else:
            l, r = f, None
        if dev is None:
            dev = call_device(l, device=device)
        return (as_tensor(l, dev, torch.float32).contiguous(),
                None if r is None else as_tensor(r, dev, torch.float32).contiguous())

    first = _next()
    second_pair = _next()
    if first is None or second_pair is None:
        raise ValueError("incremental_slam needs >= 2 frames")
    frame0, right0 = first
    second, second_right = second_pair
    h, w = frame0.shape[-2:]
    cx = w / 2.0 if cx is None else cx
    cy = h / 2.0 if cy is None else cy

    def norm(px):
        return ((np.asarray(px, np.float32) - np.asarray([cx, cy], np.float32))
                / np.float32(focal))

    def descs_at(img, px):
        padded, n = _pad64(np.asarray(px, np.float32))
        return host_array(patch_descriptors(img, padded))[:n].copy()

    def corners(img):
        pts, valid = good_features_to_track(img, max_corners, 0.01, 8)
        return host_array(pts).astype(np.float32), host_array(valid).astype(bool)

    def reproj(R, t, X, x):
        on = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
        return host_array(reprojection_errors(on(R), on(t), on(X), on(x)))

    # --- live track table ------------------------------------------------
    # each row: current pixel, anchor keyframe + anchor pixel (for
    # triangulation), map point id (-1 until triangulated), alive flag, and
    # the appearance anchor (descriptor, the drift and revival gate)
    cur_px, alive = corners(frame0)
    alive = alive.copy()
    anchor_kf = np.zeros(len(cur_px), np.int32)
    anchor_px = cur_px.copy()
    anchor_desc = descs_at(frame0, cur_px)
    point_id = np.full(len(cur_px), -1, np.int64)
    next_pid = 0

    mapper = WindowedBA(window=window, focal=focal, ba_iters=ba_iters, device=dev)
    kf_R = [np.eye(3, dtype=np.float32)]
    kf_t = [np.zeros(3, np.float32)]
    kf_obs: List[list] = [[]]  # per keyframe: [(pid, absolute pixel)]
    bootstrapped = False
    rmse = None
    last_kf_px = cur_px.copy()  # track positions at the last keyframe...
    kf_seen = alive.copy()  # ...and which rows were alive there
    keyframes: List[int] = []
    rig_obs: List[tuple] = []  # (pid, keyframe, centred right-eye pixel)

    def _stereo_new_points(left, right, rows, R, t):
        """{row: (X_world, uv_right)} for the track rows whose stereo match
        passed the epipolar and disparity gates, back-projected at metric
        depth and lifted into the world by the keyframe pose."""
        from optical_flow_tpu_torch.slam.stereo import stereo_backproject, stereo_match

        if not len(rows):
            return {}
        px, n_s = _pad64(cur_px[rows])
        disp, okd, matched = stereo_match(left, right, px, max_dy=stereo_max_dy)
        disp, okd, matched = disp[:n_s], okd[:n_s], matched[:n_s]
        Xc = stereo_backproject(cur_px[rows], disp, focal, cx, cy, stereo_baseline)
        # X_cam = R X_w + t  =>  X_w = R^T (X_cam - t)
        Xw = (Xc - np.asarray(t, np.float32)) @ np.asarray(R, np.float32)
        return {int(r): (Xw[i], matched[i]) for i, r in enumerate(rows) if okd[i]}

    def _try_stereo_bootstrap(left, right, src_idx):
        """Metric map from one stereo pair, keyframe 0 at this frame's left
        camera; False when too few gated matches (the caller re-seeds on the
        next frame and retries)."""
        nonlocal bootstrapped, next_pid
        rows = np.flatnonzero(alive)
        found = _stereo_new_points(left, right, rows, np.eye(3), np.zeros(3))
        if len(found) < 16:
            return False
        new_points, obs = {}, []
        for row, (Xw, uv_r) in found.items():
            pid = next_pid
            next_pid += 1
            point_id[row] = pid
            new_points[pid] = Xw.astype(np.float64)
            obs.append((pid, cur_px[row] - [cx, cy]))
            obs.append((pid, uv_r - [cx, cy], stereo_baseline))
            rig_obs.append((pid, 0, uv_r - [cx, cy]))
        mapper.add_keyframe(np.zeros(6), obs, new_points)
        kf_obs[0] = [(int(point_id[r]), cur_px[r].copy()) for r in found]
        # no optimize() here: a one-camera BA is gauge-degenerate
        bootstrapped = True
        keyframes.append(src_idx)
        kept[src_idx] = left
        return True

    def pose6(R, t):
        return np.concatenate([_R_to_aa(R), np.asarray(t, np.float64)])

    def pull_poses():
        # the BA-refined poses back into the odometry chain
        for i_s, p6_s in enumerate(mapper.poses):
            kf_R[i_s] = _aa_to_R(p6_s[:3]).astype(np.float32)
            kf_t[i_s] = np.asarray(p6_s[3:], np.float32)

    desc_cache = {}
    kept = {}  # keyframe frames only (relocalization and loop store)
    if stereo_baseline is None:
        mapper.add_keyframe(np.zeros(6), [])  # keyframe 0 at the origin
        kept[0] = frame0
    else:
        _try_stereo_bootstrap(frame0, right0, 0)

    def frame_descriptor(idx):
        # each keyframe's place descriptor is computed once
        if idx not in desc_cache:
            desc_cache[idx] = place_descriptor(kept[idx])
        return desc_cache[idx]

    def _stream():
        # (k, prev, cur, cur_right, is_last), one frame of lookahead
        k, prev, cur = 0, (frame0, right0), (second, second_right)
        while cur is not None:
            k += 1
            nxt = _next()
            yield (k, prev[0]) + cur + (nxt is None,)
            prev, cur = cur, nxt

    prev_pyr = None
    for k, prev, cur, cur_right, is_last in _stream():
        # -- track everything one frame forward; each frame's pyramid (K2)
        # is built once and serves as prev on the next step
        if prev_pyr is None:
            prev_pyr = build_tracking_pyramid(prev)
        cur_pyr = build_tracking_pyramid(cur)
        new_px, status, _ = track_features(prev, cur, cur_px, pyr1=prev_pyr, pyr2=cur_pyr)
        prev_pyr = cur_pyr
        new_px = host_array(new_px).astype(np.float32)
        alive &= host_array(status).astype(bool)
        cur_px = np.where(alive[:, None], new_px, cur_px)

        if track_ncc_gate > 0 and alive.any():
            # appearance drift gate; flat-at-birth anchors are exempt
            s = ncc_scores(anchor_desc, descs_at(cur, cur_px))
            no_anchor = np.abs(anchor_desc).sum(axis=1) < 1e-6
            alive &= no_anchor | (s >= track_ncc_gate)

        if not bootstrapped and stereo_baseline is not None:
            # the first pair was too thin: rebuild the track table on this
            # frame and bootstrap from its pair
            cur_px, alive = corners(cur)
            alive = alive.copy()
            anchor_kf = np.zeros(len(cur_px), np.int32)
            anchor_px = cur_px.copy()
            anchor_desc = descs_at(cur, cur_px)
            point_id = np.full(len(cur_px), -1, np.int64)
            _try_stereo_bootstrap(cur, cur_right, k)
            last_kf_px = cur_px.copy()
            kf_seen = alive.copy()
            continue

        if not bootstrapped:
            # -- bootstrap: essential matrix on anchor (= frame 0) vs current
            sel = alive & (anchor_kf == 0)
            if sel.sum() < 16:
                return None
            disp = np.linalg.norm(cur_px - anchor_px, axis=1)[sel]
            if np.median(disp) < bootstrap_min_disparity:
                continue  # keep accumulating baseline
            p1n, p2n = norm(anchor_px), norm(cur_px)
            # minimal 5-point hypotheses; the 8-point batch is the fallback
            try:
                E, inl, count = ransac_essential_5pt(p1n, p2n, valid=sel, config=ransac,
                                                     device=dev)
            except (RuntimeError, np.linalg.LinAlgError):
                E, inl, count = estimate_essential(p1n, p2n, valid=sel, config=ransac,
                                                   device=dev)
            if int(count) < 16:
                continue  # not enough parallax yet
            inl_np = host_array(inl).astype(bool)
            R0, t0, _ = recover_pose(E, p1n[inl_np], p2n[inl_np], device=dev)
            R1, t1, _ = refine_pose(R0, t0, p1n, p2n, inliers=inl_np, device=dev)
            R1, t1 = host_array(R1), host_array(t1)  # |t1| = 1 sets the scale
            P1 = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
            P2 = np.concatenate([R1, t1[:, None]], axis=1)
            X = host_array(triangulate(P1, P2, p1n[inl_np], p2n[inl_np], device=dev))
            # both-view cheirality and reprojection gate
            Z2 = (X @ R1.T + t1)[:, 2]
            Xb, xb, n_b = _pad64(np.asarray(X, np.float32), p2n[inl_np])
            e_b = reproj(R1, t1, Xb, xb)[:n_b]
            good = (X[:, 2] > 0.1) & (Z2 > 0.1) & (e_b < 5.0 / focal)
            ids = np.flatnonzero(inl_np)[good]
            kf_R.append(R1)
            kf_t.append(t1.astype(np.float32))
            new_points = {}
            obs = []
            for row, Xw in zip(ids, X[good]):
                pid = next_pid
                next_pid += 1
                point_id[row] = pid
                new_points[pid] = Xw
                obs.append((pid, cur_px[row] - [cx, cy]))
            mapper.add_keyframe(pose6(R1, t1), obs, new_points)
            # frame-0 observations of the same points anchor the gauge
            for row in ids:
                mapper.add_observation(point_id[row], 0, anchor_px[row] - [cx, cy])
            kf_obs[0] = [(int(point_id[r]), anchor_px[r].copy()) for r in ids]
            kf_obs.append([(int(point_id[r]), cur_px[r].copy()) for r in ids])
            rmse = mapper.optimize()
            pull_poses()
            bootstrapped = True
            keyframes = [0, k]
            kept[k] = cur
            last_kf_px = cur_px.copy()
            kf_seen = alive.copy()
            continue

        # -- adaptive keyframes: frames that added no baseline are tracked
        # but not keyframed (the last frame always is)
        if kf_min_disparity > 0 and not is_last:
            moved = alive & kf_seen
            if moved.sum() >= 8 and alive.sum() >= min_tracks:
                med = float(np.median(np.linalg.norm((cur_px - last_kf_px)[moved], axis=1)))
                if med < kf_min_disparity:
                    continue

        # -- localize against the live map (PnP on tracked map points)
        has_pt = alive & (point_id >= 0)
        live_pids = point_id[has_pt]
        in_map = np.asarray([pid in mapper.points for pid in live_pids], dtype=bool)
        rows = np.flatnonzero(has_pt)[in_map]

        def attempt_relocalize():
            """Tracking lost: the closest keyframes by place descriptor, their
            landmark observations LK-tracked into this frame, robust PnP. On
            success, appends the recovered keyframe and rebuilds the track
            table from this frame; False = still lost."""
            nonlocal cur_px, alive, anchor_px, anchor_kf, point_id, rmse
            nonlocal last_kf_px, kf_seen, anchor_desc
            allpts = mapper.all_points()
            d = place_descriptor(cur)
            dists = [float(np.linalg.norm(frame_descriptor(i) - d)) for i in keyframes]
            for kf_i in np.argsort(dists)[:3]:
                obs_list = [(p, px) for p, px in kf_obs[kf_i] if p in allpts]
                if len(obs_list) < 12:
                    continue
                src = np.asarray([px for _, px in obs_list], np.float32)
                new, st, _ = track_features(kept[keyframes[kf_i]], cur, src)
                st = host_array(st).astype(bool)
                if st.sum() < 12:
                    continue
                Xl = np.stack([allpts[p] for p, _ in obs_list])
                new = host_array(new).astype(np.float32)
                Xlp, xlp, stp, n_r = _pad64(np.asarray(Xl, np.float32), norm(new), st)
                Rr, tr, inl = pnp_ransac(Xlp, xlp, valid=stp, seed=1000 + k, device=dev)
                inl = host_array(inl)[:n_r]
                if int(inl.sum()) < 12:
                    continue
                Rr, tr = host_array(Rr), host_array(tr)
                kf_R.append(Rr.astype(np.float32))
                kf_t.append(np.asarray(tr, np.float32))
                keyframes.append(k)
                kept[k] = cur
                mapper.add_keyframe(pose6(Rr, tr), [
                    (p, px_new - [cx, cy])
                    for (p, _), px_new, ok in zip(obs_list, new, inl)
                    if ok and p in mapper.points  # retired points can't re-enter
                ])
                kf_obs.append([(p, px_new.copy())
                               for (p, _), px_new, ok in zip(obs_list, new, inl) if ok])
                rmse = mapper.optimize()
                pull_poses()
                # rebuild the track table: re-tracked landmarks first, fresh
                # corners for future structure
                kf_now = len(kf_R) - 1
                land = [(p, px_new) for (p, _), px_new, ok in zip(obs_list, new, inl) if ok]
                fresh, fvalid = corners(cur)
                fresh = fresh[fvalid]
                cur_px = np.concatenate([np.asarray([px for _, px in land], np.float32), fresh])
                anchor_px = cur_px.copy()
                anchor_kf = np.full(len(cur_px), kf_now, np.int32)
                point_id = np.concatenate([np.asarray([p for p, _ in land], np.int64),
                                           np.full(len(fresh), -1, np.int64)])
                alive = np.ones(len(cur_px), bool)
                anchor_desc = descs_at(cur, cur_px)
                last_kf_px = cur_px.copy()
                kf_seen = alive.copy()
                return True
            return False

        if len(rows) < 8:
            attempt_relocalize()
            continue
        X = np.stack([mapper.points[point_id[r]] for r in rows])
        Xp, xp, n_rows = _pad64(np.asarray(X, np.float32), norm(cur_px[rows]))
        vmask = np.arange(len(Xp)) < n_rows
        R, t, inliers = pnp_ransac(Xp, xp, valid=vmask, seed=k, device=dev)
        inliers = host_array(inliers)[:n_rows]
        # 12 inliers when >= 12 landmarks are live; 3/4 support on a sparse
        # stretch (8-11 live)
        if len(rows) >= 12:
            need = max(12, len(rows) // 4)
        else:
            need = max(6, (3 * len(rows)) // 4)
        if int(inliers.sum()) < need:
            # the pose didn't explain the tracked landmarks: tracking loss
            attempt_relocalize()
            continue
        R, t = host_array(R), host_array(t)
        kf_R.append(R.astype(np.float32))
        kf_t.append(np.asarray(t, np.float32))
        keyframes.append(k)
        kept[k] = cur

        obs = [(int(point_id[r]), cur_px[r] - [cx, cy]) for r, ok in zip(rows, inliers) if ok]

        # -- new map points
        kf_now = len(kf_R) - 1
        new_points = {}
        new_rows = {}  # pid -> table row
        if stereo_baseline is not None:
            # stereo depth the moment a track is seen from a keyframe; rows
            # whose match fails fall through to triangulation below
            rows_s = np.flatnonzero(alive & (point_id < 0))
            for row, (Xw, uv_r) in _stereo_new_points(cur, cur_right, rows_s, R, t).items():
                pid = next_pid
                next_pid += 1
                point_id[row] = pid
                new_rows[pid] = int(row)
                new_points[pid] = Xw.astype(np.float64)
                obs.append((pid, cur_px[row] - [cx, cy]))
                obs.append((pid, uv_r - [cx, cy], stereo_baseline))
                rig_obs.append((pid, kf_now, uv_r - [cx, cy]))
        # -- triangulate matured anchor tracks
        mature = alive & (point_id < 0) & (anchor_kf <= kf_now - 1 - triangulate_after)
        if mature.sum() >= 4:
            rows_m = np.flatnonzero(mature)
            aks = anchor_kf[rows_m]
            for ak in np.unique(aks):
                sel_m = rows_m[aks == ak]
                Pa = np.concatenate([kf_R[ak], kf_t[ak][:, None]], axis=1)
                Pb = np.concatenate([R, t[:, None]], axis=1)
                ta, tb, n_m = _pad64(norm(anchor_px[sel_m]), norm(cur_px[sel_m]))
                Xn = host_array(triangulate(Pa, Pb, ta, tb, device=dev))[:n_m]
                # cheirality and reprojection gate in both views
                Za = (Xn @ kf_R[ak].T + kf_t[ak])[:, 2]
                Zb = (Xn @ R.T + t)[:, 2]
                Xq, xq, n_m2 = _pad64(np.asarray(Xn, np.float32), norm(cur_px[sel_m]))
                e = reproj(R, t, Xq, xq)[:n_m2]
                ok = (Za > 0.1) & (Zb > 0.1) & (e < 5.0 / focal)
                for row, Xw, o in zip(sel_m, Xn, ok):
                    if not o:
                        continue
                    pid = next_pid
                    next_pid += 1
                    point_id[row] = pid
                    new_rows[pid] = int(row)
                    new_points[pid] = Xw
                    obs.append((pid, cur_px[row] - [cx, cy]))

        mapper.add_keyframe(pose6(R, t), obs, new_points)
        for pid, row in new_rows.items():
            ak = int(anchor_kf[row])
            mapper.add_observation(pid, ak, anchor_px[row] - [cx, cy])
            # the anchor view also enters the per-keyframe index (it feeds
            # relocalization, the final global BA and the export)
            if ak != kf_now:
                kf_obs[ak].append((pid, anchor_px[row].copy()))
        # the index keeps left-eye pixels only (rig entries have 3 fields)
        kf_obs.append([(int(e[0]), np.asarray(e[1]) + [cx, cy]) for e in obs if len(e) == 2])
        rmse = mapper.optimize()
        pull_poses()

        # -- re-seed when the live track set thins out
        if alive.sum() < min_tracks:
            fresh, fvalid = corners(cur)
            fresh = fresh[fvalid]
            consumed = np.zeros(len(fresh), bool)
            fresh_desc = None
            if track_ncc_gate > 0 and len(fresh):
                # appearance revival: a fresh corner that mutually matches a
                # dead map track's anchor is that landmark back from occlusion
                dead_map = np.flatnonzero(~alive & (point_id >= 0))
                dead_map = np.asarray([r for r in dead_map if point_id[r] in mapper.points],
                                      np.int64)
                fresh_desc = descs_at(cur, fresh)
                if len(dead_map):
                    idx, okm = match_descriptors(fresh_desc, anchor_desc[dead_map],
                                                 min_score=revive_min_ncc, device=dev)
                    Rk = np.asarray(kf_R[kf_now], np.float64)
                    tk = np.asarray(kf_t[kf_now], np.float64)
                    for j in np.flatnonzero(okm):
                        r = dead_map[idx[j]]
                        # geometric gate: near the landmark's reprojection
                        Xc = Rk @ np.asarray(mapper.points[point_id[r]], np.float64) + tk
                        if Xc[2] <= 0.1:
                            continue
                        pred = focal * Xc[:2] / Xc[2] + np.asarray([cx, cy])
                        if np.linalg.norm(fresh[j] - pred) > revive_px_radius:
                            continue
                        cur_px[r] = fresh[j]
                        alive[r] = True
                        consumed[j] = True
            # the other fresh corners take dead slots as new tracks
            left = np.flatnonzero(~consumed)
            dead = np.flatnonzero(~alive)
            take = min(len(dead), len(left))
            src = left[:take]
            cur_px[dead[:take]] = fresh[src]
            anchor_px[dead[:take]] = fresh[src]
            anchor_kf[dead[:take]] = kf_now
            point_id[dead[:take]] = -1
            alive[dead[:take]] = True
            if track_ncc_gate > 0 and take:
                if fresh_desc is None:
                    fresh_desc = descs_at(cur, fresh)
                anchor_desc[dead[:take]] = fresh_desc[src]
        if track_ncc_gate > 0:
            # refresh the appearance anchors at every keyframe a track
            # survives (anchor_px/anchor_kf stay at birth: they are the
            # triangulation baseline)
            live_rows = np.flatnonzero(alive)
            if len(live_rows):
                anchor_desc[live_rows] = descs_at(cur, cur_px[live_rows])
        last_kf_px = cur_px.copy()
        kf_seen = alive.copy()

    if not bootstrapped:
        return None

    # --- loop closure + Sim(3) pose graph --------------------------------
    # loop edges are full similarities (scale from Umeyama alignment of
    # shared structure); when that measurement fails the edge degrades to
    # s = 1 with the translation scaled from the current estimate
    descs = [frame_descriptor(i) for i in keyframes]
    cands = propose_loop_candidates(descs, min_separation=loop_min_separation)
    sgraph = Sim3PoseGraph.from_se3_odometry(np.stack(kf_R), np.stack(kf_t))
    loop_edges = []
    pts = mapper.all_points()
    for i, j, _ in cands[:3]:
        got = verify_loop_closure(kept[keyframes[i]], kept[keyframes[j]], focal, cx, cy,
                                  min_inliers=loop_min_inliers, max_corners=max_corners)
        if got is None:
            continue
        R_ij, t_ij, n = got
        sim = measure_loop_sim3(kept[keyframes[i]], kept[keyframes[j]], kf_obs[i], kf_obs[j],
                                pts, kf_R[i], kf_t[i], kf_R[j], kf_t[j])
        if sim is not None:
            # the structure-measured rotation must agree with the verified
            # epipolar rotation
            s_ij, R_s, t_s, _ = sim
            cosang = (np.trace(R_s.T @ R_ij) - 1.0) / 2.0
            if cosang < np.cos(np.radians(10.0)):
                sim = None
        if sim is not None:
            sgraph.add_edge(i, j, s_ij, R_s, t_s, weight=4.0)
        else:
            ci = -kf_R[i].T @ kf_t[i]
            cj = -kf_R[j].T @ kf_t[j]
            sgraph.add_edge(i, j, 1.0, R_ij, t_ij * np.linalg.norm(cj - ci), weight=4.0)
        loop_edges.append((i, j, n))
    if loop_edges:
        ss, Rn, tn = sgraph.optimize(device=dev)
        # SE(3)-ize the similarity nodes: the camera (R, t/s) sees every ray
        # of (s, R, t) unchanged and keeps its centre
        tn = (tn / ss[:, None]).astype(np.float32)
        if final_global_ba and pts:
            # re-anchor each point to its first observing keyframe, then one
            # global BA over every keyframe and observation
            anchors = {}
            for kf_i, obs_list in enumerate(kf_obs):
                for p, _ in obs_list:
                    anchors.setdefault(p, kf_i)
            for p, X in pts.items():
                a = anchors.get(p, 0)
                X_cam = kf_R[a] @ X + kf_t[a]
                # full similarity inverse: X_w = R^T (X_cam / s - t_sim / s)
                pts[p] = Rn[a].T @ (X_cam / ss[a] - tn[a])
            from optical_flow_tpu_torch.slam.ba import BAProblem, bundle_adjust, reprojection_rmse

            pids = sorted(pts)
            pidx = {p: i for i, p in enumerate(pids)}
            # every stereo right-eye measurement re-enters the global BA, so
            # the refinement stays metric
            ci, pi, uv, bl = _collect_observations(kf_obs, rig_obs, pidx, cx, cy, stereo_baseline)
            cams = np.stack([np.concatenate([_R_to_aa(R), t]) for R, t in zip(Rn, tn)])

            def on(x, dtype):
                return torch.from_numpy(np.asarray(x, dtype)).to(dev)

            prob = BAProblem(
                on(cams, np.float64), on(np.stack([pts[p] for p in pids]), np.float64),
                on(ci, np.int32), on(pi, np.int32), on(np.stack(uv), np.float64), focal,
                on(np.ones(len(ci)), np.float64), on(bl, np.float64),
            )
            # Huber loss: one wrong association must not drag the whole
            # loop-corrected trajectory
            refined, _ = bundle_adjust(prob, iters=ba_iters, robust_delta=3.0)
            rmse = float(reprojection_rmse(refined))
            cams_r = host_array(refined.cams)
            Rn = np.stack([_aa_to_R(c[:3]) for c in cams_r]).astype(np.float32)
            tn = cams_r[:, 3:].astype(np.float32)
            pts = {p: x for p, x in zip(pids, host_array(refined.points))}
    else:
        Rn, tn = np.stack(kf_R), np.stack(kf_t)

    pid_list = list(pts)
    points = np.stack([pts[p] for p in pid_list]) if pts else np.zeros((0, 3))
    # export the observations behind the map (BAProblem layout, centred)
    row_of = {p: i for i, p in enumerate(pid_list)}
    o_ci, o_pi, o_uv, o_bl = _collect_observations(kf_obs, rig_obs, row_of, cx, cy,
                                                   stereo_baseline)
    return SlamResult(
        poses=np.asarray(Rn), trans=np.asarray(tn), points=points, keyframes=keyframes,
        loop_edges=loop_edges, rmse=rmse, cam_idx=np.asarray(o_ci, np.int32),
        pt_idx=np.asarray(o_pi, np.int32),
        obs=np.stack(o_uv) if o_uv else np.zeros((0, 2)), obs_baseline=np.asarray(o_bl),
    )
