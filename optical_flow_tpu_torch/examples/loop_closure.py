"""Loop-closure demo (port of examples/loop_closure.py): drift accumulates
along an odometry chain; place recognition finds the revisit; pose-graph
optimization closes the loop.

A camera circles a synthetic textured wall: frames are rendered with real
parallax (depth-dependent disparity), consecutive pairs give essential-
matrix odometry (accumulating drift), the thumbnail place index flags the
first/last revisit pair, geometric verification (sparse-LK matches +
essential RANSAC + Gauss-Newton LO) measures the loop edge, and the
pose graph distributes the drift. Prints endpoint error before/after.

  python -m optical_flow_tpu_torch.examples.loop_closure [--frames 12] [--device cpu]
"""

import argparse
import sys

import numpy as np


def render_loop_frames(n_frames, h=320, w=416, focal=400.0, seed=11):
    """Camera translating around a small closed loop in front of a rocky
    depth field; frame i is the wall remapped by its per-pixel disparity."""
    import cv2

    rng = np.random.RandomState(seed)
    base = cv2.resize(
        rng.rand(80, 104).astype(np.float32), (w, h), interpolation=cv2.INTER_CUBIC
    )
    base = (255 * (base - base.min()) / np.ptp(base)).astype(np.uint8)
    depth = np.clip(
        4.0 + 6.0 * cv2.resize(rng.rand(10, 13).astype(np.float32), (w, h),
                               interpolation=cv2.INTER_CUBIC), 3.0, 12.0
    )
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    inv = focal / depth
    frames, centers = [], []
    for k in range(n_frames):
        th = 2 * np.pi * k / n_frames
        cx_w = 0.12 * np.sin(th)  # camera center, world units
        cy_w = 0.08 * (1 - np.cos(th))
        frames.append(
            cv2.remap(base, (xs + cx_w * inv).astype(np.float32),
                      (ys + cy_w * inv).astype(np.float32), cv2.INTER_LINEAR,
                      borderMode=cv2.BORDER_REFLECT_101)
        )
        centers.append((cx_w, cy_w, 0.0))
    return frames, np.asarray(centers), focal


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from optical_flow_tpu_torch.slam import (
        EssentialRansacConfig,
        PoseGraph,
        estimate_essential,
        normalize_pixels,
        propose_loop_candidates,
        recover_pose,
        refine_pose,
        thumbnail_descriptor,
        verify_loop_closure,
    )
    from optical_flow_tpu_torch.track.features import good_features_to_track
    from optical_flow_tpu_torch.track.sparse_lk import track_features
    from optical_flow_tpu_torch.utils.device import as_tensor, canonical_device, host_array

    device = canonical_device(args.device)
    frames, centers, focal = render_loop_frames(args.frames)
    grays = [as_tensor(f, device) for f in frames]
    h, w = frames[0].shape
    cx, cy = w / 2.0, h / 2.0

    # --- odometry chain: essential matrix per consecutive pair ------------
    Rs = [np.eye(3, dtype=np.float32)]
    ts = [np.zeros(3, np.float32)]
    step_scale = None
    for i in range(len(frames) - 1):
        pts, valid = good_features_to_track(grays[i], 300, 0.01, 8)
        new, status, _ = track_features(grays[i], grays[i + 1], pts)
        ok = valid & status
        p1 = normalize_pixels(pts, focal, cx, cy)
        p2 = normalize_pixels(new, focal, cx, cy)
        E, inl, n = estimate_essential(p1, p2, valid=ok, config=EssentialRansacConfig(seed=i))
        R0, t0, _ = recover_pose(E, p1[inl], p2[inl])
        R1, t1, _ = refine_pose(R0, t0, p1, p2, inliers=inl)
        R1, t1 = host_array(R1), host_array(t1)
        # monocular scale: fix the first step's ground-truth length, reuse
        # it for every step (the loop is near-uniform speed)
        true_len = np.linalg.norm(centers[i + 1] - centers[i])
        if step_scale is None:
            step_scale = true_len
        t1 = t1 * step_scale
        Rs.append((R1 @ Rs[-1]).astype(np.float32))
        ts.append((R1 @ ts[-1] + t1).astype(np.float32))
        print(f"odometry {i}->{i+1}: {int(n)} inliers")
    Rs, ts = np.stack(Rs), np.stack(ts)

    def center_of(R, t):
        return -R.T @ t

    end_err0 = np.linalg.norm(center_of(Rs[-1], ts[-1]) - centers[-1])

    # --- place recognition + loop verification -----------------------------
    descs = [thumbnail_descriptor(g) for g in grays]
    cands = propose_loop_candidates(descs, min_separation=max(3, args.frames - 3))
    print("loop candidates:", [(i, j, round(d, 3)) for i, j, d in cands[:3]])
    graph = PoseGraph.from_odometry(Rs, ts)
    added = 0
    for i, j, _ in cands[:2]:
        got = verify_loop_closure(grays[i], grays[j], focal, cx, cy, min_inliers=25)
        if got is None:
            continue
        R_ij, t_ij, n = got
        # scale the unit loop translation from the ground-truth revisit gap
        gap = np.linalg.norm(centers[j] - centers[i])
        graph.add_edge(i, j, R_ij, t_ij * gap, weight=4.0)
        added += 1
        print(f"loop edge {i}->{j}: {n} inliers")
    if added == 0:
        print("no loop edge verified; exiting")
        return 1

    Rn, tn = graph.optimize(device=device)
    end_err1 = np.linalg.norm(center_of(Rn[-1], tn[-1]) - centers[-1])
    mean0 = np.mean([np.linalg.norm(center_of(R, t) - c)
                     for R, t, c in zip(Rs, ts, centers)])
    mean1 = np.mean([np.linalg.norm(center_of(R, t) - c)
                     for R, t, c in zip(Rn, tn, centers)])
    print(f"endpoint error: {end_err0:.4f} -> {end_err1:.4f} (world units)")
    print(f"mean center error: {mean0:.4f} -> {mean1:.4f}")
    return 0 if end_err1 <= end_err0 else 2


if __name__ == "__main__":
    sys.exit(main())
