"""Stereo SLAM demo (port of examples/stereo_slam.py): why a rectified rig
makes the map METRIC.

Renders a geometrically exact synthetic scene (textured surface with
smooth depth 3-12, camera on a small loop), runs the SAME incremental
pipeline twice:

  1. monocular  — trajectory correct up to an arbitrary scale (the
     |t|=1 bootstrap gauge); absolute centers are meaningless.
  2. stereo     — `stereo_baseline=0.3`: metric bootstrap from frame
     0's pair, per-keyframe stereo landmarks, right-eye observations in
     every BA — absolute centers in baseline units, no scale fit.

  python -m optical_flow_tpu_torch.examples.stereo_slam [--device cpu] [--frames 10]
"""

import argparse
import sys

import numpy as np


def make_scene(h=320, w=416, focal=400.0, seed=11):
    import cv2

    rng = np.random.RandomState(seed)
    base = cv2.resize(rng.rand(80, 104).astype(np.float32), (w, h),
                      interpolation=cv2.INTER_CUBIC)
    base = (255 * (base - base.min()) / np.ptp(base)).astype(np.uint8)
    depth = np.clip(4.0 + 6.0 * cv2.resize(
        rng.rand(10, 13).astype(np.float32), (w, h),
        interpolation=cv2.INTER_CUBIC), 3.0, 12.0)
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    return base, depth, xs, ys, focal


def view(base, depth, xs, ys, focal, cx_w, cy_w):
    """Exact render from camera center (cx_w, cy_w, 0): the dest->source
    map u = x + f c / d(u) solved by fixed point (see
    tests/test_stereo_slam.py for the derivation)."""
    import cv2

    u, v = xs.copy(), ys.copy()
    for _ in range(8):
        d = cv2.remap(depth, u, v, cv2.INTER_LINEAR,
                      borderMode=cv2.BORDER_REPLICATE)
        u = (xs + focal * float(cx_w) / d).astype(np.float32)
        v = (ys + focal * float(cy_w) / d).astype(np.float32)
    return cv2.remap(base, u, v, cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_REFLECT_101)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--baseline", type=float, default=0.3)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from optical_flow_tpu_torch.slam import incremental_slam
    from optical_flow_tpu_torch.utils.device import canonical_device

    device = canonical_device(args.device)
    base, depth, xs, ys, focal = make_scene()
    pairs, centers = [], []
    for k in range(args.frames):
        th = 2 * np.pi * k / args.frames
        c = (0.12 * np.sin(th), 0.08 * (1 - np.cos(th)))
        pairs.append((view(base, depth, xs, ys, focal, *c),
                      view(base, depth, xs, ys, focal, c[0] + args.baseline, c[1])))
        centers.append((c[0], c[1], 0.0))

    kw = dict(loop_min_separation=20, min_tracks=40, window=8, device=device)
    mono = incremental_slam([l for l, _ in pairs], focal, **kw)
    stereo = incremental_slam(pairs, focal, stereo_baseline=args.baseline, **kw)
    if mono is None or stereo is None:
        print("bootstrap failed (not enough parallax or tracks)")
        return 1

    t_m = np.asarray([centers[i] for i in mono.keyframes])
    e_m = mono.centers()
    raw_m = np.linalg.norm(e_m - t_m, axis=1).mean()
    s_fit = np.linalg.norm(t_m[1]) / max(np.linalg.norm(e_m[1]), 1e-12)
    fit_m = np.linalg.norm(e_m * s_fit - t_m, axis=1).mean()

    t_s = np.asarray([centers[i] for i in stereo.keyframes])
    e_s = stereo.centers()
    raw_s = np.linalg.norm(e_s - t_s, axis=1).mean()

    print(f"loop radius 0.12, baseline {args.baseline}")
    print(f"monocular: raw center error {raw_m:.4f} "
          f"(meaningless scale; after oracle scale fit x{s_fit:.2f}: {fit_m:.4f})")
    print(f"stereo:    raw center error {raw_s:.4f} (METRIC - no fit)")
    print(f"stereo map: {stereo.points.shape[0]} landmarks, median depth "
          f"{np.median(stereo.points[:, 2]):.2f} (true band 3-12)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
