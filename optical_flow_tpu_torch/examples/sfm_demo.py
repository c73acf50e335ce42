"""Multi-view structure-from-motion demo (port of examples/sfm_demo.py).

Renders an N-frame parallax sequence over a random depth field (or takes a
real video), then: corners -> chained sparse LK tracks -> essential-matrix
init -> PnP keyframe localization -> global Schur-complement bundle
adjustment. Prints the recovered trajectory and writes a top-down map
scatter (PNG) if --out is given.

  python -m optical_flow_tpu_torch.examples.sfm_demo [--device cpu] [--frames 4] [--out DIR]
  python -m optical_flow_tpu_torch.examples.sfm_demo --input video.mp4 --focal 800
"""

import argparse
import os
import sys

import numpy as np


def render_sequence(n, seed=9, h=320, w=416, focal=400.0, step=0.05):
    import cv2

    rng = np.random.RandomState(seed)
    base = cv2.resize(
        rng.rand(80, 104).astype(np.float32), (w, h), interpolation=cv2.INTER_CUBIC
    )
    base = (255 * (base - base.min()) / np.ptp(base)).astype(np.uint8)
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    depth = np.clip(
        4.0 + 6.0 * cv2.resize(rng.rand(10, 13).astype(np.float32), (w, h),
                               interpolation=cv2.INTER_CUBIC), 3.0, 12.0
    )
    frames = [base]
    for k in range(1, n):
        disp = focal * step * k / depth
        frames.append(
            cv2.remap(base, xs + disp, ys, cv2.INTER_LINEAR,
                      borderMode=cv2.BORDER_REFLECT_101)
        )
    return frames, focal


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default=None, help="video file (default: rendered synthetic)")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--focal", type=float, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from optical_flow_tpu_torch.slam.frontend import multi_view_reconstruct
    from optical_flow_tpu_torch.utils.device import as_tensor, canonical_device

    device = canonical_device(args.device)
    if args.input:
        from optical_flow_tpu_torch.io.video_reader import read_frames
        from optical_flow_tpu_torch.pipeline.preprocess import bgr_to_gray

        frames = [bgr_to_gray(as_tensor(f, device))
                  for f in read_frames(args.input, max_frames=args.frames)]
        if not frames:
            sys.exit(f"no frames decoded from {args.input}")
        focal = args.focal or 0.9 * frames[0].shape[1]
    else:
        frames, focal = render_sequence(args.frames)
        frames = [as_tensor(f, device) for f in frames]
        focal = args.focal or focal

    if len(frames) < 3:
        sys.exit(f"need at least 3 frames, got {len(frames)}")
    rec = multi_view_reconstruct(frames, focal)
    if rec is None:
        sys.exit("reconstruction failed: too few surviving tracks")
    print(f"{len(frames)} frames, {len(rec.points)} map points")
    print(f"reprojection RMSE: {rec.rmse_before:.3f} -> {rec.rmse_after:.3f} px")
    for i, cam in enumerate(rec.cams):
        print(
            f"cam {i}: rot |{np.linalg.norm(cam[:3]):.4f}| rad, "
            f"t = ({cam[3]:+.3f}, {cam[4]:+.3f}, {cam[5]:+.3f})"
        )
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        # top-down (x, z) map scatter rendered as a PNG heat grid
        pts = rec.points
        H = W = 256
        img = np.zeros((H, W), np.float32)
        xlo, xhi = np.percentile(pts[:, 0], [2, 98])
        zlo, zhi = np.percentile(pts[:, 2], [2, 98])
        xi = np.clip(((pts[:, 0] - xlo) / max(xhi - xlo, 1e-9) * (W - 1)), 0, W - 1).astype(int)
        zi = np.clip(((pts[:, 2] - zlo) / max(zhi - zlo, 1e-9) * (H - 1)), 0, H - 1).astype(int)
        img[H - 1 - zi, xi] = 1.0
        from optical_flow_tpu_torch.utils.viz import save_png

        save_png((np.stack([img] * 3, -1) * 255).astype(np.uint8),
                 os.path.join(args.out, "map_topdown.png"))
        print(f"wrote {args.out}/map_topdown.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
