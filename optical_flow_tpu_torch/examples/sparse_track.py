"""Sparse feature tracking demo (port of examples/sparse_track.py), the
reference's of.cpp.

The reference demo (of.cpp:21-101) seeds 500 Shi-Tomasi corners on webcam
frames and tracks them with 31x31 / 3-level pyramidal LK, drawing tracks
red/green by x-direction. This demo runs on a video file headless and
writes a track-overlay PNG per frame.

  python -m optical_flow_tpu_torch.examples.sparse_track --input clip.mp4 --frames 8 [--device cpu]
"""

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--corners", type=int, default=500)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from optical_flow_tpu_torch.io.video_reader import read_frames
    from optical_flow_tpu_torch.pipeline.preprocess import bgr_to_gray
    from optical_flow_tpu_torch.track import good_features_to_track, track_features
    from optical_flow_tpu_torch.utils.device import as_tensor, canonical_device, host_array
    from optical_flow_tpu_torch.utils.viz import draw_arrows, save_png

    device = canonical_device(args.device)
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    prev_gray = None
    pts = valid = None
    for i, frame in enumerate(read_frames(args.input, max_frames=args.frames)):
        gray = bgr_to_gray(as_tensor(frame, device))
        if prev_gray is None:
            prev_gray = gray
            pts, valid = good_features_to_track(gray, args.corners, 0.01, 10)
            print(f"frame {i}: seeded {int(valid.sum())} corners")
            continue
        new, status, err = track_features(prev_gray, gray, pts)
        status = host_array(status & valid)
        moved = host_array(new) - host_array(pts)
        print(
            f"frame {i}: tracked {int(status.sum())}/{len(status)} "
            f"median |flow| {np.median(np.linalg.norm(moved[status], axis=-1)) if status.any() else 0:.2f} px"
        )
        if args.out:
            overlay = draw_arrows(frame[..., ::-1], host_array(pts), moved, mask=status)
            save_png(overlay, os.path.join(args.out, f"tracks_{i:04d}.png"))
        prev_gray = gray
        pts = new
        # re-seed when too many tracks die (of.cpp:82 re-detects each frame)
        if status.sum() < args.corners // 4:
            pts, valid = good_features_to_track(gray, args.corners, 0.01, 10)
        else:
            valid = as_tensor(status, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
