"""Camera-motion trajectory from a video (port of examples/trajectory.py):
tracks + RANSAC homographies.

Shi-Tomasi corners -> pyramidal sparse LK tracks (K2 builds each frame's
tracking pyramid on the card) -> per-frame-pair RANSAC homography ->
cumulative trajectory of the inter-frame translation.

  python -m optical_flow_tpu_torch.examples.trajectory --input clip.mp4 --frames 10 [--device cpu]
"""

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--corners", type=int, default=300)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from optical_flow_tpu_torch.io.video_reader import read_frames
    from optical_flow_tpu_torch.pipeline.preprocess import bgr_to_gray
    from optical_flow_tpu_torch.track import good_features_to_track, track_features
    from optical_flow_tpu_torch.track.pose import estimate_homography
    from optical_flow_tpu_torch.utils.device import as_tensor, canonical_device, host_array

    device = canonical_device(args.device)
    prev = None
    pts = valid = None
    tx = ty = 0.0
    for i, frame in enumerate(read_frames(args.input, max_frames=args.frames)):
        gray = bgr_to_gray(as_tensor(frame, device))
        if prev is None:
            prev = gray
            pts, valid = good_features_to_track(gray, args.corners, 0.01, 8)
            continue
        new, status, _ = track_features(prev, gray, pts)
        ok = status & valid
        if int(ok.sum()) >= 8:
            H, inl, count = estimate_homography(pts, new, ok)
            H = host_array(H)
            tx += H[0, 2]
            ty += H[1, 2]
            print(
                f"frame {i}: {int(count)}/{int(ok.sum())} inliers  "
                f"dt=({H[0,2]:+.2f},{H[1,2]:+.2f})  cumulative=({tx:+.1f},{ty:+.1f})"
            )
        else:
            print(f"frame {i}: too few tracks ({int(ok.sum())}); skipping pose")
        prev = gray
        pts, valid = good_features_to_track(gray, args.corners, 0.01, 8)
    return 0


if __name__ == "__main__":
    sys.exit(main())
