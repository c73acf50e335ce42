"""Video stabilization (port of examples/stabilize.py): tracks +
homographies + inverse warps.

A capability demo composed entirely from engine pieces: Shi-Tomasi
corners -> sparse pyramidal LK -> RANSAC homography per frame pair ->
accumulated motion -> each frame warped back toward the first frame's
coordinates with the engine's remap.

  python -m optical_flow_tpu_torch.examples.stabilize --input clip.mp4 --frames 30 --out DIR [--device cpu]
"""

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--corners", type=int, default=300)
    ap.add_argument("--out", default=None, help="write stabilized PNGs here")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from optical_flow_tpu_torch.io.video_reader import read_frames
    from optical_flow_tpu_torch.ops.warp import remap_bilinear
    from optical_flow_tpu_torch.pipeline.preprocess import bgr_to_gray
    from optical_flow_tpu_torch.track import good_features_to_track, track_features
    from optical_flow_tpu_torch.track.pose import estimate_homography
    from optical_flow_tpu_torch.utils.device import as_tensor, canonical_device, host_array
    from optical_flow_tpu_torch.utils.viz import save_png

    device = canonical_device(args.device)
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    H_acc = np.eye(3)
    prev_gray = None
    jitter = []
    for i, frame in enumerate(read_frames(args.input, max_frames=args.frames)):
        frame_t = as_tensor(frame, device)
        gray = bgr_to_gray(frame_t)
        h, w = gray.shape
        if prev_gray is not None:
            pts, valid = good_features_to_track(prev_gray, args.corners, 0.01, 8)
            new, status, _ = track_features(prev_gray, gray, pts)
            ok = status & valid
            if int(ok.sum()) >= 8:
                Hf, _, _ = estimate_homography(pts, new, ok)
                H_acc = host_array(Hf).astype(np.float64) @ H_acc
        prev_gray = gray

        # inverse-warp the frame toward frame 0: sample at H_acc applied to
        # the output grid (maps output pixels back into this frame)
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
        coords = np.stack([xs, ys, np.ones_like(xs)], axis=0).reshape(3, -1)
        mapped = H_acc @ coords
        mx = (mapped[0] / mapped[2]).reshape(h, w).astype(np.float32)
        my = (mapped[1] / mapped[2]).reshape(h, w).astype(np.float32)
        # one call for all three channels: remap_bilinear takes leading axes
        stab_chw = remap_bilinear(frame_t.permute(2, 0, 1).contiguous(),
                                  as_tensor(mx, device), as_tensor(my, device))
        stab = host_array(stab_chw).transpose(1, 2, 0)
        jitter.append((H_acc[0, 2], H_acc[1, 2]))
        print(
            f"frame {i}: cumulative motion ({H_acc[0,2]:+7.2f}, {H_acc[1,2]:+7.2f}) px"
        )
        if args.out:
            save_png(stab[..., ::-1], os.path.join(args.out, f"stab_{i:04d}.png"))
    if jitter:
        j = np.asarray(jitter)
        print(
            f"motion range stabilized: x [{j[:,0].min():.1f}, {j[:,0].max():.1f}] "
            f"y [{j[:,1].min():.1f}, {j[:,1].max():.1f}] px over {len(j)} frames"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
