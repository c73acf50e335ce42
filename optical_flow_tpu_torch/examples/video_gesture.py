"""Video gesture tracking demo (port of examples/video_gesture.py).

The reference flagship (ParallelVideoPyr.cpp:730-905) captures a webcam,
preprocesses each frame, runs 4-level pyramidal LK on consecutive diffs,
and draws a circle at the motion centroid. This demo runs the same pipeline
on a video file (headless: writes PNG dumps instead of imshow) with
per-frame timing like the reference's printf timers. ``--fast`` runs
``VideoConfig.fast()`` at ``--size`` (K2, K1 and K3 on the card) in place
of the reference-parity default (K1 and S1).

  python -m optical_flow_tpu_torch.examples.video_gesture --input clip.mp4 \
      --frames 8 --out /tmp/gesture_out [--fast] [--device cpu]
"""

import argparse
import os
import sys
import time

from optical_flow_tpu_torch.config import IMPL_NAMES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--size", type=int, default=256, help="square preprocess size (reference: 1080)")
    ap.add_argument("--out", default=None, help="directory for flow/overlay PNG dumps")
    ap.add_argument("--impl", default="auto", choices=list(IMPL_NAMES))
    ap.add_argument("--fast", action="store_true",
                    help="VideoConfig.fast() at --size (default: the reference-parity VideoConfig)")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from optical_flow_tpu_torch.config import video_config_for
    from optical_flow_tpu_torch.io.video_reader import read_frames
    from optical_flow_tpu_torch.pipeline.video import VideoPipeline
    from optical_flow_tpu_torch.utils.device import host_array
    from optical_flow_tpu_torch.utils.viz import annotate_gesture_frame, flow_to_color, save_png

    cfg = video_config_for("fast" if args.fast else "faithful", (args.size, args.size), args.impl)
    pipe = VideoPipeline(cfg, device=args.device)

    if args.out:
        os.makedirs(args.out, exist_ok=True)

    frames = list(read_frames(args.input, max_frames=args.frames))
    print(f"{len(frames)} frames from {args.input}")
    n = 0
    for i, res in enumerate(pipe.run(iter(frames))):
        t0 = time.perf_counter()
        u = host_array(res.u)
        v = host_array(res.v)
        g = res.gesture
        dt = time.perf_counter() - t0
        detected = bool(g.detected)
        print(
            f"frame {i}: votes={int(g.votes)} detected={detected} "
            f"centroid=({float(g.cx):.1f},{float(g.cy):.1f}) "
            f"host-sync {dt*1e3:.1f} ms"
        )
        if args.out:
            save_png(flow_to_color(u, v), os.path.join(args.out, f"flow_{i:04d}.png"))
            if detected:
                overlay = annotate_gesture_frame(
                    frames[i + 2], g, (args.size, args.size),
                    cfg.gesture.circle_radius,
                )
                save_png(overlay, os.path.join(args.out, f"detect_{i:04d}.png"))
        n += 1
    print(f"processed {n} flow frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
