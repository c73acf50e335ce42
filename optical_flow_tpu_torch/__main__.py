"""Command line of the port (``python -m optical_flow_tpu_torch``).

    python -m optical_flow_tpu_torch track --input VIDEO [--frames 8]
        [--corners 500] [--device cuda]

``track`` is the sparse tracker of the reference's of.cpp, as the JAX
package's ``track`` subcommand runs it: Shi–Tomasi corners on the first
frame (goodFeaturesToTrack(gray, N, 0.01, 10)), then pyramidal sparse LK
from each frame to the next, one line a frame. Each frame's tracking
pyramid is built once (kernel K2 on the card) and serves both its pairs.
``--input`` takes what ``io/video_reader.read_frames`` reads, e.g.
``pipe:WxH:PATH`` for raw BGR frames. The JAX package's other subcommands
(flow, video, slam, serve, bench) are not ported yet.
"""

from __future__ import annotations

import argparse
import sys


def _cmd_track(args) -> None:
    from optical_flow_tpu_torch.io.video_reader import read_frames
    from optical_flow_tpu_torch.pipeline.preprocess import bgr_to_gray
    from optical_flow_tpu_torch.track import good_features_to_track, track_features
    from optical_flow_tpu_torch.track.sparse_lk import build_tracking_pyramid
    from optical_flow_tpu_torch.utils.device import as_tensor, canonical_device

    device = canonical_device(args.device)
    prev = prev_pyr = pts = None
    for i, frame in enumerate(read_frames(args.input, max_frames=args.frames)):
        gray = bgr_to_gray(as_tensor(frame, device))
        pyr = build_tracking_pyramid(gray)
        if prev is None:
            pts, valid = good_features_to_track(gray, args.corners, 0.01, 10)
            print(f"frame {i}: seeded {int(valid.sum())} corners")
        else:
            pts, status, _ = track_features(prev, gray, pts, pyr1=prev_pyr, pyr2=pyr)
            print(f"frame {i}: tracked {int(status.sum())}/{len(status)}")
        prev, prev_pyr = gray, pyr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m optical_flow_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("track", help="sparse feature tracking")
    p.add_argument("--input", required=True)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--corners", type=int, default=500)
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    p.set_defaults(fn=_cmd_track)
    args = ap.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
