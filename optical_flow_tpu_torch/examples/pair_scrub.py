"""Frame-pair scrubbing demo (port of examples/pair_scrub.py), the
reference's legacy sparse-LK file demo (C17, OpticalFlowDemo.cpp:30-276)
rebuilt headless.

The original steps through a .mov pair by pair, seeds corners
(cvGoodFeaturesToTrack, 400 pts), tracks them with the pyramidal sparse LK
(cvCalcOpticalFlowPyrLK, 3x3 window, 5 levels), renders arrows from each
feature to its tracked position (:211-254), and scrubs backward/forward
with the 'b' key / any other key (:265-274). Here:

  - frames decode once into a cache so backward steps are free,
  - each step renders the arrows to <outdir>/pair_NNNN.png,
  - commands come from stdin ('f' forward, 'b' back, 'q' quit — the demo's
    keyboard UX) or from --script for non-interactive runs.

  python -m optical_flow_tpu_torch.examples.pair_scrub --input clip.mp4 \
      --script ffbff --outdir /tmp/scrub [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True, help="video file")
    ap.add_argument("--outdir", default="pair_scrub_out")
    ap.add_argument("--max-frames", type=int, default=64)
    ap.add_argument("--corners", type=int, default=400)  # OpticalFlowDemo.cpp:44
    ap.add_argument("--win", type=int, default=3)  # :205 cvSize(3,3)
    ap.add_argument("--levels", type=int, default=5)  # :205 level 5
    ap.add_argument(
        "--script",
        default=None,
        help="non-interactive command string, e.g. 'ffbf' (f=forward, "
        "b=back, q=quit); omit for interactive stdin stepping",
    )
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from optical_flow_tpu_torch.io.video_reader import read_frames
    from optical_flow_tpu_torch.pipeline.preprocess import bgr_to_gray
    from optical_flow_tpu_torch.track import good_features_to_track, track_features
    from optical_flow_tpu_torch.track.sparse_lk import SparseLKConfig
    from optical_flow_tpu_torch.utils.device import as_tensor, canonical_device, host_array
    from optical_flow_tpu_torch.utils.viz import draw_arrows, save_png

    device = canonical_device(args.device)
    frames = list(read_frames(args.input, max_frames=args.max_frames))
    if len(frames) < 2:
        print("need at least 2 frames", file=sys.stderr)
        return 1
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    lk_cfg = SparseLKConfig(win=args.win, max_level=args.levels - 1)

    def render_pair(i: int) -> Path:
        g1 = bgr_to_gray(as_tensor(frames[i], device))
        g2 = bgr_to_gray(as_tensor(frames[i + 1], device))
        pts, valid = good_features_to_track(g1, args.corners, 0.01, 10)
        new, status, _err = track_features(g1, g2, pts, config=lk_cfg)
        pts_np = host_array(pts)
        flows = host_array(new) - pts_np
        ok = host_array(valid & status)
        rgb = frames[i][..., ::-1]  # decoder yields BGR
        img = draw_arrows(rgb, pts_np, flows, mask=ok, scale=3.0)
        path = outdir / f"pair_{i:04d}.png"
        save_png(img, path)
        print(f"pair {i}->{i + 1}: {int(ok.sum())} tracks, wrote {path}", flush=True)
        return path

    def commands():
        if args.script is not None:
            yield from args.script
            return
        print("commands: f=forward, b=back, q=quit", flush=True)
        for line in sys.stdin:
            for ch in line.strip():
                yield ch

    i = 0
    render_pair(i)
    for cmd in commands():
        if cmd == "q":
            break
        if cmd == "b":  # OpticalFlowDemo.cpp:268: 'b' steps backward
            i = max(i - 1, 0)
        elif cmd == "f":  # any other key steps forward in the original
            i = min(i + 1, len(frames) - 2)
        else:
            continue
        render_pair(i)
    return 0


if __name__ == "__main__":
    sys.exit(main())
