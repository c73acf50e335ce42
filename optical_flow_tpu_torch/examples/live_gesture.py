"""Live-camera gesture tracking (port of examples/live_gesture.py), the
reference flagship's exact loop.

The reference captures a webcam and runs preprocess -> pyramidal LK ->
gesture voting per frame (ParallelVideoPyr.cpp:737-905,
cv::VideoCapture(0)). This does the same against any of the framework's
live sources:

  python -m optical_flow_tpu_torch.examples.live_gesture --input device:0   # V4L2 webcam
  python -m optical_flow_tpu_torch.examples.live_gesture --input 0          # same (cv2 form)
  python -m optical_flow_tpu_torch.examples.live_gesture --input pipe:1280x720@30:/tmp/cam.fifo
  python -m optical_flow_tpu_torch.examples.live_gesture --input video.mp4  # a file

Uses the per-frame push path (lowest latency; the chunked path trades
latency for fewer launches — see VideoPipeline.run_chunked).
"""

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default="device:0",
                    help="device:N | N | /dev/videoN | pipe:WxH[@FPS]:PATH | file")
    ap.add_argument("--frames", type=int, default=100, help="stop after N frames")
    ap.add_argument("--size", type=int, default=None,
                    help="square preprocess size (default: the fast preset's)")
    ap.add_argument("--preview", type=int, default=None, metavar="PORT",
                    help="serve a live MJPEG view of the annotated frames "
                    "(the reference's imshow window) at http://host:PORT/")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from optical_flow_tpu_torch.config import VideoConfig
    from optical_flow_tpu_torch.io.video_reader import read_frames
    from optical_flow_tpu_torch.pipeline.video import VideoPipeline

    vc = VideoConfig.fast() if args.size is None else VideoConfig.fast(size=(args.size, args.size))
    pipe = VideoPipeline(vc, device=args.device)
    preview = None
    if args.preview is not None:
        from optical_flow_tpu_torch.io.preview import MjpegPreview

        preview = MjpegPreview(port=args.preview)
        print(f"live preview at {preview.url}", file=sys.stderr)
    try:
        t0 = time.perf_counter()
        n = 0
        pipe.reset()
        for frame in read_frames(args.input, max_frames=args.frames):
            res = pipe.push(frame)
            if res is None:
                continue
            n += 1
            g = res.gesture
            mark = "GESTURE" if bool(g.detected) else "       "
            print(
                f"frame {n:4d} {mark} votes={int(g.votes):5d} "
                f"centroid=({float(g.cx):6.1f},{float(g.cy):6.1f})",
                flush=True,
            )
            if preview is not None:
                from optical_flow_tpu_torch.utils.viz import annotate_gesture_frame

                preview.push(annotate_gesture_frame(frame, g, vc.preprocess.size,
                                                    vc.gesture.circle_radius))
        dt = time.perf_counter() - t0
        if n:
            print(f"{n} frames in {dt:.2f}s ({n / dt:.1f} fps wall incl. capture)")
    finally:
        if preview is not None:
            preview.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
