"""Stream a video (file, camera, or pipe source) to a running FlowServer
(port of examples/serve_stream.py).

The serving counterpart of the reference's live loop
(ParallelVideoPyr.cpp:730-905): the server process owns the device and
keeps the built pipeline (and its CUDA graphs) hot; this client just
decodes and ships frames, printing one JSON line per result.

Start a server first:
    python -m optical_flow_tpu_torch serve --port 7070
then:
    python -m optical_flow_tpu_torch.examples.serve_stream --input clip.mp4 \
        --host 127.0.0.1 --port 7070 --frames 32
"""

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True,
                    help="video file, device:N, or pipe:WxH[@FPS]:PATH")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7070)
    ap.add_argument("--unix", default=None)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--size", type=int, default=256,
                    help="server-side processing size")
    ap.add_argument("--preset", default="fast", choices=["fast", "faithful"])
    args = ap.parse_args(argv)

    from optical_flow_tpu_torch.io.video_reader import read_frames
    from optical_flow_tpu_torch.pipeline.serve import FlowClient

    address = args.unix if args.unix else (args.host, args.port)
    client = None
    n = 0
    try:
        for frame in read_frames(args.input, max_frames=args.frames):
            if client is None:
                client = FlowClient(address)
                hello = client.start_stream(
                    frame.shape[0], frame.shape[1],
                    channels=frame.shape[2] if frame.ndim == 3 else 1,
                    preset=args.preset, proc_size=(args.size, args.size),
                )
                print(json.dumps(hello), flush=True)
            print(json.dumps(client.push(frame)), flush=True)
            n += 1
        if client is not None:
            print(json.dumps(client.end_stream()), flush=True)
    finally:
        if client is not None:
            client.close()
    if n == 0:
        sys.exit("no frames decoded")
    return 0


if __name__ == "__main__":
    sys.exit(main())
