"""Command line of the port (``python -m optical_flow_tpu_torch``).

    python -m optical_flow_tpu_torch flow IMAGE1 IMAGE2 [--impl auto]
        [--levels N] [--single-level] [--out-prefix P] [--flo OUT.flo]
        [--device cuda]
    python -m optical_flow_tpu_torch video --input VIDEO [--frames 16]
        [--size 256] [--impl auto] [--fast] [--metrics] [--annotate OUT]
        [--fps 30] [--preview PORT] [--gray-decode] [--device cuda]
    python -m optical_flow_tpu_torch track --input VIDEO [--frames 8]
        [--corners 500] [--device cuda]
    python -m optical_flow_tpu_torch slam --input VIDEO [--frames 20]
        [--stride 1] [--focal PX] [--window 8] [--corners 300]
        [--kf-disparity 6] [--stereo-sbs BASELINE] [--out OUT.npz]
        [--out-tum TRAJ.txt] [--eval-tum REF.txt] [--video-fps 30]
        [--imu LOG.npz [--no-accel-bias] [--imu-bias-states]] [--device cuda]
    python -m optical_flow_tpu_torch serve [--host 127.0.0.1] [--port 7070]
        [--unix PATH] [--device cuda]

Every subcommand runs on ``--device``, the card unless another device is
named (``--device cpu`` stands for the JAX CLI's ``--cpu``); without a card
it raises. ``--impl`` takes the port's names (``auto``, ``torch``,
``cuda``) and the JAX package's (``jnp`` = ``torch``, ``pallas`` =
``cuda``).

``flow`` is dense flow between two images (the reference's serialOrig /
SerialPyr mains): ``coarse_to_fine`` with ``FlowConfig(impl, levels)``,
reference mode (on the card K1 at every level, S1 between levels), or one
level of ``lucas_kanade`` with ``--single-level``; ``--out-prefix`` writes
the flow in the reference's saveMat text format (``_u.txt``, ``_v.txt``)
and as a colour image (``_flow.png``), ``--flo`` as Middlebury ``.flo``.

``video`` is the gesture tracker of the reference's ParallelVideoPyr main:
``VideoPipeline`` over the frames (``VideoConfig()`` at ``--size``, or with
``--fast`` exactly ``VideoConfig.fast(size=(s, s))`` with only ``impl``
replaced), one ``frame i:`` line a result, each checked by ``FlowGuard``
(``GUARD TRIPPED`` lines; a stall watchdog of 600 s, which covers the
kernels' build at the first frame); ``--metrics`` writes one JSON line of
counters and timers to stderr, ``--annotate`` the frames with the
detection circle (a video file, or PNGs into a directory), ``--preview`` a
live MJPEG stream of them over HTTP.

``track`` is the sparse tracker of the reference's of.cpp, as the JAX
package's ``track`` subcommand runs it: Shi–Tomasi corners on the first
frame (goodFeaturesToTrack(gray, N, 0.01, 10)), then pyramidal sparse LK
from each frame to the next, one line a frame. Each frame's tracking
pyramid is built once (kernel K2 on the card) and serves both its pairs.
``--input`` takes what ``io/video_reader.read_frames`` reads, e.g.
``pipe:WxH:PATH`` for raw BGR frames.

``slam`` is the JAX package's ``slam`` subcommand: the frames, in gray,
stream into ``slam.incremental_slam`` (tracks, keyframes, windowed BA, loop
closure, Sim(3) pose graph), which prints the keyframes and their camera
centres; ``--stereo-sbs`` splits side-by-side frames into a rectified pair
of that baseline (``slam.split_sbs``); ``--out`` writes poses and map as
``.npz``, ``--out-tum`` the keyframe trajectory in TUM format, and
``--eval-tum`` scores it against a TUM reference (ATE and RPE,
``utils/interop.py``; Sim(3)-aligned for a monocular run, SE(3) for the
metric ones, stereo or ``--imu``). ``--imu`` refines the finished map
against a continuous IMU log (``.npz`` with ``t`` (N,), ``gyro`` (N, 3)
rad/s and ``accel`` (N, 3) m/s^2, body == camera; keyframes timestamped
``frame * stride / video_fps``) with ``slam.refine_slam_with_imu``: bias
estimation, linear alignment, joint VI-BA; the trajectory and map come out
METRIC. ``--no-accel-bias`` skips the accelerometer bias (rotation-poor
logs), ``--imu-bias-states`` carries 15-DOF bias states.

``serve`` is the resident flow/gesture server (``pipeline/serve.py``, wire
protocol version 1): it keeps built pipelines and their CUDA graphs hot and
answers frame streams over TCP or a Unix socket. The JAX CLI's ``bench``
waits for the port's benchmark.
"""

from __future__ import annotations

import argparse
import sys

from optical_flow_tpu_torch.config import IMPL_NAMES


def _cmd_flow(args) -> None:
    import numpy as np

    from optical_flow_tpu_torch.config import FlowConfig, impl_from_name
    from optical_flow_tpu_torch.flow.coarse_to_fine import coarse_to_fine
    from optical_flow_tpu_torch.flow.lk import lucas_kanade
    from optical_flow_tpu_torch.utils.device import as_tensor, canonical_device, host_array
    from optical_flow_tpu_torch.utils.goldens import save_mat
    from optical_flow_tpu_torch.utils.images import imread_gray
    from optical_flow_tpu_torch.utils.viz import flow_to_color, save_png

    device = canonical_device(args.device)
    impl = impl_from_name(args.impl)
    a = as_tensor(imread_gray(args.image1).astype(np.float32) / 255.0, device)
    b = as_tensor(imread_gray(args.image2).astype(np.float32) / 255.0, device)
    if args.single_level:
        u, v = lucas_kanade(a, b, impl=impl)
    else:
        u, v = coarse_to_fine(a, b, config=FlowConfig(impl=impl, levels=args.levels))
    u, v = host_array(u).astype(np.float64), host_array(v).astype(np.float64)
    mag = np.sqrt(u * u + v * v)
    print(f"flow {u.shape[1]}x{u.shape[0]}: mean |flow| {mag.mean():.4f} px, max {mag.max():.4f} px")
    if args.out_prefix:
        save_mat(u, args.out_prefix + "_u.txt")
        save_mat(v, args.out_prefix + "_v.txt")
        save_png(flow_to_color(u, v), args.out_prefix + "_flow.png")
        print(f"wrote {args.out_prefix}_{{u,v}}.txt and _flow.png")
    if args.flo:
        from optical_flow_tpu_torch.utils.interop import save_flo

        save_flo(args.flo, u, v)
        print(f"wrote {args.flo} (Middlebury .flo)")


def _run_video(args) -> None:
    from optical_flow_tpu_torch.io.video_reader import read_frames
    from optical_flow_tpu_torch.config import video_config_for
    from optical_flow_tpu_torch.pipeline.video import VideoPipeline
    from optical_flow_tpu_torch.utils.guard import FlowGuard, NumericalFailure
    from optical_flow_tpu_torch.utils.metrics import Metrics

    if args.gray_decode and args.annotate:
        # validate before any side effect (VideoWriter makes its output directory)
        sys.exit("--gray-decode and --annotate are mutually exclusive "
                 "(the overlay draws on the original BGR frame)")
    # the server's presets (the JAX CLI's --fast rebuilds the flow
    # configuration and so runs pyr_impl='poly'; the port keeps the preset's)
    cfg = video_config_for("fast" if args.fast else "faithful", (args.size, args.size), args.impl)
    pipe = VideoPipeline(cfg, device=args.device)
    # generous: the first frame includes the kernels' nvcc build
    guard = FlowGuard(stall_timeout_s=600.0)
    metrics = Metrics(sink=sys.stderr if args.metrics else None)
    writer = preview = None
    if args.annotate:
        from optical_flow_tpu_torch.io.video_writer import VideoWriter

        writer = VideoWriter(args.annotate, fps=args.fps)
    if args.preview is not None:
        # live view (the reference's imshow surface, headless): a
        # browser-watchable MJPEG stream of the annotated frames
        from optical_flow_tpu_torch.io.preview import MjpegPreview

        preview = MjpegPreview(port=args.preview)
        print(f"live preview at {preview.url}", file=sys.stderr)
    # push() frame by frame so that each result is drawn onto its own
    # frame, the reference's live overlay (ParallelVideoPyr.cpp:884-891)
    i = -1
    stop_watchdog = guard.start_watchdog()
    try:
        for frame in read_frames(args.input, max_frames=args.frames, gray=args.gray_decode):
            res = pipe.push(frame)
            if res is None:
                continue
            i += 1
            with metrics.timer("frame"):
                g = res.gesture
                try:
                    guard.check(res.u, res.v, context=f"frame {i}")
                except NumericalFailure as e:
                    print(f"frame {i}: GUARD TRIPPED: {e}")
                    metrics.count("guard_trips")
                    continue
                metrics.count("frames")
                if bool(g.detected):
                    metrics.count("detections")
                print(f"frame {i}: votes={int(g.votes)} detected={bool(g.detected)} "
                      f"centroid=({float(g.cx):.1f},{float(g.cy):.1f})")
                if writer is not None or preview is not None:
                    from optical_flow_tpu_torch.utils.viz import annotate_gesture_frame

                    rgb = annotate_gesture_frame(frame, g, cfg.preprocess.size,
                                                 cfg.gesture.circle_radius)
                    if writer is not None:
                        writer.write(rgb)
                    if preview is not None:
                        preview.push(rgb)
    finally:
        stop_watchdog()
        if preview is not None:
            preview.close()
    if writer is not None:
        writer.close()
        print(f"wrote {writer.frames_written} annotated frames to {args.annotate}")
    metrics.emit()


def _cmd_serve(args) -> None:
    from optical_flow_tpu_torch.pipeline.serve import FlowServer

    srv = FlowServer(host=args.host, port=args.port, unix_path=args.unix, device=args.device)
    print(f"serving flow/gesture streams on {srv.address}", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()


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


def _cmd_slam(args) -> None:
    import itertools

    import numpy as np

    from optical_flow_tpu_torch.io.video_reader import read_frames
    from optical_flow_tpu_torch.pipeline.preprocess import bgr_to_gray
    from optical_flow_tpu_torch.slam import incremental_slam, split_sbs
    from optical_flow_tpu_torch.utils.device import as_tensor, canonical_device

    device = canonical_device(args.device)
    imu_log = _read_imu_log(args.imu) if args.imu else None
    sbs_baseline = args.stereo_sbs

    def gray(frame):
        g = bgr_to_gray(as_tensor(frame, device))
        return split_sbs(g) if sbs_baseline is not None else g

    gray_iter = (gray(f) for f in read_frames(args.input, max_frames=args.frames,
                                              stride=args.stride))
    # peek one frame for the focal default, then stream the rest:
    # incremental_slam keeps only keyframe frames
    try:
        first = next(gray_iter)
    except StopIteration:
        sys.exit("need at least 2 decodable frames")
    h, w = (first[0] if sbs_baseline is not None else first).shape
    focal = args.focal if args.focal else 0.8 * w  # a plausible default field of view
    try:
        res = incremental_slam(
            itertools.chain([first], gray_iter), focal, window=args.window,
            max_corners=args.corners, kf_min_disparity=args.kf_disparity,
            stereo_baseline=sbs_baseline, device=device,
        )
    except ValueError as e:
        sys.exit(str(e))
    if res is None:
        sys.exit("bootstrap failed (not enough parallax or tracks)")
    centers = res.centers()
    rmse = float("nan") if res.rmse is None else res.rmse
    print(f"keyframes {len(res.keyframes)} (last frame {res.keyframes[-1]}) map points "
          f"{res.points.shape[0]} BA rmse {rmse:.2f}px loop edges {len(res.loop_edges)}")
    for i, (kf, c) in enumerate(zip(res.keyframes, centers)):
        print(f"  kf {i} (frame {kf}): center {np.round(c, 4)}")
    kf_ts = np.asarray(res.keyframes, np.float64) * args.stride / args.video_fps
    if imu_log is not None:
        centers = _refine_with_imu(args, imu_log, res, focal, kf_ts, device)
    if args.out:
        np.savez(args.out, poses=res.poses, trans=res.trans, points=res.points,
                 keyframes=np.asarray(res.keyframes))
        print(f"wrote trajectory + map to {args.out}")
    if args.out_tum:
        from optical_flow_tpu_torch.utils.interop import save_tum_trajectory

        save_tum_trajectory(args.out_tum, kf_ts, res.poses, res.trans)
        print(f"wrote TUM trajectory to {args.out_tum} "
              f"(evaluate with e.g. `evo_traj tum {args.out_tum}`)")
    if args.eval_tum:
        from optical_flow_tpu_torch.utils.interop import (
            associate_by_timestamp,
            ate_rmse,
            load_tum_trajectory,
            rpe_stats,
        )

        rts, rposes, rtrans = load_tum_trajectory(args.eval_tum)
        ia, ib = associate_by_timestamp(kf_ts, rts, max_diff=0.5 / args.video_fps)
        if len(ia) < 3:
            sys.exit(f"--eval-tum: only {len(ia)} timestamp matches "
                     "(check --video-fps/--stride against the reference)")
        ref_c = np.stack([-R.T @ t for R, t in zip(rposes[ib], rtrans[ib])])
        align = "se3" if (sbs_baseline is not None or args.imu) else "sim3"
        ate, err, _ = ate_rmse(centers[ia], ref_c, align=align)
        rpe = rpe_stats(res.poses[ia], res.trans[ia], rposes[ib], rtrans[ib])
        print(f"eval vs {args.eval_tum}: {len(ia)} poses matched | "
              f"ATE({align}) rmse {ate:.4f} (max {err.max():.4f}) | "
              f"RPE trans {rpe['trans_rmse']:.4f} "
              f"rot {np.degrees(rpe['rot_rmse_rad']):.3f} deg/step")


def _read_imu_log(path) -> dict:
    """The arrays t, gyro and accel of the ``--imu`` log, read before any
    frame so that a bad log fails at once."""
    import numpy as np

    log = np.load(path)
    try:
        return {k: log[k] for k in ("t", "gyro", "accel")}
    except KeyError as e:
        sys.exit(f"--imu log missing array {e} (need t, gyro, accel)")


def _refine_with_imu(args, log, res, focal, kf_ts, device):
    """Tightly-coupled VI refinement of ``res`` in place from the IMU log;
    prints the refinement's lines and returns the metric camera centres."""
    import numpy as np

    from optical_flow_tpu_torch.slam import refine_slam_with_imu
    from optical_flow_tpu_torch.slam.vi_ba import states_to_poses
    from optical_flow_tpu_torch.utils.device import host_array

    try:
        out, info = refine_slam_with_imu(
            res, focal, log["t"], log["gyro"], log["accel"], kf_ts,
            estimate_accel_bias=not args.no_accel_bias, bias_states=args.imu_bias_states,
            device=device,
        )
    except ValueError as e:
        sys.exit(f"--imu refinement failed: {e} (check --video-fps covers the log's time span)")
    poses, trans = states_to_poses(out.states)
    res.poses = poses.astype(np.float32)
    res.trans = trans.astype(np.float32)
    res.points = host_array(out.points)
    print(f"VI refinement: scale {info['scale']:.4f} gyro bias {np.round(info['gyro_bias'], 4)} "
          f"accel bias {np.round(info['accel_bias'], 3)} gravity {np.round(info['gravity'], 3)}")
    if "gyro_bias_per_kf" in info:
        drift = info["gyro_bias_per_kf"][-1] - info["gyro_bias_per_kf"][0]
        print(f"  bias states: gyro walked {np.round(drift, 4)} rad/s "
              f"over {len(info['gyro_bias_per_kf'])} keyframes")
    centers = res.centers()
    for i, (kf, c) in enumerate(zip(res.keyframes, centers)):
        print(f"  kf {i} (frame {kf}): METRIC center {np.round(c, 4)}")
    return centers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m optical_flow_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("flow", help="dense optical flow between two images")
    p.add_argument("image1")
    p.add_argument("image2")
    p.add_argument("--impl", default="auto", choices=list(IMPL_NAMES))
    p.add_argument("--levels", type=int, default=None)
    p.add_argument("--single-level", action="store_true")
    p.add_argument("--out-prefix", default=None)
    p.add_argument("--flo", default=None, metavar="OUT.flo",
                   help="also write the flow as Middlebury .flo (utils/interop.py)")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    p.set_defaults(fn=_cmd_flow)

    p = sub.add_parser("video", help="video gesture tracking")
    p.add_argument("--input", required=True,
                   help="video file, camera (0 / device:0 / /dev/video0) or pipe:WxH[@FPS]:PATH")
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--impl", default="auto", choices=list(IMPL_NAMES))
    p.add_argument("--metrics", action="store_true", help="emit JSONL metrics to stderr")
    p.add_argument("--fast", action="store_true",
                   help="production preset: VideoConfig.fast (displacement-true flow, "
                   "clamped separable warp, pyramid reuse; parity quirks off)")
    p.add_argument("--annotate", default=None, metavar="OUT",
                   help="write an annotated output video (detection circle drawn on each "
                   "frame, the reference's imshow overlay) to OUT.mp4, or to a PNG "
                   "directory if OUT has no extension")
    p.add_argument("--fps", type=float, default=30.0, help="annotated output fps")
    p.add_argument("--preview", type=int, default=None, metavar="PORT",
                   help="serve a live MJPEG preview of the annotated frames at "
                   "http://host:PORT/ (0 = ephemeral port); never stalls the pipeline "
                   "(io/preview.py)")
    p.add_argument("--gray-decode", action="store_true",
                   help="decode to GRAY8 instead of BGR (a third of the bytes to the "
                   "device); incompatible with --annotate")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    p.set_defaults(fn=_run_video)

    p = sub.add_parser("track", help="sparse feature tracking")
    p.add_argument("--input", required=True)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--corners", type=int, default=500)
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    p.set_defaults(fn=_cmd_track)

    p = sub.add_parser("slam", help="incremental SLAM over a video (tracks -> keyframes -> "
                       "windowed BA -> loop closure -> pose graph)")
    p.add_argument("--input", required=True)
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--focal", type=float, default=None,
                   help="focal length in px (default: 0.8 * width)")
    p.add_argument("--window", type=int, default=8)
    p.add_argument("--corners", type=int, default=300)
    p.add_argument("--kf-disparity", type=float, default=6.0,
                   help="adaptive keyframes: median track disparity (px) a frame must add "
                   "since the last keyframe (0 = keyframe every frame)")
    p.add_argument("--out", default=None, help="write poses+map to OUT.npz")
    p.add_argument("--out-tum", default=None, metavar="TRAJ.txt",
                   help="write the keyframe trajectory in TUM format (keyframes timestamped "
                   "from --video-fps/--stride)")
    p.add_argument("--eval-tum", default=None, metavar="REF.txt",
                   help="evaluate against a TUM reference trajectory: nearest-timestamp "
                   "association, ATE (Sim3-aligned monocular, SE3 for the metric stereo and "
                   "--imu runs) and RPE")
    p.add_argument("--stereo-sbs", type=float, default=None, metavar="BASELINE",
                   help="side-by-side rectified stereo (left|right) with this baseline; "
                   "trajectory and map come out metric in its units")
    p.add_argument("--imu", default=None, metavar="LOG.npz",
                   help="tightly-coupled VI refinement from a continuous IMU log (.npz with t "
                   "(N,), gyro (N,3) rad/s, accel (N,3) m/s^2, body==camera frame): bias "
                   "estimation -> linear alignment -> joint VI-BA; trajectory and map come out "
                   "METRIC")
    p.add_argument("--video-fps", type=float, default=30.0,
                   help="capture frame rate, to timestamp keyframes (against the IMU log's t "
                   "axis with --imu)")
    p.add_argument("--no-accel-bias", action="store_true",
                   help="skip accel-bias estimation (rotation-poor logs: accel bias separates "
                   "from gravity only under rotation-axis variety)")
    p.add_argument("--imu-bias-states", action="store_true",
                   help="carry per-keyframe bias states (15-DOF) through the joint VI-BA with "
                   "random-walk coupling, for logs long enough that the biases drift")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    p.set_defaults(fn=_cmd_slam)

    p = sub.add_parser("serve", help="long-running flow/gesture server: keeps built "
                       "pipelines hot and answers frame streams over TCP or a Unix socket "
                       "(pipeline/serve.py wire protocol)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7070)
    p.add_argument("--unix", default=None, metavar="PATH",
                   help="serve on a Unix-domain socket instead of TCP")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    p.set_defaults(fn=_cmd_serve)
    args = ap.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
