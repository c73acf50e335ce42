#!/usr/bin/env python3
"""Drive the PyTorch port's streaming 1080^2 flow paths (the fast preset,
unsharded and on a 2x2 tile mesh, and the reference-parity default
configuration), the sparse tracker, Horn-Schunck, the exact 'shift' warp,
structure from motion, the mapper (incremental SLAM, stereo, the slam CLI),
the visual-inertial back end (IMU preintegration, VI-BA, slam --imu), the
serving path (FlowServer answering socket streams, the CLI's video and
flow) and the mesh across processes (the sharded bundle adjustments, two
ranks joined by torch.distributed, dryrun_multichip) once on an NVIDIA
GPU, and run the probes S2-S4.

    python3 chip_smoke.py

(``python3 chip_smoke.py --rank PORT RANK`` and ``--gloo-send PORT RANK``
are ranks of phase 17 (c), started by the script itself;
``python3 chip_smoke.py --phase18`` runs the build, phase 17 (c)'s ranks
and phase 18 alone.)

Phases, each printing one line (any failure raises and exits non-zero):
  1. device: the card's name and its nvidia-smi name/power-limit line;
  2. build: compile the CUDA kernels from optical_flow_tpu_torch/kernels/csrc,
     and print what the compiler allotted K1-K5, S1, W1, F1, P1 and S2-S4
     (registers, spills); compile csrc/probes.cu to PTX and fail unless
     S4's kernels multiply and add with mul.rn and add.rn (packed bf16x2
     in the bfloat16 ones), with no fma and, in bfloat16, no conversion,
     and S3's with mul.rn.f32 and add.rn.f32, no fma and no conversion;
     print the FFMA, HFMA2 and other arithmetic of S4's kernels in the
     built SASS (cuobjdump -sass);
  3. each kernel against its plain PyTorch version at the shapes of the main
     path, float32, with its tolerance, timed with CUDA events in turns
     (plain, kernel, kernel, plain) after warm-up, and by its device time
     on use-once inputs; K5 (the tile mode of K3 and K4) on the 2x2 tile
     grid of the mesh path, also against the full-frame kernel's region
     (max |err| must be 0), timed as one frame's four tiles; K1 and K3-K5
     held to max |err| 0 (the unmasked max |err| printed beside it), K3-K5
     also over a ragged and C sweep (shapes that leave partial blocks, C =
     1, 4, 8), K1 over a ragged sweep on both sides of its launcher's
     strip rule; F1 (the feature map) at 1080^2 in float32 and uint8, one
     frame and a chunk of 16, bit for bit, also over odd planes and every
     radius;
     K2 per level and as the one-call pyramid of a 1080^2 frame (4
     levels) and of a 720x1280 tracking frame (3 levels), bit for bit, also over ragged and tiny planes and a pyramid to
     1x1; and P1 (the mesh probe's copy kernel) on the probe's tiles, in
     turns with ``clone`` over several rounds, and bit for bit at ragged
     lengths and an unaligned start;
  4. the slice: VideoPipeline(VideoConfig.fast()) on 12 synthetic 720x1280
     BGR frames, once through the kernels (the steady push replayed as a
     CUDA graph, the default) and once on the plain path, flows compared by
     quantiles and gesture votes within 1%, exact launch counts;
  5. K4 through the controller: corrected coarse_to_fine with level_iters=2
     on a 1080^2 textured pair with a known sub-pixel shift;
  6. where the time goes: the kernel path's device busy time, idle share
     and device time by kernel from one torch.profiler trace, its steady
     push eager and then replayed as a CUDA graph, written in full to
     chiprun_out/profile_slice_{eager,graph}.json;
  7. the mesh slice: VideoPipeline(VideoConfig.fast(), mesh=2x2 tile grid on
     the one card) on phase 4's frames, flows and votes equal to phase 4's
     kernel path bit for bit, exact launch counts;
  8. the mesh controller: sharded_coarse_to_fine with level_iters=2 on phase
     5's pair, 3 levels, bit-identical to the unsharded controller, exact
     launch counts;
  9. the reference-parity slice: VideoPipeline(VideoConfig()) (faithful
     uint8 preprocess, reference mode, gather warp, warped diff fed back) on
     phase 4's frames, once through the kernels (K1 at all four levels, S1
     between them, W1 the warp of the three finer levels) and once with
     FlowConfig(impl='torch'), flows and votes
     compared, exact launch counts; the card's uint8 gray against the CPU's;
     then phase 6's profiles of the kernel path in this configuration
     (chiprun_out/profile_reference_{eager,graph}.json);
 10. the probes S2-S4 on use-once inputs, device time of back-to-back
     launches (utils/profiling.time_use_once), each against its plain
     version bit for bit, with the copy and elementwise rates they measure
     at their own shapes, and the plain version and library call of each
     variant where they differ (S2's rows, S4 in bfloat16);
     S2 and S4 bit for bit over ragged, tiny and unaligned planes, odd
     lengths, 0-64 steps and bfloat16 subnormals, ties, signed zeros and
     exponent gaps; S3 bit for bit, both forms, over ragged widths, windows
     at 0, 1 and their edges, 1-1,320 rows, unaligned views and special
     values (signed zeros, subnormals, overflowing sums, +-inf); the launch
     floor (P1 and clone, phase 3) printed beside S2-S4; then the copy rate
     (S2) and the float32 and bfloat16 elementwise rates (S4) that the card
     sustains at sizes that fill it many times over;
 11. the host path on phase 4's frames, for both configurations: push with
     graph=False equal to phases 4 and 9 (graphs on) bit for bit with the
     same launch counts, run(prefetch=2) equal to run(prefetch=0) bit for
     bit, run_chunked (fast preset; two chunks of 5 and a 2-frame tail)
     against phase 4 at the slice bar and its replayed chunk step equal to
     the eager one, replay_video of the frames written raw equal to run,
     then host ms per frame of eager push, graph push, run(prefetch=2) and
     run_chunked(16);
 12. the sparse-tracking path, Horn-Schunck and the 'shift' warp: (a) phase
     4's frames in gray through examples/trajectory.py's chain with of.cpp's
     arguments (corners, default SparseLKConfig with each frame's tracking
     pyramid built once by K2, RansacConfig()), on the card and on the CPU,
     corner sets, tracks, status and inlier counts compared, the moving
     patch's (+3, +2) px recovered; (b) phase 5's pair: the known shift from
     the tracks and the homography, sparse 'shift' against 'gather'; (c)
     horn_schunck (4 levels, shift_sep warps) within 0.2 px of the shift, its
     K2 pyramids equal to 'poly'; (d) the 'shift' warp against 'gather' at
     1080^2, through the controller (K1 at every solve, no K3/K4) and on the
     2x2 mesh bit for bit; (e) ms per call and device events per call of
     each entry point, CUDA events after warm-up, one call traced;
 13. structure from motion (slam/): (a) multi_view_reconstruct on 8 gray
     720x1280 frames of a camera sliding along +x over a random depth field
     (rendered with scipy), on the card and on the CPU: rmse falls and
     stays under 3 px, the x translations grow with max/min step < 1.8,
     kept track sets >= 99% shared, camera centres within 1e-3 of the
     baseline, K2 exactly 2 x 7 launches (both tracking pyramids of every
     link) and no other kernel; (b) two_view_reconstruct on frames 0 and 3:
     |t_x| > 0.9, >= 90% of points in front, depth correlation > 0.7,
     card against CPU as in (a); (c) bundle_adjust in float64 at 50
     cameras, 10,000 points, 60,000 observations: rmse falls 10x, card
     within 1e-8 of the CPU, whether two card runs are bit-equal (reported),
     and the Huber solve with 5% gross outliers; (d) WindowedBA over a
     14-keyframe trajectory with one eye and with a right eye, the poses
     within tests/test_slam.py's bars; (e) ms per call, device events,
     busy ms and idle share of each entry point, and of the 8-point null
     vector's two forms (a batched SVD of the tall float32 design matrices,
     eigh of the float64 normal matrices);
 14. the mapper (slam/): (a) incremental_slam on tests/test_incremental_slam.py's
     loop at 720x1280 (10 frames, the focal scaled by 1280/416 and the loop
     by 416/1280; rendered with scipy), on the card and on the CPU: the same
     keyframes and loop edges, camera centres within 1e-3 of the loop
     radius; against the truth after one global scale, the test's bars in
     loop radii (mean < 0.05/0.12, max < 0.10/0.12) and a loop edge >= 6
     keyframes long; K2 exactly once a frame plus twice a verified loop
     candidate and twice an accepted loop; (b) the stereo rig of
     tests/test_stereo_slam.py on that loop (baseline 0.3 x 416/1280): a
     metric trajectory within the test's bars, card against CPU as in (a);
     (c) dense_disparity on one textured 720x1280 rig pair (disparities
     12-40 px): K1 and K3 (C = 12) within median 1e-3 px and q99 0.02 px of
     the plain path, > 85% valid at < 1.5 px median error, exact launch
     counts (its default pyr_impl 'poly' builds the pyramids plain); K3 at
     C = 12 at each of its shapes bit for bit with its plain version, timed
     on use-once inputs and in turns with it; (d) `python -m
     optical_flow_tpu_torch slam` on (a)'s frames as raw BGR (pipe:): exit
     0, the keyframe lines, a TUM file that reads back; (e) ms per call and
     per keyframe of each run, device events, busy ms and idle share;
 15. the visual-inertial back end (slam/imu.py, slam/vi_ba.py): (a)
     vi_bundle_adjust in float32 on tests/test_vi_ba.py's trajectory at the
     size of 13 (c) (50 keyframes 0.5 s apart, an exact 200 Hz IMU log,
     10,000 points each seen by 6 consecutive keyframes: 60,000
     observations), from test_vi_ba_converges_from_perturbed_init's start,
     12 iterations, 9-DOF and 15-DOF (bias states on the clean log), on the
     card and on the CPU: the test's bars (mean centre error < 5e-3 m,
     |scale - 1| < 0.01, velocity error < 0.03, the history falls; bias
     deltas < 5e-3), card within 1e-3 m of the CPU and 1e-4 of scale; TF32
     must be off inside the solve with the global setting at TF32, and the
     scale reached with TF32 on inside it is reported; (b)
     refine_slam_with_imu on 14 (a)'s monocular map and 14 (b)'s stereo map
     with an IMU log of the loop (200 Hz, zero gyro, accel a - g), card and
     CPU: metric centres with no scale fit within tests/test_vi_ba.py's bars
     in loop radii (mean < 0.05/0.12, span ratio within 0.15 of 1), card
     within 1e-3 radii of the CPU, the stereo map not rescaled; (c) `slam
     --imu` on 14 (a)'s frames with --no-accel-bias and --out, in process:
     the VI and METRIC lines, the saved trajectory within (b)'s bars, K2
     exactly as 14 (a) counts it; then as a command with --imu-bias-states:
     exit 0 and its bias-states line; (d) the IMU functions and VI-BA launch
     no kernel; (e) ms per call, device events, busy ms and idle share of
     preintegrate, its bias Jacobians, estimate_gyro_bias,
     visual_inertial_alignment_with_bias, vi_bundle_adjust at 9 and 15 DOF
     and refine_slam_with_imu;
 16. the serving path (pipeline/serve.py) on phase 4's frames: (a) a
     FlowServer on the card answering a fast stream at full width over TCP
     (720x1280 frames, 1080^2 processing, the flow returned): two warm-up
     replies, then each result equal to VideoPipeline(VideoConfig.fast())
     pushed directly bit for bit (u, v as float32 bits, votes, detected,
     cx, cy), the served steady frames launching exactly phase 4's K2 1,
     K1 1, K3 3 a frame; a second stream on the connection pooled, equal,
     with no new capture and phase 4's counts; the same stream through a
     FlowServer(mesh=2x2 tile grid on the card) equal too, with phase 7's
     counts (K5 per tile, P1 once per tile); (b) two clients on two
     threads (frames of seeds 0 and 1) at once, each equal to its direct
     run; a faithful stream at 256^2 (K1, S1 and W1) equal to its direct run
     with the same counts; one stream over a Unix socket; the JAX package's
     impl="pallas" building the impl="cuda" pipeline; (c) `python -m
     optical_flow_tpu_torch video --fast --size 1080 --metrics` on the
     frames written raw: exit 0, its frame lines those of (a)'s direct run,
     10 frames and no guard trip in its metrics; (d) `flow` on phase 5's
     pair written as PNGs: its saveMat text and .flo equal coarse_to_fine
     called directly on the card (reference mode, the CLI's default, whose
     flow is not the pair's displacement: its median EPE to the shift is
     printed, not held); (e) ms a served frame from send to reply with and
     without the flow beside the direct push, over a pooled window of 300
     frames split into the client's send, the server's push and D2H, the
     rest of the wait and the flow's receipt; the time to a first result
     of a new and a pooled pipeline, device events, busy ms and idle share
     of traced served frames, and the memory a pooled pipeline holds;
 17. the mesh across processes: (a) sharded_bundle_adjust on 13 (c)'s
     problem (float64, 60,000 observations) over 8 shards of a (2, 2, 2)
     mesh that repeats the card, and its Huber solve on the 5% outliers,
     each within 1e-8 (relative) of bundle_adjust on the card, the rmse
     falling 10x, no kernel launched; (b) sharded_vi_bundle_adjust on 15
     (a)'s problem (float32), 9 and 15 DOF, over the same mesh, at 15 (a)'s
     bars and within its card-vs-CPU bars (1e-3 m, 1e-4 of scale) of
     vi_bundle_adjust on the card, max |d| printed; (c) two ranks of this
     script started together, joined by initialize_distributed over gloo
     on loopback (NCCL refuses two ranks on one card; CUDA tensors cross
     through pinned host memory): host_local_frames and make_global_batch
     of phase 4's frames as 1080^2 grays, sharded_lucas_kanade on a (4, 2,
     1) mesh bit for bit with the unsharded LK, a global mean across the
     ranks within 1e-9, sharded_coarse_to_fine of the fast configuration
     on phase 5's pair on a (1, 2, 2) mesh whose rows lie on the two ranks
     bit for bit with the unsharded controller, with each rank's exact
     launch counts (K2 2, K1 1 and K3 1 whole at 135^2 and 270^2, K5 4, P1
     2), and 13 (c)'s BA with its 8 shards over both ranks within (a)'s
     bar; each rank prints its backend, its rank, its checks, its ms per
     call beside the unsharded call's, and the bytes it hands to the group
     (per GN iteration: a 6- less a 5-iteration solve); then, reported,
     what gloo does with a CUDA tensor sent point to point; (d)
     dryrun_multichip(4) on the card; (e) ms per call, device busy and
     idle share of one traced call of (a) and of its unsharded
     counterpart, and (b)'s times;
 18. the native host runtime and the examples: (a) what pkg-config finds
     of libavformat, libavcodec, libavutil and libswscale; where it finds
     them all, the native library built into build/native/, phase 4's
     frames written to an .mp4 with cv2's VideoWriter (MPEG-4 part 2) and
     decoded by backend='native' ('auto' must choose it): BGR equal to
     cv2's decode bit for bit, gray (one-hop luma) within
     tests/test_native.py's bar of cv2's gray, read_frames(start=5) equal
     to decode-and-skip (BGR and gray), VideoPipeline(VideoConfig.fast())
     .run(prefetch=2) from the native reader equal bit for bit to the run
     on cv2's frames with exact counts (K2 11, K1 10, K3 30), the gray
     decode through the fast head equal to its frames pushed, then
     the prefetch worker's decode, put and HtoD ms a frame (its spans in a
     profiling.trace()) and the decode ms a frame of native and cv2, BGR
     and gray; where pkg-config misses any, one line names them and (a)
     after cv2's staging ms is skipped; (b) the 14 examples in
     process through main(argv) (still_regression only with a reference
     checkout): video_gesture --fast at 1080^2 and live_gesture on 8
     frames of the clip with phase 4's counts (K2 7, K1 6, K3 18),
     live_gesture's lines those of the direct push; trajectory,
     stabilize, sparse_track and pair_scrub launching K2; serve_stream
     against a FlowServer on the card over loopback, its replies the
     direct push's; scaling_report at 540^2 launching K5 and P1 on 4
     slots; scale_drift printing the JAX script's lines; sfm_demo,
     loop_closure, stereo_slam and vi_odometry within their JAX tests'
     bars; each one's seconds (its lines in
     chiprun_out/phase18_examples.log); (c) the backend phase 17 (c)'s
     two ranks on the one card chose: gloo.
Phase 3 also holds S1 at the three upsamples of a 1080^2 frame, and over
a ragged sweep at odd and even coarse widths on both sides of its
launcher's strip rule, bit for bit, W1 (the 'gather' warp of both frames)
at the three warped levels of a 1080^2 frame with flows of up to 40 px and
over a sweep of its vector widths and uint8 frames, bit for bit, and K1 at
every level of the reference path, and times the one
PyTorch call that computes K2's and S1's function (cuDNN convolutions,
TF32 off; the pyramid's: one a level). At the end, whether the pyramid's
grids (one a level, programmatic dependent launch) can be captured into a
CUDA graph (reported, not required). Launch counters are reset just before
the runs of phases 4, 5, 7, 8, 9, 10, 11 (c), 12 (a), 12 (d), 13 (a), 14 (a),
14 (c), 15 (a) and (b) together, 15 (c), 16 (a) (the served steady frames,
and the pooled stream), 16 (b) (the faithful stream), 17 (a) and 17 (d),
and in each rank of 17 (c) before its LK and its controller run, and read
just after each. Then one
JSON line with the kernels (each with its least time on the card, from
utils/profiling's byte and operation model against the published H100
peaks, its time at the rates phase 10 sustained, its device time on
use-once inputs where measured, and, where one PyTorch call computes the
same function, that call's time; K2 in one row, its pyramid call, with the
single levels in its by_shape), and as the last line {"ok": true,
"device": {...}}. It needs one CUDA device and no network.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np

SEED = 0
FRAMES = 12
FRAME_HW = (720, 1280)
SIZE = 1080
# main-path shapes per 1080^2 frame (4 levels: 1080, 540, 270, 135)
K1_SHAPES = [(135, 135), (270, 270), (540, 540), (1080, 1080)]  # 135^2 fast, all: reference
K2_SHAPES = [(1080, 1080), (540, 540), (270, 270)]
PYRAMID = ((SIZE, SIZE), 4)  # the main path's pyramid: one oft_pyramid call a frame
TRACK_PYRAMID = ((720, 1280), 3)  # the tracking pyramid of a 720p gray frame (phase 12)
# K2's ragged and tiny cases (not timed): (shape, levels) pyramids, one of
# them to 1x1, and single levels
K2_SWEEP_PYRAMIDS = [((1024, 1024), 11), ((2, 135, 271), 10), ((3, 7), 3), ((1, 1), 3)]
K2_SWEEP_LEVELS = [(135, 271), (2, 61, 37), (3, 7), (1, 1)]
K3_SHAPES = [(270, 270), (540, 540), (1080, 1080)]
K4_SHAPES = [(1080, 1080)]
S1_SHAPES = [(135, 135), (270, 270), (540, 540)]  # reference mode's coarse flows, upsampled x2
# the mesh path: a 2x2 tile grid; K5 runs K4 per tile at 1080^2 (level_iters=2)
# and K3 per tile at 1080^2 and 540^2 (270^2 has odd 135^2 tiles: full frame)
GRID = (2, 2)
K5_WARP_SHAPES = [(1080, 1080)]
K5_PYRUP_SHAPES = [(540, 540), (1080, 1080)]
P1_TILE = (8, 128)  # the mesh probe's tile (parallel/vma_compat.py)
CLAMP, C = 8.0, 4  # VideoConfig.fast(): warp_clamp=8 -> shift_sep max_disp 4
# K1 follows its plain version operation for operation: held to 0 on the
# well-conditioned pixels (tests/test_warp_lk_kernel.py:61-81), the unmasked
# max |err| printed beside it
ATOL_LK = 0.0
# K1's ragged sweep: shapes that leave partial warps and strips on both sides
# of the launcher's rule: 2-row strips of 29 columns a warp for small grids,
# 4-row strips of 60 columns (8-byte accesses at even widths) from a grid of
# 1080^2 or a batch that large (the last six); 4 strips a block
K1_SWEEP = [(2, 135, 271), (3, 3), (3, 7), (2, 7, 57), (9, 60), (15, 31), (17, 87), (28, 29),
            (31, 59), (33, 30), (63, 88), (65, 86), (127, 30), (129, 28),
            (1, 1080, 1000), (1, 1081, 1001), (1, 1089, 1021), (1, 1087, 1022), (32, 127, 119),
            (32, 129, 120)]
# S1's ragged sweep at odd and even coarse widths (8-byte and 16-byte stores),
# on both sides of the launcher's rule: 1 coarse row a thread, and 2 from the
# grid of a 540^2 coarse flow or a batch that large (the last four)
# W1: reference mode's warped levels of a 1080^2 frame; its sweep, each shape
# at both forms (quantized, floor): widths by 4, by 2 and odd (4, 2 and 1
# outputs a thread), a batch, tiny planes
W1_SHAPES = [(270, 270), (540, 540), (1080, 1080)]
W1_SWEEP = [(4, 1080, 1080), (2, 61, 37), (37, 59), (135, 270), (3, 7, 6), (1, 1), (1, 9),
            (9, 1)]
# F1: the feature map of a 1080^2 frame and of a chunk of 16 (device time
# on F1_BATCH_SETS use-once chunks); its sweep: odd planes down to 2x2 and a
# batch, every radius
F1_SHAPES = [(1080, 1080), (16, 1080, 1080)]
F1_BATCH_SETS = 10
F1_SWEEP = [(540, 960), (17, 33), (3, 7), (2, 2), (1, 5), (3, 67, 129)]
S1_SWEEP = [(2, 135, 135), (270, 271), (1, 1), (1, 9), (9, 1), (2, 7, 5), (33, 64), (31, 130),
            (2, 17, 66), (540, 541), (537, 530), (543, 511), (8, 135, 136)]
# K3-K5 follow their plain versions operation for operation: held to 0 on the
# well-conditioned pixels (the unmasked max |err| is printed beside it)
ATOL_WARP_LK = 0.0
# the ragged and C sweep of K3-K5: shapes that leave partial blocks of the
# kernel's tiles (29 columns, 32 or 64 rows), at several tap reaches C (clamp
# 2C, flows scaled so that the quantized half-flow reaches +-C)
SWEEP_C = (1, 4, 8, 12)  # 12: dense_disparity's reach (warp_clamp 24, phase 14)
K3_SWEEP = [(2, 270, 270), (2, 134, 198), (52, 38)]
K4_SWEEP = [(2, 61, 37), (1080, 1000)]
K5_SWEEP = {"warp_lk_tile": (270, 270), "pyrup_warp_lk_tile": (268, 268)}  # odd / even tiles
P1_ROUNDS = 5  # P1 and clone timed in turns, each round on use-once inputs
P1_SWEEP = (1, 3, 1024, 1027)  # lengths: float4 body, scalar tail (and offset 1)
ATOL_PYRDOWN = 0.0  # K2 follows ops/pyramid.pyr_down_poly operation for operation
SHIFT = (2.5, -1.5)  # (dx, dy) of the phase-5 pair, px
RUNS = {"stream": "VideoPipeline.push (phase 4)",
        "controller": "coarse_to_fine level_iters=2 (phase 5)",
        "mesh_stream": "VideoPipeline.push, 2x2 tile mesh (phase 7)",
        "mesh_controller": "sharded_coarse_to_fine level_iters=2, 2x2 tile mesh (phase 8)",
        "reference": "reference stream (phase 9)", "probes": "probes (phase 10)",
        "track": "sparse tracking, corners -> sparse LK -> RANSAC (phase 12 a)",
        "shift_controller": "coarse_to_fine warp_impl='shift' level_iters=2 (phase 12 d)",
        "sfm": "multi_view_reconstruct, 8 frames of 720x1280 (phase 13 a)",
        "slam": "incremental_slam, 10 frames of 720x1280 (phase 14 a)",
        "stereo": "dense_disparity, one 720x1280 rig pair, C = 12 (phase 14 c)",
        "vi": "the IMU functions and vi_bundle_adjust, 9 and 15 DOF (phase 15 a, b)",
        "slam_imu": "slam --imu, 10 frames of 720x1280 (phase 15 c)",
        "serve": "FlowServer, fast stream at 1080^2 over TCP, pooled (phase 16 a)",
        "serve_faithful": "FlowServer, faithful stream at 256^2 (phase 16 b)",
        "serve_mesh": "FlowServer(mesh=2x2 tile mesh), fast stream at 1080^2 (phase 16 a)",
        "ranks": "sharded_coarse_to_fine, fast, 2x2 mesh whose rows lie on two ranks, rank 0 "
                 "(phase 17 c)",
        "native": "VideoPipeline(fast).run(prefetch=2) from the native decoder, 12 frames of "
                  "720x1280 (phase 18 a)",
        "scaling_report": "examples.scaling_report --size 540: batch scaling, then the sharded "
                          "pyramid over 4 slots of the card (phase 18 b)"}
PROFILE_WARMUP, PROFILE_FRAMES = 5, 40
REFERENCE_PROFILE_FRAMES = 20
HOST_WARM, HOST_TIMED = 5, 30  # phase 11 (e): frames before and inside the timed window
CHUNK, CHUNKS_WARM, CHUNKS_TIMED = 16, 2, 4  # run_chunked: the first chunk, the capture, then replays
USE_ONCE_SETS = 30  # timed calls of a kernel on fresh inputs (device time)
# phase 10's sustained rates: S2's column interleave and S4's float32 chain at
# sizes that fill the card many times over, on fresh inputs far beyond its L2
SUSTAINED_COPY_HW = (8192, 4096)  # 512 MiB moved a call
SUSTAINED_CHAIN = (1 << 23, 1024)  # elements, steps: 17.2 G operations a call
SUSTAINED_SETS = 4
SASS_OPS = ("FFMA", "HFMA2", "FMUL", "FADD", "HMUL2", "HADD2", "F2FP")  # counted in S4's kernels
# phase 10's bit-for-bit sweeps of S2-S4: plane heights and widths (each
# also as a view 4 bytes past a 16-byte boundary); S3's widths, windows (and
# W - 12 at each width) and leading dims (1, 3 and 1,320 rows, 2-D and 3-D);
# chain lengths (odd) and step counts, and the random pairs of
# probes.bf16_sweep_patterns
S2_SWEEP_H, S2_SWEEP_W = (1, 2, 1080), (1, 3, 537, 540)
S3_SWEEP_W, S3_SWEEP_WIN = (13, 16, 1277, 1280), (0, 1, 1155, 1156)
S3_SWEEP_LEAD = ((1,), (1, 1), (3,), (3, 1), (1320,), (15, 88))
S4_SWEEP_N, S4_SWEEP_STEPS = (1, 3, 7, 9, 1001, 524_287), (0, 1, 3, 64)
S4_SPECIAL_N = 100_000
FLOW_RANGES = [(0.0, 1.0)] * 2 + [(-2.0, 2.0)] * 2  # K3/K4 timing inputs: frames, then flows
# phase 12: of.cpp:51's corner arguments; the patch of synthetic_frames moves
# (+3, +2) px a frame; the exact shift warp's reach at clamp 8 (resolve_warp_impl)
CORNERS = (500, 0.01, 10)
PATCH_MOTION = (3.0, 2.0)
SHIFT_MAX_DISP = 5
TIMED_CALLS = 5  # phase 12 (e): calls timed after two of warm-up
# phase 13: 8 gray 720p frames of a camera sliding +x by 0.02 a frame over a
# depth field of [3, 12] at focal 1000 (1.7-6.7 px of parallax a frame); the
# bundle adjustment scenes of tests/test_slam.py (focal 500)
SFM_FRAMES, SFM_HW, SFM_FOCAL, SFM_STEP = 8, (720, 1280), 1000.0, 0.02
BA_FOCAL = 500.0
# phase 14: tests/test_incremental_slam.py's and tests/test_stereo_slam.py's
# scenes at 720x1280, the focal scaled by 1280/416 and the loop radii and the
# rig baseline by 416/1280, so that a frame moves about as many pixels as in
# the tests and the rig's disparities stay theirs (12-40 px); the loop's x
# radius is the unit of the centre errors
SLAM_FRAMES, SLAM_HW, SLAM_SCALE = 10, (720, 1280), 416 / 1280
SLAM_FOCAL = 400.0 / SLAM_SCALE
SLAM_BASELINE = 0.3 * SLAM_SCALE
SLAM_RADIUS = 0.12 * SLAM_SCALE
SLAM_KW = dict(loop_min_separation=6, loop_min_inliers=30, min_tracks=40, window=8)
# phase 15: tests/test_vi_ba.py's trajectory (_traj) at the size of phase 13
# (c)'s BA: 50 keyframes 0.5 s apart, an exact 200 Hz IMU log (49 intervals of
# 100 samples), 10,000 points at depths 3-6, each seen by 6 consecutive
# keyframes (60,000 observations at focal 500); phase 14's loop takes one
# period of IMU_PERIOD s, as in tests/test_vi_ba.py's SLAM tests
VI_KEYFRAMES, VI_DT_KF, VI_RATE, VI_POINTS, VI_TRACK = 50, 0.5, 200.0, 10_000, 6
IMU_PERIOD = 6.0
G_W = np.array([0.0, -9.81, 0.0])


def log(msg: str) -> None:
    print(msg, flush=True)


def check_counts(what, counts, want):
    """Raise unless the launch counts are exactly `want` (absent: 0)."""
    want = {name: want.get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"{what} launch counts {counts} != {want}")


def grid_mesh(device):
    from optical_flow_tpu_torch.parallel.mesh import flow_mesh

    return flow_mesh(1, *GRID, devices=[device] * (GRID[0] * GRID[1]))


# ------------------------------------------------------------------ inputs


def smooth_texture(rng, h, w, sigma):
    """Unit-range random texture, Gaussian-smoothed (FFT, periodic)."""
    noise = rng.rand(h, w)
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    g = np.exp(-2.0 * (np.pi * sigma) ** 2 * (fx * fx + fy * fy))
    t = np.fft.irfft2(np.fft.rfft2(noise) * g, s=(h, w))
    t -= t.min()
    return t / max(t.max(), 1e-12)


def smooth_flow(rng, shape, scale):
    """Smooth flow like tests/test_warp_lk_kernel.py:52-58: coarse noise
    upsampled bilinearly, times `scale`, plus a constant component."""
    import torch

    H, W = shape
    coarse = torch.from_numpy(rng.randn(2, max(H // 8, 1), max(W // 8, 1)).astype(np.float32))
    f = torch.nn.functional.interpolate(coarse[None], size=(H, W), mode="bilinear",
                                        align_corners=False)[0]
    f = f * scale + torch.from_numpy((rng.randn(2) * scale).astype(np.float32))[:, None, None]
    return f[0].contiguous().numpy(), f[1].contiguous().numpy()


def bilinear_shift(img, dy, dx, pad):
    """img2(p) = img(p - d) sampled bilinearly; `img` carries `pad` margin."""
    H, W = img.shape[0] - 2 * pad, img.shape[1] - 2 * pad
    ys, xs = np.mgrid[0:H, 0:W]
    y, x = ys + pad - dy, xs + pad - dx
    y0, x0 = np.floor(y).astype(int), np.floor(x).astype(int)
    fy, fx = y - y0, x - x0
    g = img
    return (g[y0, x0] * (1 - fy) * (1 - fx) + g[y0, x0 + 1] * (1 - fy) * fx
            + g[y0 + 1, x0] * fy * (1 - fx) + g[y0 + 1, x0 + 1] * fy * fx)


def synthetic_frames(rng, n, hw):
    """BGR uint8 frames: a textured background and a textured patch that
    moves (+3, +2) px per frame."""
    H, W = hw
    bg = smooth_texture(rng, H, W, 4.0)
    ph, pw = H // 4, W // 6
    patch = smooth_texture(rng, ph, pw, 2.0)
    tint = rng.rand(3) * 0.5 + 0.5
    frames = []
    for t in range(n):
        g = 0.6 * bg
        y, x = H // 3 + 2 * t, W // 3 + 3 * t
        g[y : y + ph, x : x + pw] = 0.3 + 0.7 * patch
        frames.append(np.clip(g[..., None] * tint * 255.0, 0, 255).astype(np.uint8))
    return frames


# ------------------------------------------------------------- comparisons


def well_conditioned(w1, w2):
    """Pixels whose 2x2 LK system is not near-singular (the mask of
    tests/test_warp_lk_kernel.py:61-81, on the planes the solve sees)."""
    import torch

    from optical_flow_tpu_torch.ops.gradients import spatio_temporal_gradients
    from optical_flow_tpu_torch.ops.window import sum3x3_interior

    fx, fy, _ = spatio_temporal_gradients(w1, w2)
    s = sum3x3_interior(torch.stack([fx * fx, fy * fy, fx * fy]))
    det = s[0] * s[1] - s[2] * s[2]
    return det.abs() > 1e-6 * torch.clamp_min(det.abs().max(), 1.0)


def masked_err(a, b, mask):
    import torch

    z = torch.zeros((), dtype=a.dtype, device=a.device)
    return float((torch.where(mask, a, z) - torch.where(mask, b, z)).abs().max())


def flatten_results(results):
    """Chunked results (a leading batch axis, or one frame for the tail) as
    one list of per-pair FrameResults."""
    from optical_flow_tpu_torch.pipeline.gesture import GestureResult
    from optical_flow_tpu_torch.pipeline.video import FrameResult

    out = []
    for r in results:
        if r.u.ndim == 2:
            out.append(r)
            continue
        for k in range(r.u.shape[0]):
            out.append(FrameResult(r.u[k], r.v[k], GestureResult(*(x[k] for x in r.gesture))))
    return out


def same_results(what, got, want):
    """Raise unless flows, magnitudes, votes and centroids are equal bit for bit."""
    import torch

    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} results, want {len(want)}")
    for k, (a, b) in enumerate(zip(got, want)):
        pairs = [(a.u, b.u), (a.v, b.v)] + list(zip(a.gesture, b.gesture))
        if not all(torch.equal(x, y) for x, y in pairs):
            raise AssertionError(f"{what}: result {k} differs")


def slice_bar(what, got, want):
    """The slice bar (median |dflow| < 1e-3 px, q99 < 0.02 px on the interior,
    votes within 1%); returns the quantiles and the max |d(u, v)|."""
    import torch

    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} results, want {len(want)}")
    d, max_abs = [], 0.0
    inner = (slice(8, -8), slice(8, -8))
    for a, b in zip(got, want):
        if not all(bool(torch.isfinite(x).all()) for x in (a.u, a.v, b.u, b.v)):
            raise AssertionError(f"{what}: flow is not finite")
        d.append(torch.hypot(a.u[inner] - b.u[inner], a.v[inner] - b.v[inner]).flatten())
        max_abs = max(max_abs, float((a.u - b.u).abs().max()), float((a.v - b.v).abs().max()))
        x, y = int(a.gesture.votes), int(b.gesture.votes)
        if abs(x - y) > max(1.0, 0.01 * max(x, y)):
            raise AssertionError(f"{what}: votes differ beyond 1%: {x} vs {y}")
    d = torch.cat(d).double().cpu().numpy()
    med, q99 = float(np.median(d)), float(np.quantile(d, 0.99))
    if not (med < 1e-3 and q99 < 0.02):
        raise AssertionError(f"{what}: median {med:.3g}, q99 {q99:.3g}")
    return {"flow_median": med, "flow_q99": q99, "flow_max_abs_diff": max_abs}


def time_pair(plain, kernel, iters):
    """(kernel ms, plain ms) per call: CUDA events over `iters` calls in
    turns plain, kernel, kernel, plain after one warm-up call of each."""
    import torch

    plain()
    kernel()
    torch.cuda.synchronize()
    ms = {"plain": [], "kernel": []}
    for which, fn in (("plain", plain), ("kernel", kernel), ("kernel", kernel), ("plain", plain)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        ms[which].append(start.elapsed_time(end) / iters)
    return float(np.mean(ms["kernel"])), float(np.mean(ms["plain"]))


# ----------------------------------------------------------------- phases


def phase_kernels(device, iters=20):
    """Each kernel vs its plain version at the main-path shapes. Returns
    {name: {"max_abs_err", "ms", "plain_ms", "library_ms", "device_ms",
    "bytes", "ops", "by_shape"}}, times, bytes and operations summed over
    the shapes one 1080^2 frame runs (K1: 135^2 on the fast path, all four
    levels on the reference path; S1: the reference path's three
    upsamples). "ms" and "plain_ms" repeat one call on the same inputs, so
    a kernel shorter than its launch reads as the host's launch cost;
    "device_ms" is the kernel's device time on use-once inputs
    (utils/profiling.time_use_once; K5: the four tiles of a frame); P1's
    and its ``clone``'s ("library_ms") are the medians of P1_ROUNDS rounds
    in turns, each round's reading kept ("device_ms_runs",
    "library_ms_runs"). K3-K5 also run the ragged and C sweep ("sweep"),
    held to 0 like the main shapes, and K2 and P1 their ragged and tiny
    cases. K2 is "pyramid" (the one call every path makes) and "pyrdown"
    (its single levels, summed over the frame's three), which main folds
    into one row. K2's and S1's "library_ms" time one cuDNN convolution that
    computes the same function ("library_max_abs_diff": its distance from
    the plain version); the port never calls it."""
    import torch
    import torch.nn.functional as F

    from optical_flow_tpu_torch.kernels.lk_kernel import lucas_kanade_cuda, lucas_kanade_plain
    from optical_flow_tpu_torch.kernels.pyrdown_kernel import (
        gaussian_pyramid_cuda, pyr_down_cuda, pyr_down_plain,
    )
    from optical_flow_tpu_torch.kernels.warp_lk_kernel import (
        pyrup_warp_lk_cuda, pyrup_warp_lk_plain, warp_lk_cuda, warp_lk_plain,
    )
    from optical_flow_tpu_torch.kernels.pyrup_kernel import pyr_up_pair_cuda, pyr_up_pair_plain
    from optical_flow_tpu_torch.kernels.remap_kernel import (
        symmetric_remap_cuda, symmetric_remap_plain,
    )
    from optical_flow_tpu_torch.config import PreprocessConfig
    from optical_flow_tpu_torch.kernels.features_kernel import (
        MAX_MORPH_ITERATIONS, diff_features_cuda,
    )
    from optical_flow_tpu_torch.kernels.tile_copy_kernel import tile_copy_cuda, tile_copy_plain
    from optical_flow_tpu_torch.kernels.warp_lk_kernel import pyrup_coarse_halo
    from optical_flow_tpu_torch.pipeline.preprocess import diff_features
    from optical_flow_tpu_torch.ops.pyramid import (
        _K5, _K5UP, _pad_pyrup, gaussian_pyramid, pyr_up_cols_first,
    )
    from optical_flow_tpu_torch.ops.warp import symmetric_warp
    from optical_flow_tpu_torch.parallel.halo import exchange_halo, exchange_halo_pyrup
    from optical_flow_tpu_torch.parallel.mesh import split
    from optical_flow_tpu_torch.utils.profiling import (
        OPS_PER_OUTPUT, Cost, io_bytes, kernel_cost, time_use_once,
    )

    rng = np.random.RandomState(SEED)
    gen = torch.Generator(device=device).manual_seed(SEED)
    mesh = grid_mesh(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    def warped(a, b, wu, wv, md=C):
        return symmetric_warp(a, b, wu, wv, quantize=True, impl="shift_sep", max_disp=md)

    def fresh(like, ranges):
        return tuple(torch.empty(x.shape, device=device).uniform_(lo, hi, generator=gen)
                     for x, (lo, hi) in zip(like, ranges))

    def use_once(kernel, like, ranges=None, **kw):
        """Device ms per call of `kernel(*inputs, **kw)` on USE_ONCE_SETS fresh
        input sets shaped like `like`, each input uniform in its (lo, hi) of
        `ranges` (default [0, 1))."""
        ranges = ranges or [(0.0, 1.0)] * len(like)
        return time_use_once(lambda *x: kernel(*x, **kw),
                             [fresh(like, ranges) for _ in range(USE_ONCE_SETS + 1)], device)

    results = {}

    def record(name, shape, err, ms, plain_ms, tol, cost, full_err=None, library_ms=None,
               device_ms=None, unmasked=None, library_diff=None):
        if not err <= tol:
            raise AssertionError(f"{name} at {shape}: max|err| {err:.3g} > {tol:g}")
        if full_err is not None and not full_err == 0.0:
            raise AssertionError(f"{name} at {shape}: max|err| {full_err:.3g} vs the full-frame "
                                 "kernel's region, want 0")
        r = results.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                      "library_ms": None, "device_ms": None, "bytes": 0.0,
                                      "ops": 0.0, "by_shape": []})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bytes"] += cost.bytes
        r["ops"] += cost.ops
        if library_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + library_ms
        if device_ms is not None:
            r["device_ms"] = (r["device_ms"] or 0.0) + device_ms
        r["by_shape"].append({"shape": list(shape), "max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "library_ms": library_ms,
                              "device_ms": device_ms, "bytes": cost.bytes, "ops": cost.ops})
        if library_diff is not None:
            r["by_shape"][-1]["library_max_abs_diff"] = library_diff
        if unmasked is not None:
            r["by_shape"][-1]["max_abs_err_unmasked"] = unmasked
            r["max_abs_err_unmasked"] = max(r.get("max_abs_err_unmasked", 0.0), unmasked)
        vs_full = "" if full_err is None else f", vs full frame {full_err:.3g}"
        if unmasked is not None:
            vs_full = f", unmasked {unmasked:.3g}" + vs_full
        lib = "" if library_ms is None else f", library {library_ms * 1e3:.1f} us"
        dev = "" if device_ms is None else f", device {device_ms * 1e3:.2f} us"
        log(f"  {name} {shape[0]}x{shape[1]}: max|err| {err:.3g} (tol {tol:g}){vs_full}, "
            f"kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us{lib}{dev}")

    def tile_cost(kind, calls, shape):
        """K5 over the 2x2 grid: each extended input tile read once, each
        tile's (u, v) written once."""
        h, w = shape[0] // GRID[0], shape[1] // GRID[1]
        return Cost(sum(io_bytes(args) + 2 * 4 * h * w for args, _, _ in calls),
                    len(calls) * OPS_PER_OUTPUT[kind] * h * w)

    def tile_calls(ext, shape, md=C):
        """Each tile's (extended inputs, tile keywords, region of the frame)
        on the 2x2 grid; the extended tiles are what the sharded wrappers
        hand K5 (split + halo exchange)."""
        h, w = shape[0] // GRID[0], shape[1] // GRID[1]
        calls = []
        for idx in np.ndindex(ext[0].shape):
            r0, c0 = idx[1] * h, idx[2] * w
            calls.append(([e[idx] for e in ext], dict(halo=md + 2, origin=(r0, c0), global_hw=shape),
                          (slice(r0, r0 + h), slice(c0, c0 + w))))
        return calls

    def pair_errors(out, ref, mask):
        """(max |err| of (u, v) on the mask, max |err| everywhere)."""
        err = max(masked_err(out[0], ref[0], mask), masked_err(out[1], ref[1], mask))
        return err, max(float((o - r).abs().max()) for o, r in zip(out, ref))

    def tile_errors(calls, kernel, plain, kw, full, mask):
        """K5 per tile: max |kernel - plain| on the same extended tile (on the
        mask and everywhere), and max |kernel - the full-frame kernel's
        region|."""
        err = unmasked = full_err = 0.0
        for args, tile, reg in calls:
            out, ref = kernel(*args, **kw, **tile), plain(*args, **kw, **tile)
            torch.cuda.synchronize()
            e, ue = pair_errors(out, ref, mask[reg])
            err, unmasked = max(err, e), max(unmasked, ue)
            full_err = max(full_err, *(float((o - f[reg]).abs().max()) for o, f in zip(out, full)))
        return err, unmasked, full_err

    def each_tile(fn, calls, kw):
        return lambda: [fn(*args, **kw, **tile) for args, tile, _ in calls]

    def tile_use_once(kernel, calls, kw):
        """Device ms of one frame's tiles (one launch each), every timed call
        on fresh extended tiles of the same shapes."""
        tiles = [tile for _, tile, _ in calls]
        sets = [([fresh(args, FLOW_RANGES) for args, _, _ in calls],)
                for _ in range(USE_ONCE_SETS + 1)]
        return time_use_once(lambda xs: [kernel(*x, **kw, **tl) for x, tl in zip(xs, tiles)],
                             sets, device)

    def flow_pair(shape, scale):
        """Smooth (u, v) of `shape` (leading dims: one flow each)."""
        lead, hw = shape[:-2], shape[-2:]
        fs = [smooth_flow(rng, hw, scale) for _ in range(int(np.prod(lead, dtype=int)))]
        return tuple(t(np.stack([f[k] for f in fs]).reshape(shape)) for k in (0, 1))

    def k3_mask(a, b, uc, vc, md, cl):
        upu, upv = 2.0 * pyr_up_cols_first(uc), 2.0 * pyr_up_cols_first(vc)
        return well_conditioned(*warped(a, b, -upu.clamp(-cl, cl), -upv.clamp(-cl, cl), md))

    def k4_mask(a, b, u, v, md, cl):
        return well_conditioned(*warped(a, b, -u.clamp(-cl, cl), -v.clamp(-cl, cl), md))

    def sweep(name, shape, md, err, unmasked, mask, full_err=None):
        """One case of the ragged and C sweep, held to 0 on the mask."""
        share = float(mask.double().mean())
        if not err <= ATOL_WARP_LK or not share > 0.5:
            raise AssertionError(f"{name} sweep at {shape}, C={md}: max|err| {err:.3g} "
                                 f"on {share:.3f} of the pixels")
        if full_err is not None and not full_err == 0.0:
            raise AssertionError(f"{name} sweep at {shape}, C={md}: vs the full-frame kernel "
                                 f"{full_err:.3g}, want 0")
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["max_abs_err_unmasked"] = max(r.get("max_abs_err_unmasked", 0.0), unmasked)
        r.setdefault("sweep", []).append({"shape": list(shape), "max_disp": md, "max_abs_err": err,
                                          "max_abs_err_unmasked": unmasked,
                                          "well_conditioned_share": share, "vs_full": full_err})
        vs_full = "" if full_err is None else f", vs full frame {full_err:.3g}"
        log(f"  {name} sweep {'x'.join(map(str, shape))} C={md}: max|err| {err:.3g} on "
            f"{share:.3f} of the pixels, unmasked {unmasked:.3g}{vs_full}")

    for shape in K1_SHAPES:
        a, b = t(rng.rand(*shape)), t(rng.rand(*shape))
        out, ref = lucas_kanade_cuda(a, b), lucas_kanade_plain(a, b)
        torch.cuda.synchronize()
        err, unmasked = pair_errors(out, ref, well_conditioned(a, b))
        ms, pms = time_pair(lambda: lucas_kanade_plain(a, b), lambda: lucas_kanade_cuda(a, b), iters)
        record("lk", shape, err, ms, pms, ATOL_LK, kernel_cost("lk", [a, b], list(out)),
               device_ms=use_once(lucas_kanade_cuda, (a, b)), unmasked=unmasked)
    # K1's ragged sweep (not timed), held to 0 on the mask
    for shape in K1_SWEEP:
        a, b = t(rng.rand(*shape)), t(rng.rand(*shape))
        err, unmasked = pair_errors(lucas_kanade_cuda(a, b), lucas_kanade_plain(a, b),
                                    well_conditioned(a, b))
        results["lk"].setdefault("sweep", []).append(
            {"shape": list(shape), "max_abs_err": err, "max_abs_err_unmasked": unmasked})
        results["lk"]["max_abs_err_unmasked"] = max(results["lk"]["max_abs_err_unmasked"], unmasked)
        log(f"  lk sweep {'x'.join(map(str, shape))}: max|err| {err:.3g}, unmasked {unmasked:.3g}")
        if not err <= ATOL_LK:
            raise AssertionError(f"lk sweep at {shape}: max|err| {err:.3g} on the mask, want 0")
    # the library calls: cuDNN convolutions with the same taps, TF32 off
    # (main sets it); timed only, never called by the port
    k5 = torch.tensor(_K5, device=device)
    g5x5 = torch.outer(k5, k5)[None, None]
    k5up = torch.tensor(_K5UP, device=device)
    up5x5 = torch.outer(k5up, k5up)[None, None]

    def pyr_down_conv(x):  # reflect-101 pad, 5x5 taps at stride 2
        return F.conv2d(F.pad(x[None, None], (2, 2, 2, 2), mode="reflect"), g5x5, stride=2)[0, 0]

    def pyramid_conv(x, levels):
        out = [x]
        for _ in range(levels - 1):
            out.append(pyr_down_conv(out[-1]))
        return out

    def pyr_up_pair_conv(u, v):  # pyrUp's border pad, then a stride-2 transposed conv
        y = F.conv_transpose2d(_pad_pyrup(torch.stack([u, v])[:, None]), up5x5, stride=2,
                               padding=4, output_padding=1)
        return y[0, 0], y[1, 0]

    def levels_err(got, want):
        if [tuple(g.shape) for g in got] != [tuple(w.shape) for w in want]:
            raise AssertionError(f"pyramid shapes {[tuple(g.shape) for g in got]} != "
                                 f"{[tuple(w.shape) for w in want]}")
        return max(float((g - w).abs().max()) for g, w in zip(got, want))

    for shape in S1_SHAPES:
        # reference-mode flow is not a displacement: tens of px and more
        u, v = t(rng.randn(*shape) * 50.0), t(rng.randn(*shape) * 50.0)
        (u1, v1), (u0, v0) = pyr_up_pair_cuda(u, v), pyr_up_pair_plain(u, v)
        torch.cuda.synchronize()
        err = max(float((u1 - u0).abs().max()), float((v1 - v0).abs().max()))
        ms, pms = time_pair(lambda: pyr_up_pair_plain(u, v), lambda: pyr_up_pair_cuda(u, v), iters)
        record("pyrup", shape, err, ms, pms, 0.0, kernel_cost("pyrup", [u, v], [u1, v1]),
               device_ms=use_once(pyr_up_pair_cuda, (u, v), [(-100.0, 100.0)] * 2),
               library_ms=use_once(pyr_up_pair_conv, (u, v), [(-100.0, 100.0)] * 2),
               library_diff=levels_err(pyr_up_pair_conv(u, v), (u0, v0)))
    # S1's ragged sweep (not timed) at odd and even coarse widths, bit for bit
    for shape in S1_SWEEP:
        u, v = t(rng.randn(*shape) * 50.0), t(rng.randn(*shape) * 50.0)
        err = levels_err(pyr_up_pair_cuda(u, v), pyr_up_pair_plain(u, v))
        results["pyrup"].setdefault("sweep", []).append({"shape": list(shape), "max_abs_err": err})
        log(f"  pyrup sweep {'x'.join(map(str, shape))}: max|err| {err:.3g}")
        if err != 0.0:
            raise AssertionError(f"pyrup sweep at {shape}: max|err| {err:.3g}, want 0")
    # W1 at the warped levels: smooth flows of tens of px (reference-mode flow
    # is not a displacement) with per-pixel noise; no PyTorch call computes
    # cv::remap's fixed-point bilinear, so no library time
    for shape in W1_SHAPES:
        a, b = t(rng.rand(*shape)), t(rng.rand(*shape))
        u, v = (f + t(rng.uniform(-2.0, 2.0, shape)) for f in flow_pair(shape, 20.0))
        out, ref = symmetric_remap_cuda(a, b, u, v), symmetric_remap_plain(a, b, u, v)
        torch.cuda.synchronize()
        err = levels_err(out, ref)
        ms, pms = time_pair(lambda: symmetric_remap_plain(a, b, u, v),
                            lambda: symmetric_remap_cuda(a, b, u, v), iters)
        record("remap", shape, err, ms, pms, 0.0, kernel_cost("remap", [a, b, u, v], list(out)),
               device_ms=use_once(symmetric_remap_cuda, (a, b, u, v), FLOW_RANGES))
    # W1's sweep (not timed): both forms, uint8 frames of a batch, bit for bit
    for shape in W1_SWEEP:
        a, b = t(rng.rand(*shape) * 255.0), t(rng.rand(*shape) * 255.0)
        u, v = t(rng.uniform(-40.0, 40.0, shape)), t(rng.uniform(-40.0, 40.0, shape))
        err = max(levels_err(symmetric_remap_cuda(a, b, u, v, quantize=q),
                             symmetric_remap_plain(a, b, u, v, quantize=q)) for q in (True, False))
        a8, b8 = a.to(torch.uint8), b.to(torch.uint8)
        err = max(err, levels_err(symmetric_remap_cuda(a8, b8, u, v),
                                  symmetric_remap_plain(a8, b8, u, v)))
        results["remap"].setdefault("sweep", []).append({"shape": list(shape), "max_abs_err": err})
        log(f"  remap sweep {'x'.join(map(str, shape))}: max|err| {err:.3g}")
        if err != 0.0:
            raise AssertionError(f"remap sweep at {shape}: max|err| {err:.3g}, want 0")
    # F1, the frame's feature map at 1080^2: float32 planes (the fast path's)
    # and uint8 ones (the faithful path's, saturating), one frame and a chunk
    # of 16; no PyTorch call fuses the diff, Sobel and the morphology, so no
    # library time
    def gray_sets(shape, dtype, n):
        if dtype == torch.uint8:
            return [tuple(torch.randint(0, 256, shape, generator=gen, device=device,
                                        dtype=torch.uint8) for _ in range(2)) for _ in range(n)]
        return [tuple(torch.empty(shape, device=device).uniform_(0.0, 255.0, generator=gen)
                      for _ in range(2)) for _ in range(n)]

    for name, dtype, cfg in (("features", torch.float32, PreprocessConfig(faithful_uint8=False)),
                             ("features_u8", torch.uint8, PreprocessConfig())):
        for shape in F1_SHAPES:
            sets = gray_sets(shape, dtype, (USE_ONCE_SETS if len(shape) == 2 else F1_BATCH_SETS) + 1)
            a, b = sets[0]
            out, ref = diff_features_cuda(a, b, cfg), diff_features(a, b, cfg)
            torch.cuda.synchronize()
            err = levels_err([out], [ref])
            ms, pms = time_pair(lambda: diff_features(a, b, cfg),
                                lambda: diff_features_cuda(a, b, cfg), iters)
            record(name if len(shape) == 2 else f"{name}_b{shape[0]}", shape, err, ms, pms, 0.0,
                   kernel_cost("features", [a, b], [out]),
                   device_ms=time_use_once(lambda x, y: diff_features_cuda(x, y, cfg), sets,
                                           device))
            del sets, a, b, out, ref
    # F1's sweep (not timed): odd planes and a batch, every radius it takes,
    # float32 and uint8 with and without the saturation, bit for bit
    for shape in F1_SWEEP:
        for dtype, faithful in ((torch.float32, False), (torch.uint8, True), (torch.uint8, False)):
            a, b = gray_sets(shape, dtype, 1)[0]
            err = max(levels_err([diff_features_cuda(a, b, c)], [diff_features(a, b, c)])
                      for c in (PreprocessConfig(faithful_uint8=faithful, morph_iterations=r)
                                for r in range(MAX_MORPH_ITERATIONS + 1)))
            what = f"{'x'.join(map(str, shape))} {str(dtype)[6:]}{' saturated' if faithful else ''}"
            results["features"].setdefault("sweep", []).append(
                {"shape": list(shape), "dtype": str(dtype)[6:], "saturate": faithful,
                 "max_abs_err": err})
            log(f"  features sweep {what}: max|err| {err:.3g}")
            if err != 0.0:
                raise AssertionError(f"features sweep at {what}: max|err| {err:.3g}, want 0")
    for shape in K2_SHAPES:
        x = t(rng.rand(*shape) * 255.0)
        y1, y0 = pyr_down_cuda(x), pyr_down_plain(x)
        torch.cuda.synchronize()
        err = levels_err([y1], [y0])
        ms, pms = time_pair(lambda: pyr_down_plain(x), lambda: pyr_down_cuda(x), iters)
        record("pyrdown", shape, err, ms, pms, ATOL_PYRDOWN, kernel_cost("pyrdown", [x], [y1]),
               device_ms=use_once(pyr_down_cuda, (x,), [(0.0, 255.0)]),
               library_ms=use_once(pyr_down_conv, (x,), [(0.0, 255.0)]),
               library_diff=levels_err([pyr_down_conv(x)], [y0]))
    (shape, levels) = PYRAMID
    x = t(rng.rand(*shape) * 255.0)
    got, want = gaussian_pyramid_cuda(x, levels), gaussian_pyramid(x, levels, impl="poly")
    torch.cuda.synchronize()
    ms, pms = time_pair(lambda: gaussian_pyramid(x, levels, impl="poly"),
                        lambda: gaussian_pyramid_cuda(x, levels), iters)
    record("pyramid", shape, levels_err(got, want), ms, pms, ATOL_PYRDOWN,
           kernel_cost("pyramid", [x], got[1:], outputs_counted=sum(g.numel() for g in got[1:])),
           device_ms=use_once(gaussian_pyramid_cuda, (x,), [(0.0, 255.0)], levels=levels),
           library_ms=use_once(pyramid_conv, (x,), [(0.0, 255.0)], levels=levels),
           library_diff=levels_err(pyramid_conv(x, levels), want))
    results["pyramid"]["by_shape"][-1].update(entry="oft_pyramid", levels=levels)
    # the tracking pyramid (phase 12's path), kept apart from the frame's totals
    (shape, levels) = TRACK_PYRAMID
    x = t(rng.rand(*shape) * 255.0)
    got, want = gaussian_pyramid_cuda(x, levels), gaussian_pyramid(x, levels, impl="poly")
    torch.cuda.synchronize()
    ms, pms = time_pair(lambda: gaussian_pyramid(x, levels, impl="poly"),
                        lambda: gaussian_pyramid_cuda(x, levels), iters)
    record("pyramid_track", shape, levels_err(got, want), ms, pms, ATOL_PYRDOWN,
           kernel_cost("pyramid", [x], got[1:], outputs_counted=sum(g.numel() for g in got[1:])),
           device_ms=use_once(gaussian_pyramid_cuda, (x,), [(0.0, 255.0)], levels=levels),
           library_ms=use_once(pyramid_conv, (x,), [(0.0, 255.0)], levels=levels),
           library_diff=levels_err(pyramid_conv(x, levels), want))
    results["pyramid_track"]["by_shape"][-1].update(entry="oft_pyramid", levels=levels, path="track")
    # K2's ragged and tiny cases (not timed), bit for bit
    for shape, levels in K2_SWEEP_PYRAMIDS:
        x = t(rng.rand(*shape) * 255.0)
        err = levels_err(gaussian_pyramid_cuda(x, levels), gaussian_pyramid(x, levels, impl="poly"))
        results["pyramid"].setdefault("sweep", []).append(
            {"shape": list(shape), "entry": "oft_pyramid", "levels": levels, "max_abs_err": err})
        log(f"  pyramid sweep {'x'.join(map(str, shape))}, {levels} levels: max|err| {err:.3g}")
    for shape in K2_SWEEP_LEVELS:
        x = t(rng.rand(*shape) * 255.0)
        err = levels_err([pyr_down_cuda(x)], [pyr_down_plain(x)])
        results["pyrdown"].setdefault("sweep", []).append(
            {"shape": list(shape), "max_abs_err": err})
        log(f"  pyrdown sweep {'x'.join(map(str, shape))}: max|err| {err:.3g}")
    for name in ("pyrdown", "pyramid"):
        bad = [c for c in results[name]["sweep"] if not c["max_abs_err"] <= ATOL_PYRDOWN]
        if bad:
            raise AssertionError(f"{name} sweep differs from the plain version: {bad}")
    kw3 = dict(max_disp=C, clamp=CLAMP)
    for shape in K3_SHAPES:
        H, W = shape
        a, b = t(rng.rand(H, W)), t(rng.rand(H, W))
        uc, vc = (t(f) for f in smooth_flow(rng, (H // 2, W // 2), 2.0))
        out, ref = pyrup_warp_lk_cuda(a, b, uc, vc, **kw3), pyrup_warp_lk_plain(a, b, uc, vc, **kw3)
        torch.cuda.synchronize()
        err, unmasked = pair_errors(out, ref, k3_mask(a, b, uc, vc, C, CLAMP))
        ms, pms = time_pair(lambda: pyrup_warp_lk_plain(a, b, uc, vc, **kw3),
                            lambda: pyrup_warp_lk_cuda(a, b, uc, vc, **kw3), iters)
        record("pyrup_warp_lk", shape, err, ms, pms, ATOL_WARP_LK,
               kernel_cost("pyrup_warp_lk", [a, b, uc, vc], list(out)),
               device_ms=use_once(pyrup_warp_lk_cuda, (a, b, uc, vc), FLOW_RANGES, **kw3),
               unmasked=unmasked)
    kw4 = dict(max_disp=C, clamp=CLAMP, negate=True)
    for shape in K4_SHAPES:
        a, b = t(rng.rand(*shape)), t(rng.rand(*shape))
        u, v = (t(f) for f in smooth_flow(rng, shape, 2.0))
        out, ref = warp_lk_cuda(a, b, u, v, **kw4), warp_lk_plain(a, b, u, v, **kw4)
        torch.cuda.synchronize()
        err, unmasked = pair_errors(out, ref, k4_mask(a, b, u, v, C, CLAMP))
        ms, pms = time_pair(lambda: warp_lk_plain(a, b, u, v, **kw4),
                            lambda: warp_lk_cuda(a, b, u, v, **kw4), iters)
        record("warp_lk", shape, err, ms, pms, ATOL_WARP_LK,
               kernel_cost("warp_lk", [a, b, u, v], list(out)),
               device_ms=use_once(warp_lk_cuda, (a, b, u, v), FLOW_RANGES, **kw4),
               unmasked=unmasked)

    def k5_warp_calls(shape, md, scale):
        a, b = t(rng.rand(*shape)), t(rng.rand(*shape))
        u, v = (t(f) for f in smooth_flow(rng, shape, scale))
        kw = dict(max_disp=md, clamp=2.0 * md, negate=True)
        full = warp_lk_cuda(a, b, u, v, **kw)
        calls = tile_calls([exchange_halo(split(x, mesh), md + 2, border="zero")
                            for x in (a, b, u, v)], shape, md)
        return calls, kw, full, k4_mask(a, b, u, v, md, 2.0 * md)

    def k5_pyrup_calls(shape, md, scale):
        H, W = shape
        a, b = t(rng.rand(H, W)), t(rng.rand(H, W))
        uc, vc = (t(f) for f in smooth_flow(rng, (H // 2, W // 2), scale))
        kw = dict(max_disp=md, clamp=2.0 * md)
        full = pyrup_warp_lk_cuda(a, b, uc, vc, **kw)
        ext = [exchange_halo(split(x, mesh), md + 2, border="zero") for x in (a, b)]
        ext += [exchange_halo_pyrup(split(x, mesh), pyrup_coarse_halo(md), 2) for x in (uc, vc)]
        return tile_calls(ext, shape, md), kw, full, k3_mask(a, b, uc, vc, md, 2.0 * md)

    k5 = {"warp_lk_tile": ("warp_lk", warp_lk_cuda, warp_lk_plain, k5_warp_calls),
          "pyrup_warp_lk_tile": ("pyrup_warp_lk", pyrup_warp_lk_cuda, pyrup_warp_lk_plain,
                                 k5_pyrup_calls)}
    for name, shapes in (("warp_lk_tile", K5_WARP_SHAPES), ("pyrup_warp_lk_tile", K5_PYRUP_SHAPES)):
        kind, kernel, plain, make = k5[name]
        for shape in shapes:
            calls, kw, full, m = make(shape, C, 2.0)
            err, unmasked, full_err = tile_errors(calls, kernel, plain, kw, full, m)
            ms, pms = time_pair(each_tile(plain, calls, kw), each_tile(kernel, calls, kw), iters)
            record(name, shape, err, ms, pms, ATOL_WARP_LK, tile_cost(kind, calls, shape), full_err,
                   device_ms=tile_use_once(kernel, calls, kw), unmasked=unmasked)

    # the ragged and C sweep (not timed)
    for md in SWEEP_C:
        kw = dict(max_disp=md, clamp=2.0 * md)
        for shape in K3_SWEEP:
            a, b = t(rng.rand(*shape)), t(rng.rand(*shape))
            uc, vc = flow_pair(shape[:-2] + (shape[-2] // 2, shape[-1] // 2), 1.5 * md)
            out, ref = pyrup_warp_lk_cuda(a, b, uc, vc, **kw), pyrup_warp_lk_plain(a, b, uc, vc, **kw)
            torch.cuda.synchronize()
            m = k3_mask(a, b, uc, vc, md, 2.0 * md)
            sweep("pyrup_warp_lk", shape, md, *pair_errors(out, ref, m), m)
        for shape in K4_SWEEP:
            a, b = t(rng.rand(*shape)), t(rng.rand(*shape))
            u, v = flow_pair(shape, 3.0 * md)
            out, ref = warp_lk_cuda(a, b, u, v, **kw), warp_lk_plain(a, b, u, v, **kw)
            torch.cuda.synchronize()
            m = k4_mask(a, b, u, v, md, 2.0 * md)
            sweep("warp_lk", shape, md, *pair_errors(out, ref, m), m)
        for name, shape in K5_SWEEP.items():
            kind, kernel, plain, make = k5[name]
            calls, kw5, full, m = make(shape, md, (1.5 if kind == "pyrup_warp_lk" else 3.0) * md)
            err, unmasked, full_err = tile_errors(calls, kernel, plain, kw5, full, m)
            sweep(name, shape, md, err, unmasked, m, full_err)

    # P1 and its library call in turns, each round on use-once inputs
    x = t(rng.rand(*P1_TILE))
    y1, y0 = tile_copy_cuda(x), tile_copy_plain(x)
    torch.cuda.synchronize()
    ms, pms = time_pair(lambda: tile_copy_plain(x), lambda: tile_copy_cuda(x), iters)
    runs = {"p1": [], "clone": []}
    for k in range(P1_ROUNDS):
        turn = [("p1", tile_copy_cuda), ("clone", torch.clone)]
        for which, fn in turn if k % 2 == 0 else turn[::-1]:
            runs[which].append(use_once(fn, (x,)))
    record("tile_copy", P1_TILE, float((y1 - y0).abs().max()), ms, pms, 0.0,
           kernel_cost("copy", [x], [y1]), library_ms=float(np.median(runs["clone"])),
           device_ms=float(np.median(runs["p1"])))
    results["tile_copy"].update(device_ms_runs=runs["p1"], library_ms_runs=runs["clone"])
    # ragged lengths (float4 body and scalar tail) and an unaligned start
    cases = [(n, t(rng.rand(n))) for n in P1_SWEEP] + [("offset 1", t(rng.rand(1028))[1:])]
    for n, x in cases:
        err = float((tile_copy_cuda(x) - tile_copy_plain(x)).abs().max())
        results["tile_copy"].setdefault("sweep", []).append({"n": n, "max_abs_err": err})
        if err != 0.0:
            raise AssertionError(f"tile_copy at n={n}: max|err| {err:.3g}, want 0")
    log(f"  tile_copy sweep {[n for n, _ in cases]}: max|err| 0")
    log(f"  tile_copy rounds: P1 {[round(v * 1e3, 2) for v in runs['p1']]} us, "
        f"clone {[round(v * 1e3, 2) for v in runs['clone']]} us")
    torch.cuda.synchronize()
    return results


def run_stream(config, frames, device, warmup=3, mesh=None, graph=True):
    """Push every frame; return (results, steady-state ms per frame)."""
    import torch

    from optical_flow_tpu_torch.pipeline.video import VideoPipeline

    pipe = VideoPipeline(config, device=device, mesh=mesh, graph=graph)
    results, ms = [], []
    for k, frame in enumerate(frames):
        t0 = time.perf_counter()
        r = pipe.push(frame)
        torch.cuda.synchronize()
        if k >= warmup:
            ms.append((time.perf_counter() - t0) * 1e3)
        if r is not None:
            results.append(r)
    return results, ms


def phase_slice(device, frames, size):
    import dataclasses

    from optical_flow_tpu_torch import kernels
    from optical_flow_tpu_torch.config import VideoConfig

    fast = VideoConfig.fast(size=(size, size))
    plain = dataclasses.replace(
        fast, flow=dataclasses.replace(fast.flow, impl="torch", pyr_impl="poly", warp_impl="shift_sep")
    )
    kernels.reset_launch_counts()
    res_k, ms_k = run_stream(fast, frames, device)
    counts = kernels.launch_counts()
    res_p, ms_p = run_stream(plain, frames, device)
    if kernels.launch_counts() != counts:
        raise AssertionError("the plain path launched a kernel")

    F = len(frames)
    check_counts("slice", counts,
                 {"oft_pyramid": F - 1, "oft_lk": F - 2, "oft_pyrup_warp_lk": 3 * (F - 2),
                  "oft_diff_features": F - 1})
    if len(res_k) != F - 2:
        raise AssertionError(f"expected {F - 2} results, got {len(res_k)}")
    if any(tuple(r.u.shape) != (size, size) for r in res_k):
        raise AssertionError("flow has the wrong shape")
    bar = slice_bar("slice flow vs plain", res_k, res_p)
    votes = [(int(a.gesture.votes), int(b.gesture.votes)) for a, b in zip(res_k, res_p)]
    out = {
        "frames": F, "launches": counts, "flow_median": bar["flow_median"],
        "flow_q99": bar["flow_q99"], "votes": votes,
        "ms_per_frame_kernels": float(np.median(ms_k)),
        "ms_per_frame_plain": float(np.median(ms_p)),
        "ms_per_frame_kernels_mean": float(np.mean(ms_k)),
        "ms_per_frame_plain_mean": float(np.mean(ms_p)),
    }
    return out, res_k


def shifted_pair(device, size):
    """A textured size^2 pair, the second shifted by SHIFT (bilinear)."""
    import torch

    rng = np.random.RandomState(SEED + 1)
    pad = 16
    big = smooth_texture(rng, size + 2 * pad, size + 2 * pad, 3.0)
    dx, dy = SHIFT
    img1 = torch.from_numpy(bilinear_shift(big, 0.0, 0.0, pad).astype(np.float32)).to(device)
    img2 = torch.from_numpy(bilinear_shift(big, dy, dx, pad).astype(np.float32)).to(device)
    return img1, img2


def controller_config():
    from optical_flow_tpu_torch.config import FlowConfig

    return FlowConfig(mode="corrected", warp_clamp=CLAMP, warp_impl="shift_sep", level_iters=2,
                      pyr_impl="auto")


def median_epe(what, u, v):
    import torch

    inner = (slice(8, -8), slice(8, -8))
    med = float(torch.hypot(u[inner] - SHIFT[0], v[inner] - SHIFT[1]).median())
    if not (bool(torch.isfinite(u).all()) and bool(torch.isfinite(v).all()) and med < 0.2):
        raise AssertionError(f"{what} median EPE {med:.3g} px (bar 0.2)")
    return med


def phase_controller(device, size):
    import torch

    from optical_flow_tpu_torch import kernels
    from optical_flow_tpu_torch.flow.coarse_to_fine import coarse_to_fine

    img1, img2 = shifted_pair(device, size)
    kernels.reset_launch_counts()
    u, v = coarse_to_fine(img1, img2, 4, config=controller_config())
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check_counts("controller", counts,
                 {"oft_pyramid": 2, "oft_lk": 1, "oft_pyrup_warp_lk": 3, "oft_warp_lk": 4})
    return {"launches": counts, "median_epe_px": median_epe("controller", u, v)}


def phase_mesh_slice(device, frames, size, stream_results):
    """Phase 4's frames through VideoPipeline(fast, mesh=2x2 tiles on the
    card). Per frame pair: K2 once (the new diff's pyramid), K1 once
    (135^2, untileable), K3 full frame once (270^2: its 135^2 tiles are
    odd), K3 tiled at 540^2 and 1080^2 (one launch per tile); P1 once per
    tile at the mesh's first sharded call."""
    from optical_flow_tpu_torch import kernels
    from optical_flow_tpu_torch.config import VideoConfig

    mesh = grid_mesh(device)
    tiles = GRID[0] * GRID[1]
    kernels.reset_launch_counts()
    res, ms = run_stream(VideoConfig.fast(size=(size, size)), frames, device, mesh=mesh)
    counts = kernels.launch_counts()
    F = len(frames)
    check_counts("mesh slice", counts,
                 {"oft_pyramid": F - 1, "oft_lk": F - 2, "oft_pyrup_warp_lk": F - 2,
                  "oft_pyrup_warp_lk_tile": 2 * tiles * (F - 2), "oft_tile_copy": tiles,
                  "oft_diff_features": F - 1})
    same_results("the mesh slice vs phase 4's kernel path", res, stream_results)
    votes = [int(r.gesture.votes) for r in res]
    return {"frames": F, "launches": counts, "votes": votes,
            "ms_per_frame_median": float(np.median(ms)), "ms_per_frame_mean": float(np.mean(ms))}


def phase_mesh_controller(device, size):
    """sharded_coarse_to_fine on phase 5's pair, 3 levels (1080, 540, 270),
    level_iters=2, on a new 2x2 mesh: every level tiles, so K1 runs per tile
    at 270^2, K3 per tile at 540^2 and 1080^2, K4 per tile at all three."""
    import torch

    from optical_flow_tpu_torch import kernels
    from optical_flow_tpu_torch.flow.coarse_to_fine import coarse_to_fine
    from optical_flow_tpu_torch.parallel import sharded_coarse_to_fine

    img1, img2 = shifted_pair(device, size)
    cfg = controller_config()
    u0, v0 = coarse_to_fine(img1, img2, 3, config=cfg)
    mesh = grid_mesh(device)
    tiles = GRID[0] * GRID[1]
    kernels.reset_launch_counts()
    u, v = sharded_coarse_to_fine(img1, img2, mesh, 3, config=cfg)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check_counts("mesh controller", counts,
                 {"oft_pyramid": 2, "oft_lk": tiles, "oft_pyrup_warp_lk_tile": 2 * tiles,
                  "oft_warp_lk_tile": 3 * tiles, "oft_tile_copy": tiles})
    if not (torch.equal(u, u0) and torch.equal(v, v0)):
        raise AssertionError("the mesh controller differs from the unsharded controller")
    return {"launches": counts, "median_epe_px": median_epe("mesh controller", u, v)}


def phase_reference(device, frames):
    """VideoPipeline(VideoConfig()) on phase 4's frames: the faithful uint8
    head, reference mode (the flow not doubled between levels, S1 as the
    upsample), the unbounded gather warp and the warped diff kept as the
    next prevDiff. Per result frame: K1 at the four levels, S1 and W1
    three times each. Once through the kernels and once with impl='torch' (the plain
    path), which must launch nothing."""
    import dataclasses

    import torch

    from optical_flow_tpu_torch import kernels
    from optical_flow_tpu_torch.config import FlowConfig, VideoConfig
    from optical_flow_tpu_torch.pipeline.preprocess import preprocess_frame

    ref = VideoConfig()
    plain = dataclasses.replace(ref, flow=FlowConfig(impl="torch"))
    # the card's uint8 gray of one frame against the CPU port's
    g1 = preprocess_frame(torch.from_numpy(frames[0]).to(device), ref.preprocess).cpu()
    g0 = preprocess_frame(torch.from_numpy(frames[0]), ref.preprocess)
    gd = (g1.to(torch.int32) - g0.to(torch.int32)).abs()
    gray = {"max_abs_diff": int(gd.max()), "share_differing": float((gd > 0).double().mean())}
    if g1.dtype != torch.uint8 or tuple(g1.shape) != (SIZE, SIZE) or gray["max_abs_diff"] > 1:
        raise AssertionError(f"faithful gray on the card vs the CPU: {gray}, {g1.dtype}")

    kernels.reset_launch_counts()
    res_k, ms_k = run_stream(ref, frames, device)
    counts = kernels.launch_counts()
    res_p, ms_p = run_stream(plain, frames, device)
    if kernels.launch_counts() != counts:
        raise AssertionError("the plain reference path launched a kernel")
    F = len(frames)
    check_counts("reference slice", counts, {"oft_lk": 4 * (F - 2), "oft_pyrup": 3 * (F - 2),
                                             "oft_remap": 3 * (F - 2),
                                             "oft_diff_features": F - 1})
    if len(res_k) != F - 2:
        raise AssertionError(f"expected {F - 2} results, got {len(res_k)}")
    if any(tuple(r.u.shape) != (SIZE, SIZE) for r in res_k):
        raise AssertionError("reference flow has the wrong shape")
    bar = slice_bar("reference flow vs plain", res_k, res_p)
    identical = all(torch.equal(a.u, b.u) and torch.equal(a.v, b.v) for a, b in zip(res_k, res_p))
    votes = [(int(a.gesture.votes), int(b.gesture.votes)) for a, b in zip(res_k, res_p)]
    return {
        "frames": F, "launches": counts, "bit_identical": bool(identical), **bar, "votes": votes,
        "flow_max_abs_px": max(float(r.u.abs().max()) for r in res_k),
        "gray_card_vs_cpu": gray,
        "ms_per_frame_kernels": float(np.median(ms_k)), "ms_per_frame_plain": float(np.median(ms_p)),
        "ms_per_frame_kernels_mean": float(np.mean(ms_k)),
        "ms_per_frame_plain_mean": float(np.mean(ms_p)),
    }, res_k


def phase_probes(device, n=100):
    """S2-S4 on use-once inputs: `n` timed calls of each kernel variant
    (device time of back-to-back launches, utils/profiling.time_use_once),
    its plain version and, where one exists, the library call. The counts
    of the timed kernel calls are read right after them; the comparisons
    with the plain versions come after, then S2-S4's bit-for-bit sweeps
    (ragged and tiny planes, an unaligned view, odd lengths, several step
    counts, bfloat16 subnormals, ties, signed zeros and exponent gaps, S3's
    windows at their edges and special float32 values), then the rates the
    card sustains."""
    import torch
    import torch.nn.functional as F

    from optical_flow_tpu_torch import kernels
    from optical_flow_tpu_torch.kernels import probes as P
    from optical_flow_tpu_torch.utils.profiling import (
        Cost, colsum_cost, kernel_cost, stage_roofline, time_use_once,
    )

    rng = np.random.RandomState(SEED + 3)

    def on(shape, scale=1.0, offset=0.0, dtype=torch.float32):
        x = torch.from_numpy((rng.rand(*shape) * scale + offset).astype(np.float32))
        return x.to(device).to(dtype)

    def sets(make, k):
        return [make() for _ in range(k + 1)]

    h, w = P.S2_SHAPES[1]
    s2 = sets(lambda: (on((h, w)), on((h, w))), n)
    s3 = sets(lambda: (on(P.S3_SHAPE),), n)
    s4 = {dt: sets(lambda dt=dt: (on(P.S4_SHAPE, offset=0.5, dtype=dt),
                                  on(P.S4_SHAPE, scale=1e-3, dtype=dt)), n)
          for dt in (torch.float32, torch.bfloat16)}
    variants = {
        "interleave": {
            "cols_float2": (lambda a, b: P.interleave_cols_cuda(a, b, store="float2"), s2),
            "cols_smem": (lambda a, b: P.interleave_cols_cuda(a, b, store="smem"), s2),
            "rows": (P.interleave_rows_cuda, s2),
        },
        "colsum": {
            "smem": (lambda x: P.colsum_cuda(x, reads="smem"), s3),
            "shuffle": (lambda x: P.colsum_cuda(x, reads="shuffle"), s3),
        },
        "mul_add_chain": {
            "f32": (P.mul_add_chain_cuda, s4[torch.float32]),
            "bf16": (P.mul_add_chain_cuda, s4[torch.bfloat16]),
        },
    }
    kernels.reset_launch_counts()
    ms = {k: {v: time_use_once(fn, args, device) for v, (fn, args) in vs.items()}
          for k, vs in variants.items()}
    counts = kernels.launch_counts()

    # plain versions; the eager ones queue many launches a call (S3 about
    # 27, S4 128), so fewer calls, to stay inside the card's launch queue
    plain_ms = {
        "interleave": time_use_once(P.interleave_cols_plain, s2, device),
        "colsum": time_use_once(P.colsum_plain, s3[:21], device),
        "mul_add_chain": time_use_once(P.mul_add_chain_plain, s4[torch.float32][:6], device),
    }
    taps = torch.tensor([float(np.float32(0.1 * t)) for t in P.S3_TAPS], device=device)
    weight = taps.reshape(1, 1, -1)

    def conv(x):  # the window's outputs; cuDNN's order, TF32 off (main() sets it)
        return F.conv1d(x.reshape(-1, 1, x.shape[-1])[..., 1 : P.S3_WIN + 12], weight)

    library_ms = {
        "interleave": time_use_once(lambda a, b: torch.stack([a, b], dim=-1).reshape(h, 2 * w),
                                    s2, device),
        "colsum": time_use_once(conv, s3, device),
        "mul_add_chain": None,
    }
    # the other variants' plain versions and library calls, where they
    # differ from the first variant's (S2's rows: stack + reshape along rows,
    # which is also its plain version; S4 in bfloat16)
    plain_ms_by_variant = {
        "interleave": {"rows": time_use_once(P.interleave_rows_plain, s2, device)},
        "mul_add_chain": {"bf16": time_use_once(P.mul_add_chain_plain, s4[torch.bfloat16][:6],
                                                device)},
    }
    library_ms_by_variant = {
        "interleave": {"rows": time_use_once(
            lambda a, b: torch.stack([a, b], dim=-2).reshape(2 * h, w), s2, device)},
    }

    errs = {}
    a, b = s2[0]
    want_c, want_r = P.interleave_cols_plain(a, b), P.interleave_rows_plain(a, b)
    for v, got in (("cols_float2", P.interleave_cols_cuda(a, b, store="float2")),
                   ("cols_smem", P.interleave_cols_cuda(a, b, store="smem")),
                   ("rows", P.interleave_rows_cuda(a, b))):
        errs[("interleave", v)] = float((got - (want_r if v == "rows" else want_c)).abs().max())
    sq = (on(P.S2_SHAPES[0]), on(P.S2_SHAPES[0]))  # the probe's own 256^2 planes
    errs[("interleave", "256x256")] = max(
        float((P.interleave_cols_cuda(*sq, store=st) - P.interleave_cols_plain(*sq)).abs().max())
        for st in ("float2", "smem"))
    errs[("interleave", "256x256")] = max(errs[("interleave", "256x256")], float(
        (P.interleave_rows_cuda(*sq) - P.interleave_rows_plain(*sq)).abs().max()))
    (x,) = s3[0]
    for v in ("smem", "shuffle"):
        errs[("colsum", v)] = float((P.colsum_cuda(x, reads=v) - P.colsum_plain(x)).abs().max())
    conv_err = float((conv(x).reshape(x.shape[:-1] + (P.S3_WIN,))
                      - P.colsum_plain(x)[..., : P.S3_WIN]).abs().max())
    for v, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        a, b = s4[dt][0]
        errs[("mul_add_chain", v)] = float(
            (P.mul_add_chain_cuda(a, b).float() - P.mul_add_chain_plain(a, b).float()).abs().max())
    torch.cuda.synchronize()
    bad = {k: e for k, e in errs.items() if e != 0.0}
    if bad:
        raise AssertionError(f"probes differ from their plain versions: {bad}")
    sweep = probe_sweeps(device, rng)

    a, b = s2[0]
    (x,) = s3[0]
    n4 = int(np.prod(P.S4_SHAPE))
    cost = {
        "interleave": kernel_cost("interleave", [a, b], [want_c]),
        "colsum": colsum_cost(x.shape, P.S3_WIN),
        "mul_add_chain": Cost(3 * 4 * n4, 2 * P.S4_STEPS * n4),
    }
    rates = {
        "copy_bytes_per_s": {v: cost["interleave"].bytes / (t * 1e-3)
                             for v, t in ms["interleave"].items()},
        "elementwise_ops_per_s": {v: cost["mul_add_chain"].ops / (t * 1e-3)
                                  for v, t in ms["mul_add_chain"].items()},
    }
    # the bf16 chain moves half the bytes of the f32 one for the same operations
    bf16 = stage_roofline(Cost(3 * 2 * n4, 2 * P.S4_STEPS * n4), ms["mul_add_chain"]["bf16"],
                          dtype=torch.bfloat16)

    # the rates the card sustains: many waves a call, fresh inputs far
    # beyond the L2 (after the counts: these launches are no probe run's)
    gen = torch.Generator(device=device).manual_seed(SEED + 4)

    def fresh(shape, lo, hi, dtype=torch.float32):
        return torch.empty(shape, device=device).uniform_(lo, hi, generator=gen).to(dtype)

    big = [(fresh(SUSTAINED_COPY_HW, 0.0, 1.0), fresh(SUSTAINED_COPY_HW, 0.0, 1.0))
           for _ in range(SUSTAINED_SETS + 1)]
    copy_ms = time_use_once(lambda a, b: P.interleave_cols_cuda(a, b, store="float2"), big, device)
    del big
    n_s, steps_s = SUSTAINED_CHAIN
    chain_ms = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        chains = [(fresh((n_s,), 0.5, 1.5, dt), fresh((n_s,), 0.0, 1e-3, dt))
                  for _ in range(SUSTAINED_SETS + 1)]
        chain_ms[name] = time_use_once(lambda a, b: P.mul_add_chain_cuda(a, b, steps_s), chains,
                                       device)
        del chains
    sustained = {"copy_shape": list(SUSTAINED_COPY_HW), "copy_ms": copy_ms,
                 "copy_bytes_per_s": 4 * 4 * int(np.prod(SUSTAINED_COPY_HW)) / (copy_ms * 1e-3),
                 "chain": [n_s, steps_s], "chain_ms": chain_ms["f32"],
                 "f32_ops_per_s": 2 * steps_s * n_s / (chain_ms["f32"] * 1e-3),
                 "bf16_chain_ms": chain_ms["bf16"],
                 "bf16_ops_per_s": 2 * steps_s * n_s / (chain_ms["bf16"] * 1e-3)}
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "launches": counts,
            "plain_ms_by_variant": plain_ms_by_variant,
            "library_ms_by_variant": library_ms_by_variant,
            "max_abs_err": {f"{k}/{v}": e for (k, v), e in errs.items()},
            "conv1d_max_abs_diff": conv_err, "sweep": sweep,
            "rates_at_probe_shapes": rates, "sustained": sustained,
            "cost": {k: {"bytes": c.bytes, "ops": c.ops} for k, c in cost.items()},
            "bf16_chain_roofline": bf16}


def probe_sweeps(device, rng):
    """S2-S4 held bit for bit (their bit patterns compared with torch.equal)
    over ragged, tiny and unaligned inputs, both paths of each kernel, S3
    on special values (probes.s3_sweep_values: signed zeros, subnormals,
    magnitudes near FLT_MAX, +-inf); raises on any difference. Returns the
    calls of each probe by path."""
    import torch

    from optical_flow_tpu_torch.kernels import probes as P

    def same(got, want):
        ints = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
        return got.dtype == want.dtype and torch.equal(got.view(ints), want.view(ints))

    def flat(count, offset, make):
        """`count` elements on the card; `offset`: a view 4 bytes past a
        16-byte boundary (kernels/probes.py quad_path says scalar)."""
        x = make(count + 1)
        x = x[1:] if offset else x[:count].clone()
        assert (x.data_ptr() % 16 != 0) == offset
        return x

    bad, paths = [], {p: {"quad": 0, "scalar": 0} for p in ("S2", "S3", "S4")}
    s2 = {"rows": (P.interleave_rows_cuda, P.interleave_rows_plain),
          "cols_float2": (lambda a, b: P.interleave_cols_cuda(a, b, store="float2"),
                          P.interleave_cols_plain),
          "cols_smem": (lambda a, b: P.interleave_cols_cuda(a, b, store="smem"),
                        P.interleave_cols_plain)}
    for H in S2_SWEEP_H:
        for W in S2_SWEEP_W:
            for offset in (False, True):
                def plane():
                    return flat(H * W, offset, lambda k: torch.from_numpy(
                        rng.randn(k).astype(np.float32)).to(device)).view(H, W)
                a, b = plane(), plane()
                for v, (kernel, plain) in s2.items():
                    quad = P.quad_path(a, b, row_floats=W if v == "rows" else None)
                    paths["S2"]["quad" if quad else "scalar"] += 1
                    if not same(kernel(a, b), plain(a, b)):
                        bad.append(("interleave", v, H, W, offset))
    for W in S3_SWEEP_W:
        wins = sorted({w for w in S3_SWEEP_WIN + (W - 12,) if w <= W - 12})
        for lead in S3_SWEEP_LEAD:
            count = int(np.prod(lead)) * W
            for offset in (False, True):
                x = flat(count, offset, lambda k: torch.from_numpy(
                    P.s3_sweep_values(rng, (k,))).to(device)).view(*lead, W)
                quad = P.quad_path(x, row_floats=W)
                for win in wins:
                    want = P.colsum_plain(x, win)
                    for reads in ("smem", "shuffle"):
                        paths["S3"]["quad" if quad else "scalar"] += 1
                        if not same(P.colsum_cuda(x, win, reads=reads), want):
                            bad.append(("colsum", reads, lead, W, win, offset))
    for dt in (torch.float32, torch.bfloat16):
        for count in S4_SWEEP_N:
            for offset in (False, True):
                a = flat(count, offset, lambda k: (torch.from_numpy(rng.rand(k).astype(np.float32))
                                                   + 0.5).to(device, dt))
                b = flat(count, offset, lambda k: (torch.from_numpy(rng.rand(k).astype(np.float32))
                                                   * 1e-3).to(device, dt))
                for steps in S4_SWEEP_STEPS:
                    paths["S4"]["quad" if P.quad_path(a, b) else "scalar"] += 1
                    if not same(P.mul_add_chain_cuda(a, b, steps), P.mul_add_chain_plain(a, b, steps)):
                        bad.append(("mul_add_chain", str(dt), count, offset, steps))
    # bfloat16 special values, and float32 random finite bit patterns
    ab, bb = P.bf16_sweep_patterns(rng, S4_SPECIAL_N)
    u32 = rng.randint(0, 1 << 32, size=(2, S4_SPECIAL_N), dtype=np.uint64).astype(np.uint32)
    u32[(u32 >> 23 & 0xFF) == 0xFF] &= 0xBFFFFFFF  # finite: no all-ones exponent
    special = {
        "bf16": tuple(torch.from_numpy(x.view(np.int16)).view(torch.bfloat16).to(device)
                      for x in (ab, bb)),
        "f32": tuple(torch.from_numpy(x.view(np.int32)).view(torch.float32).to(device)
                     for x in u32),
    }
    special_cases = 0
    for name, (a, b) in special.items():
        for offset in (False, True):
            x, y = (a[1:], b[1:]) if offset else (a, b)
            for steps in S4_SWEEP_STEPS:
                special_cases += x.numel()
                paths["S4"]["quad" if P.quad_path(x, y) else "scalar"] += 1
                got, want = P.mul_add_chain_cuda(x, y, steps), P.mul_add_chain_plain(x, y, steps)
                if not same(got, want):
                    ints = torch.int16 if name == "bf16" else torch.int32
                    diff = (got.view(ints) != want.view(ints)).nonzero().flatten()[:4].tolist()
                    bad.append(("mul_add_chain special", name, offset, steps, "at", diff))
    torch.cuda.synchronize()
    if bad:
        raise AssertionError(f"S2-S4 differ from their plain versions: {bad[:8]} ({len(bad)} cases)")
    log(f"  S2-S4 sweeps bit for bit: {paths} calls, {special_cases} special chain elements")
    return {"paths": paths, "special_elements": special_cases}


def cycled(frames, n):
    """The first n frames of the frames repeated cyclically."""
    return [frames[k % len(frames)] for k in range(n)]


def steady_ms(results, n_warm, n_timed):
    """Host ms per frame over the results after the first `n_warm` of an
    iterator of results (each one frame), synchronized at both ends of the
    window."""
    import torch

    it = iter(results)
    for _ in range(n_warm):
        next(it)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        next(it)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n_timed


def phase_host_path(device, frames, stream_runs):
    """The per-frame host path on phase 4's frames. `stream_runs` maps
    "fast" and "reference" to (results, launch counts) of phases 4 and 9,
    whose steady pushes replayed CUDA graphs (the default).
    (a) push with graph=False: equal to them bit for bit, with the same
        launch counts;
    (b) run(prefetch=2) against run(prefetch=0), bit for bit;
    (c) run_chunked(chunk_size=5, prefetch=2) (two chunks, a two-frame
        tail) against phase 4 at the slice bar, its max |d| printed; then
        on the same pipeline run_chunked over 10 frames (its chunk step now
        replayed) and push of the last two frames, which must continue
        without a warm-up and equal the first run bit for bit;
    (d) replay_video of the frames written raw, equal to run bit for bit;
    (e) host ms per frame, steady state, one synchronize at each end of the
        window: eager push, graph push, run(prefetch=2) and, for the fast
        preset, run_chunked(chunk_size=16, prefetch=2) over CHUNKS_TIMED
        chunks after CHUNKS_WARM (the first chunk, then the capture)."""
    import pathlib

    from optical_flow_tpu_torch import kernels
    from optical_flow_tpu_torch.config import VideoConfig
    from optical_flow_tpu_torch.pipeline.video import VideoPipeline, replay_video

    configs = {"fast": VideoConfig.fast(size=(SIZE, SIZE)), "reference": VideoConfig()}
    out = {}
    for kind, cfg in configs.items():
        want, want_counts = stream_runs[kind]
        kernels.reset_launch_counts()
        eager, _ = run_stream(cfg, frames, device, graph=False)
        counts = kernels.launch_counts()
        if counts != want_counts:
            raise AssertionError(f"{kind}: eager launch counts {counts} != graph {want_counts}")
        same_results(f"{kind} eager push vs graph push", eager, want)
        del eager
        staged = list(VideoPipeline(cfg, device=device).run(frames, prefetch=2))
        same_results(f"{kind} run(prefetch=2) vs prefetch=0",
                     staged, list(VideoPipeline(cfg, device=device).run(frames, prefetch=0)))
        same_results(f"{kind} run(prefetch=2) vs push", staged, want)
        out[kind] = {"graph_equals_eager": True, "launches": {k: v for k, v in counts.items() if v},
                     "prefetch_equals_inline": True}
        if kind == "fast":
            out[kind]["chunked"] = chunked_check(device, cfg, frames, want)
            raw = pathlib.Path(__file__).resolve().parent / "chiprun_out" / "phase11_frames.raw"
            raw.parent.mkdir(exist_ok=True)
            try:
                raw.write_bytes(b"".join(np.ascontiguousarray(f).tobytes() for f in frames))
                spec = f"pipe:{FRAME_HW[1]}x{FRAME_HW[0]}:{raw}"
                same_results("replay_video vs run", replay_video(spec, cfg, device=device), staged)
            finally:
                raw.unlink(missing_ok=True)
            out[kind]["replay_video_equals_run"] = True
        del staged

    timing = {"frames_warm": HOST_WARM, "frames_timed": HOST_TIMED}
    for kind, cfg in configs.items():
        stream = cycled(frames, HOST_WARM + HOST_TIMED)
        t = {}
        for graph, mode in ((False, "eager_push"), (True, "graph_push")):
            pipe = VideoPipeline(cfg, device=device, graph=graph)
            t[mode] = steady_ms((pipe.push(f) for f in stream), HOST_WARM, HOST_TIMED)
        pipe = VideoPipeline(cfg, device=device)
        # run yields from the third frame on
        t["run_prefetch2"] = steady_ms(pipe.run(stream, prefetch=2), HOST_WARM - 2,
                                       HOST_TIMED)
        if kind == "fast":
            n = CHUNK * (CHUNKS_WARM + CHUNKS_TIMED)
            chunks = pipe.run_chunked(cycled(frames, n), chunk_size=CHUNK, prefetch=2)
            t["run_chunked"] = steady_ms(chunks, CHUNKS_WARM, CHUNKS_TIMED) / CHUNK
            t["chunks"] = {"size": CHUNK, "warm": CHUNKS_WARM, "timed": CHUNKS_TIMED}
        timing[kind] = t
    out["ms_per_frame"] = timing
    log(f"  host path ms per frame: {json.dumps(timing)}")
    return out


def chunked_check(device, cfg, frames, want):
    """Phase 11 (c); returns what it measured."""
    from optical_flow_tpu_torch import kernels
    from optical_flow_tpu_torch.pipeline.video import VideoPipeline

    F = len(frames)
    pipe = VideoPipeline(cfg, device=device)
    kernels.reset_launch_counts()
    first = list(pipe.run_chunked(frames, chunk_size=5, prefetch=2))
    counts = kernels.launch_counts()
    shapes = [tuple(r.u.shape) for r in first]
    if shapes != [(3, SIZE, SIZE), (5, SIZE, SIZE), (SIZE, SIZE), (SIZE, SIZE)]:
        raise AssertionError(f"run_chunked result shapes {shapes}")
    # a call per chunk (the first, a step) and per tail frame, each a batch
    check_counts("run_chunked", counts,
                 {"oft_pyramid": 4, "oft_lk": 4, "oft_pyrup_warp_lk": 12, "oft_diff_features": 4})
    flat = flatten_results(first)
    bar = slice_bar("run_chunked vs push", flat, want)
    if pipe.state()["frame_idx"] != F:
        raise AssertionError(f"run_chunked left frame_idx {pipe.state()['frame_idx']}")
    # again over 10 frames: chunk 2 replays the step captured above; then the
    # last two frames by push, from the carry, with no warm-up
    again = flatten_results(pipe.run_chunked(frames[:10], chunk_size=5, prefetch=2))
    tail = [pipe.push(f) for f in frames[10:]]
    if any(r is None for r in tail):
        raise AssertionError("push after run_chunked went through a warm-up")
    same_results("run_chunked replayed vs eager", again + tail, flat)
    log(f"  run_chunked(5) vs push: {json.dumps(bar)}")
    return dict(bar, launches={k: v for k, v in counts.items() if v}, replay_equals_eager=True,
                state_continues=True)


def _busy_ms(intervals):
    """Length of the union of (start, end) intervals, in ms (input µs)."""
    busy, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


def phase_profile(device, config, name, graph, warmup=PROFILE_WARMUP, n=PROFILE_FRAMES):
    """Where the time of the kernel path of `config` goes, its steady push
    eager (graph=False) or replayed as a CUDA graph (graph=True). One
    pipeline takes `warmup` frames (the graph is captured at the third),
    then `n` frames timed on the host clock (push + synchronize per frame,
    no tracer), then `n` more under torch.profiler (CUDA activity only),
    timed the same way, with CUDA events around each push. Device busy time
    is the union of the traced device events; the idle share is 1 - busy /
    wall of the traced frames; the event span is the device timeline from
    the start of a push to its end, gaps included. Writes the per-kernel
    totals to chiprun_out/`name`."""
    import pathlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from optical_flow_tpu_torch.pipeline.video import VideoPipeline

    frames = synthetic_frames(np.random.RandomState(SEED + 2), warmup + 2 * n, FRAME_HW)
    pipe = VideoPipeline(config, device=device, graph=graph)
    spans = []

    def push_timed(batch, events=False):
        ms = []
        for frame in batch:
            t0 = time.perf_counter()
            if events:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
            pipe.push(frame)
            if events:
                end.record()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if events:
                spans.append(start.elapsed_time(end))
        return ms

    push_timed(frames[:warmup])
    untraced = push_timed(frames[warmup : warmup + n])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced = push_timed(frames[warmup + n :], events=True)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise AssertionError("the trace holds no device events")
    busy = _busy_ms([(e.time_range.start, e.time_range.end) for e in events])
    wall = float(np.sum(traced))
    by_name = {}
    for e in events:
        r = by_name.setdefault(e.name, {"calls": 0, "ms": 0.0})
        r["calls"] += 1
        r["ms"] += (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1]["ms"])
    summary = {
        "graph": pipe.graph, "frames": n,
        "untraced_ms_per_frame_median": float(np.median(untraced)),
        "untraced_ms_per_frame_mean": float(np.mean(untraced)),
        "traced_ms_per_frame_median": float(np.median(traced)),
        "traced_wall_ms": wall,
        "device_busy_ms": busy,
        "device_busy_ms_per_frame": busy / n,
        "device_events_per_frame": len(events) / n,
        "idle_share": 1.0 - busy / wall,
        "event_span_ms_per_frame_median": float(np.median(spans)),
        "top": [{"name": k[:60], "calls_per_frame": v["calls"] / n, "ms_per_frame": v["ms"] / n}
                for k, v in top[:8]],
    }
    out = pathlib.Path(__file__).resolve().parent / "chiprun_out" / name
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"summary": summary, "untraced_ms": untraced, "traced_ms": traced,
                               "by_name": dict(top)}, indent=1))
    return summary


# ------------------------------------------------------- phase 12: tracking


def trajectory(grays):
    """examples/trajectory.py's loop with of.cpp's arguments: corners on
    each frame (re-seeded every frame), tracked into the next with the
    default SparseLKConfig (each frame's tracking pyramid built once), then
    a RANSAC homography (RansacConfig()) over the features tracked."""
    from optical_flow_tpu_torch.track import SparseLKConfig, good_features_to_track, track_features
    from optical_flow_tpu_torch.track.pose import RansacConfig, estimate_homography
    from optical_flow_tpu_torch.track.sparse_lk import build_tracking_pyramid

    pairs, prev = [], None
    for g in grays:
        pyr = build_tracking_pyramid(g)
        if prev is not None:
            new, status, _ = track_features(prev[0], g, pts, SparseLKConfig(), pyr1=prev[1],
                                            pyr2=pyr)
            ok = status & valid
            H, inl, n = estimate_homography(pts, new, ok, RansacConfig())
            pairs.append({k: x.cpu() for k, x in
                          dict(pts=pts, valid=valid, new=new, status=status, ok=ok, H=H,
                               inliers=n).items()})
        pts, valid = good_features_to_track(g, *CORNERS)
        prev = (g, pyr)
    return pairs


def compare_trajectories(card, cpu):
    """The card's trajectory against the CPU port's, pair by pair: valid
    corner sets (>= 99% shared), positions of the features tracked on both
    sides (median < 1e-4 px, q99 < 0.03 px), status agreement (>= 99%) and
    inlier counts (within 1%)."""
    out = {"corner_set_differences": [], "status_disagreements": 0, "features_compared": 0,
           "inliers_card": [], "inliers_cpu": []}
    shared_total = union_total = 0
    d_all = []
    for k, (a, b) in enumerate(zip(card, cpu)):
        ia = {tuple(p): i for i, p in enumerate(a["pts"].tolist()) if a["valid"][i]}
        ib = {tuple(p): i for i, p in enumerate(b["pts"].tolist()) if b["valid"][i]}
        shared = sorted(set(ia) & set(ib))
        shared_total += len(shared)
        union_total += len(set(ia) | set(ib))
        only = sorted(set(ia) ^ set(ib))
        if only:
            out["corner_set_differences"].append({"pair": k, "card_only": sorted(set(ia) - set(ib)),
                                                  "cpu_only": sorted(set(ib) - set(ia))})
        sa = np.array([bool(a["status"][ia[p]]) for p in shared])
        sb = np.array([bool(b["status"][ib[p]]) for p in shared])
        out["status_disagreements"] += int((sa != sb).sum())
        both = [p for p, x, y in zip(shared, sa, sb) if x and y]
        na = np.array([a["new"][ia[p]].tolist() for p in both]).reshape(-1, 2)
        nb = np.array([b["new"][ib[p]].tolist() for p in both]).reshape(-1, 2)
        d_all.append(np.linalg.norm(na - nb, axis=1))
        out["features_compared"] += len(shared)
        x, y = int(a["inliers"]), int(b["inliers"])
        out["inliers_card"].append(x)
        out["inliers_cpu"].append(y)
        if abs(x - y) > max(1.0, 0.01 * max(x, y)):
            raise AssertionError(f"trajectory pair {k}: inliers {x} on the card, {y} on the CPU")
    d = np.concatenate(d_all)
    out["corners_shared"] = shared_total / max(union_total, 1)
    out["status_agreement"] = 1.0 - out["status_disagreements"] / max(out["features_compared"], 1)
    out.update(track_median_px=float(np.median(d)), track_q99_px=float(np.quantile(d, 0.99)),
               track_max_px=float(d.max()), tracks_differing_1e4=int((d > 1e-4).sum()))
    if out["corners_shared"] < 0.99:
        raise AssertionError(f"corner sets share {out['corners_shared']:.4f} (bar 0.99)")
    if out["status_agreement"] < 0.99:
        raise AssertionError(f"status agreement {out['status_agreement']:.4f} (bar 0.99)")
    if not (out["track_median_px"] < 1e-4 and out["track_q99_px"] < 0.03):
        raise AssertionError(f"tracks differ: median {out['track_median_px']:.3g}, "
                             f"q99 {out['track_q99_px']:.3g} px")
    return out


def patch_motion(pairs):
    """Median displacement of the features tracked on the moving patch (a
    half-window inside its edges), pooled over the pairs; must be the
    patch's (+3, +2) px a frame to within 0.1 px."""
    H, W = FRAME_HW
    ph, pw = H // 4, W // 6
    m = 16
    d = []
    for t, p in enumerate(pairs):
        y0, x0 = H // 3 + 2 * t, W // 3 + 3 * t
        pts, ok = p["pts"].numpy(), p["ok"].numpy()
        on = ok & (pts[:, 0] > x0 + m) & (pts[:, 0] < x0 + pw - m) & (pts[:, 1] > y0 + m) & (
            pts[:, 1] < y0 + ph - m)
        d.append(p["new"].numpy()[on] - pts[on])
    d = np.concatenate(d)
    med = np.median(d, axis=0)
    if len(d) < 20 or np.abs(med - np.array(PATCH_MOTION)).max() > 0.1:
        raise AssertionError(f"patch features: {len(d)}, median motion {med} (want {PATCH_MOTION})")
    return {"patch_features": int(len(d)), "patch_median_motion_px": med.tolist()}


def call_profile(fn, n=TIMED_CALLS):
    """ms per call of `fn` on the card (CUDA events over `n` calls after two
    of warm-up, one synchronize at each end), then one call under
    torch.profiler (CUDA activity): its device events (kernels and copies),
    device busy ms and the idle share of its traced wall time, and the
    launches of the port's own kernels in it, and the four device events
    (by name) that took the most of its busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from optical_flow_tpu_torch import kernels

    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    # the tracer can miss a short call's few events: traced again (up to
    # three times), and reported as not measured (None) if it never sees one
    for _ in range(3):
        kernels.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events:
            break
    busy = _busy_ms([(e.time_range.start, e.time_range.end) for e in events]) if events else None
    by_name = {}
    for e in events:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:4])
    return {"ms_per_call": start.elapsed_time(end) / n, "host_ms_per_call": host_ms,
            "top_device_ms": top,
            "device_events_per_call": len(events) if events else None,
            "device_busy_ms": busy, "traced_wall_ms": wall,
            "idle_share": None if busy is None else 1.0 - busy / wall,
            "kernel_launches_per_call": {k: v for k, v in kernels.launch_counts().items() if v}}


def phase_tracking(device, frames, size):
    """Phase 12: the sparse-tracking path, Horn-Schunck and the exact
    'shift' warp. Returns (summary, launch counts of the trajectory run,
    launch counts of the 'shift' controller run)."""
    import torch

    from optical_flow_tpu_torch import kernels
    from optical_flow_tpu_torch.config import FlowConfig
    from optical_flow_tpu_torch.flow.coarse_to_fine import coarse_to_fine
    from optical_flow_tpu_torch.flow.horn_schunck import HornSchunckConfig, horn_schunck
    from optical_flow_tpu_torch.ops.pyramid import gaussian_pyramid
    from optical_flow_tpu_torch.ops.warp import symmetric_warp
    from optical_flow_tpu_torch.parallel import sharded_symmetric_warp
    from optical_flow_tpu_torch.pipeline.preprocess import bgr_to_gray
    from optical_flow_tpu_torch.track import SparseLKConfig, good_features_to_track, track_features
    from optical_flow_tpu_torch.track.pose import RansacConfig, estimate_homography
    from optical_flow_tpu_torch.track.sparse_lk import build_tracking_pyramid

    out = {}
    # (a) the trajectory path on phase 4's frames, on the card and on the CPU
    grays = [bgr_to_gray(torch.from_numpy(f).to(device)) for f in frames]
    kernels.reset_launch_counts()
    card = trajectory(grays)
    torch.cuda.synchronize()
    track_counts = kernels.launch_counts()
    check_counts("trajectory", track_counts, {"oft_pyramid": len(frames)})
    cpu = trajectory([bgr_to_gray(torch.from_numpy(f)) for f in frames])
    out["a"] = {"pairs": len(card), "launches": track_counts,
                "valid_corners": [int(p["valid"].sum()) for p in card],
                **compare_trajectories(card, cpu), **patch_motion(card)}
    log(f"[12 a trajectory] {json.dumps(out['a'])}")

    # (b) the known shift on phase 5's pair, in gray-level units
    img1, img2 = shifted_pair(device, size)
    g1, g2 = img1 * 255.0, img2 * 255.0
    pts, valid = good_features_to_track(g1, *CORNERS)
    res = {impl: track_features(g1, g2, pts, SparseLKConfig(impl=impl)) for impl in ("gather", "shift")}
    new, status, _ = res["gather"]
    ok = status & valid
    med = (new - pts)[ok].median(dim=0).values.tolist()
    H, _, n_inl = estimate_homography(pts, new, ok, RansacConfig())
    Hn = (H / H[2, 2]).tolist()
    both = ok & res["shift"][1]
    d = torch.linalg.norm(res["gather"][0] - res["shift"][0], dim=1)[both]
    out["b"] = {"tracked": int(ok.sum()), "median_motion_px": med,
                "homography_translation_px": [Hn[0][2], Hn[1][2]], "inliers": int(n_inl),
                "status_equal": bool(torch.equal(res["gather"][1], res["shift"][1])),
                "shift_vs_gather_median_px": float(d.median()), "shift_vs_gather_max_px": float(d.max())}
    for got in (med, out["b"]["homography_translation_px"]):
        if max(abs(got[0] - SHIFT[0]), abs(got[1] - SHIFT[1])) > 0.1:
            raise AssertionError(f"known shift: {out['b']}")
    if not (out["b"]["shift_vs_gather_median_px"] < 1e-5 and out["b"]["shift_vs_gather_max_px"] < 1e-3):
        raise AssertionError(f"sparse 'shift' vs 'gather': {out['b']}")
    log(f"[12 b known shift] {json.dumps(out['b'])}")

    # (c) Horn-Schunck, corrected pyramid (shift_sep warps on the card, K2 pyramids)
    hs_cfg = HornSchunckConfig(alpha=0.5, iters=100, levels=4)
    kernels.reset_launch_counts()
    u, v = horn_schunck(img1, img2, hs_cfg)
    torch.cuda.synchronize()
    hs_counts = kernels.launch_counts()
    check_counts("horn_schunck", hs_counts, {"oft_pyramid": 2})
    inner = (slice(8, -8), slice(8, -8))
    med = [float(u[inner].median()), float(v[inner].median())]
    if not (bool(torch.isfinite(u).all()) and abs(med[0] - SHIFT[0]) < 0.2
            and abs(med[1] - SHIFT[1]) < 0.2):
        raise AssertionError(f"horn_schunck median flow {med} (shift {SHIFT})")
    for img in (img1, img2):
        for a, b in zip(gaussian_pyramid(img, 4, impl="auto"), gaussian_pyramid(img, 4, impl="poly")):
            if not torch.equal(a, b):
                raise AssertionError("the K2 pyramid differs from 'poly'")
    out["c"] = {"median_flow_px": med, "launches": hs_counts,
                "median_epe_px": float(torch.hypot(u[inner] - SHIFT[0], v[inner] - SHIFT[1]).median()),
                "k2_pyramids_equal_poly": True}
    log(f"[12 c horn_schunck] {json.dumps(out['c'])}")

    # (d) the exact 'shift' warp: against 'gather', through the controller, on the mesh
    rng = np.random.RandomState(SEED + 5)
    fu, fv = (torch.from_numpy(np.clip(f, -CLAMP, CLAMP)).to(device)
              for f in smooth_flow(rng, (size, size), 3.0))
    ws = symmetric_warp(img1, img2, fu, fv, impl="shift", max_disp=SHIFT_MAX_DISP)
    wg = symmetric_warp(img1, img2, fu, fv, impl="gather")
    warp_err = max(float((a - b).abs().max()) for a, b in zip(ws, wg))
    if warp_err > 1e-5:
        raise AssertionError(f"'shift' vs 'gather' warp: max |d| {warp_err:.3g} (bar 1e-5)")
    wm = sharded_symmetric_warp(img1, img2, fu, fv, grid_mesh(device), CLAMP, impl="shift")
    if not all(torch.equal(a, b) for a, b in zip(wm, ws)):
        raise AssertionError("the 'shift' tile warp differs from the unsharded warp")
    cfg = FlowConfig(mode="corrected", warp_clamp=CLAMP, warp_impl="shift", level_iters=2,
                     pyr_impl="auto")
    kernels.reset_launch_counts()
    cu, cv = coarse_to_fine(img1, img2, config=cfg)
    torch.cuda.synchronize()
    shift_counts = kernels.launch_counts()
    check_counts("shift controller", shift_counts, {"oft_pyramid": 2, "oft_lk": 8})
    out["d"] = {"warp_max_abs_vs_gather": warp_err, "mesh_equal": True, "launches": shift_counts,
                "median_epe_px": median_epe("shift controller", cu, cv)}
    log(f"[12 d shift] {json.dumps(out['d'])}")

    # (e) times on the card, after the checks
    prev_pyr, pyr = build_tracking_pyramid(grays[0]), build_tracking_pyramid(grays[1])
    tp, tv = good_features_to_track(grays[0], *CORNERS)
    tn, ts, _ = track_features(grays[0], grays[1], tp, pyr1=prev_pyr, pyr2=pyr)
    calls = {
        "good_features_to_track_720p": lambda: good_features_to_track(grays[0], *CORNERS),
        "good_features_to_track_1080": lambda: good_features_to_track(g1, *CORNERS),
        "build_tracking_pyramid_720p": lambda: build_tracking_pyramid(grays[0]),
        "track_features_720p": lambda: track_features(grays[0], grays[1], tp, pyr1=prev_pyr,
                                                      pyr2=pyr),
        "track_features_shift_720p": lambda: track_features(
            grays[0], grays[1], tp, SparseLKConfig(impl="shift"), pyr1=prev_pyr, pyr2=pyr),
        "estimate_homography": lambda: estimate_homography(tp, tn, ts & tv),
        "horn_schunck_1080": lambda: horn_schunck(img1, img2, hs_cfg),
        "shift_warp_1080": lambda: symmetric_warp(img1, img2, fu, fv, impl="shift",
                                                  max_disp=SHIFT_MAX_DISP),
        "topk_1080": lambda: torch.topk(g1.reshape(-1), CORNERS[0]),
        "max_pool_21x21_1080": lambda: torch.nn.functional.max_pool2d(
            g1[None, None], 21, stride=1, padding=10),
    }
    out["e"] = {}
    for name, fn in calls.items():
        out["e"][name] = call_profile(fn, n=2 if name.startswith("horn") else TIMED_CALLS)
        log(f"[12 e time] {name}: {json.dumps(out['e'][name])}")
    return out, track_counts, shift_counts


# ---------------------------------------------- phase 13: structure from motion


def render_sfm_frames(n, hw=SFM_HW, focal=SFM_FOCAL, step=SFM_STEP, seed=SEED):
    """n gray uint8 frames of a camera sliding along +x by `step` a frame
    over a textured scene with a random depth field clipped to [3, 12]
    (examples/sfm_demo.py's scene without cv2: cubic zoom for the texture
    and the depth, bilinear REFLECT_101 resampling for the parallax).
    Returns (frames, depth)."""
    from scipy import ndimage

    rng = np.random.RandomState(seed)
    h, w = hw
    small = rng.rand(h // 4, w // 4)
    base = ndimage.zoom(small, (h / small.shape[0], w / small.shape[1]), order=3)
    base = (255 * (base - base.min()) / np.ptp(base)).astype(np.uint8)
    d = rng.rand(10, 13)
    depth = np.clip(4.0 + 6.0 * ndimage.zoom(d, (h / 10, w / 13), order=3), 3.0, 12.0)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    frames = [base]
    for k in range(1, n):
        img = ndimage.map_coordinates(base.astype(np.float64), [ys, xs + focal * step * k / depth],
                                      order=1, mode="mirror")
        frames.append(np.clip(np.rint(img), 0, 255).astype(np.uint8))
    return frames, depth


def camera_centres(cams):
    """(N, 3) centres -R^T t of (N, 6) axis-angle + translation cameras."""
    import torch

    from optical_flow_tpu_torch.slam.ba import _rodrigues

    c = torch.from_numpy(np.asarray(cams, np.float64))
    return np.stack([-(_rodrigues(x[:3]).T @ x[3:]).numpy() for x in c])


def shared_share(a, b):
    """|A & B| / |A | B| of two sets of pixel positions (rows)."""
    sa, sb = {tuple(p) for p in np.asarray(a).tolist()}, {tuple(p) for p in np.asarray(b).tolist()}
    return len(sa & sb) / max(len(sa | sb), 1)


def ba_scene(outliers=0.0, seed=11, C=50, P=10_000):
    """tests/test_slam.py:116-150 on the CPU in float64: 50 cameras along x,
    10,000 points, each seen by 6 consecutive cameras (60,000 observations);
    `outliers` of the observations moved by 30-60 px (tests/test_slam.py:
    256-293). Returns (problem, true cameras)."""
    import torch

    from optical_flow_tpu_torch.slam.ba import BAProblem, project

    rng = np.random.RandomState(seed)
    pts = rng.randn(P, 3) * np.array([4.0, 4.0, 1.0]) + np.array([0, 0, 10.0])
    cams = np.zeros((C, 6))
    cams[:, 3] = np.linspace(-3, 3, C)
    cams[:, :3] = rng.randn(C, 3) * 0.01
    first = rng.randint(0, C - 5, size=P)
    ci = (first[:, None] + np.arange(6)[None, :]).reshape(-1).astype(np.int32)
    pi = np.repeat(np.arange(P), 6).astype(np.int32)
    obs = torch.func.vmap(project, in_dims=(0, 0, None))(
        torch.from_numpy(cams)[ci], torch.from_numpy(pts)[pi],
        torch.tensor(BA_FOCAL, dtype=torch.float64))
    prob = BAProblem(torch.from_numpy(cams + rng.randn(C, 6) * 0.002),
                     torch.from_numpy(pts + rng.randn(P, 3) * 0.02),
                     torch.from_numpy(ci), torch.from_numpy(pi), obs, BA_FOCAL)
    if outliers:
        bad = torch.from_numpy(rng.rand(len(ci)) < outliers)
        n = int(bad.sum())
        jump = rng.uniform(30, 60, (n, 2)) * np.sign(rng.randn(n, 2))
        prob = prob._replace(obs=obs.index_put((bad,), obs[bad] + torch.from_numpy(jump)))
    return prob, cams


def windowed_trajectory(device, stereo=False):
    """tests/test_slam.py:153-219: 14 keyframes 0.4 apart along x, 12 new
    points a keyframe each seen by the next 4, noisy initial poses;
    WindowedBA(window=4) solved after every keyframe; with `stereo` each
    observation also made by a right eye 0.3 along +x. Returns (wba, live
    observation counts, rmses, true poses)."""
    from optical_flow_tpu_torch.slam.window import WindowedBA

    def proj(pose, X, b=0.0):
        r = pose[:3]
        th = np.linalg.norm(r)
        K = np.array([[0.0, -r[2], r[1]], [r[2], 0.0, -r[0]], [-r[1], r[0], 0.0]]) / max(th, 1e-12)
        R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K) if th > 1e-6 else np.eye(3)
        xc = R @ X + pose[3:]
        return BA_FOCAL * np.array([xc[0] - b, xc[1]]) / xc[2]

    rng = np.random.RandomState(5)
    n_kf = 14
    true_poses = np.zeros((n_kf, 6))
    true_poses[:, 3] = np.arange(n_kf) * 0.4
    pts_true, visible, pid = {}, {}, 0
    for k in range(n_kf):
        for _ in range(12):
            pts_true[pid] = np.array([true_poses[k, 3] + rng.uniform(-2, 2), rng.uniform(-2, 2),
                                      rng.uniform(6, 10)])
            for kk in range(k, min(k + 4, n_kf)):
                visible.setdefault(kk, []).append(pid)
            pid += 1
    wba = WindowedBA(window=4, focal=BA_FOCAL, ba_iters=4, lam=1e-6, device=device)
    sizes, rmses = [], []
    for k in range(n_kf):
        pose_init = true_poses[k] + rng.randn(6) * np.array([0.002] * 3 + [0.02] * 3)
        if k == 0:
            pose_init = true_poses[0]
        obs, new_pts = [], {}
        for p in visible[k]:
            uv = proj(true_poses[k], pts_true[p])
            if abs(uv[0]) > 800 or abs(uv[1]) > 800:
                continue
            obs.append((p, uv))
            if stereo:
                obs.append((p, proj(true_poses[k], pts_true[p], 0.3), 0.3))
            if p not in wba.points and p not in wba.retired:
                new_pts[p] = pts_true[p] + rng.randn(3) * 0.02
        wba.add_keyframe(pose_init, obs, new_pts)
        rmses.append(wba.optimize())
        sizes.append(wba.live_observation_count)
    return wba, sizes, rmses, true_poses


def rel_diff(a, b):
    """max |a - b| / max |b| of two tensors or arrays (any devices)."""
    a, b = (np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.float64) for x in (a, b))
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def phase_sfm(device):
    """Phase 13: structure from motion. Returns (summary, launch counts of
    (a)'s card run)."""
    import torch

    from optical_flow_tpu_torch import kernels
    from optical_flow_tpu_torch.slam import (
        BAProblem,
        bundle_adjust,
        estimate_essential,
        normalize_pixels,
        pnp_ransac,
        ransac_essential_5pt,
        recover_pose,
        refine_pose,
        reprojection_rmse,
        two_view_reconstruct,
    )
    from optical_flow_tpu_torch.slam.frontend import multi_view_reconstruct

    out = {}
    frames, depth = render_sfm_frames(SFM_FRAMES)
    card_frames = [torch.from_numpy(f).to(device) for f in frames]

    # (a) multi_view_reconstruct, on the card and on the CPU
    kernels.reset_launch_counts()
    card = multi_view_reconstruct(card_frames, SFM_FOCAL)
    torch.cuda.synchronize()
    sfm_counts = kernels.launch_counts()
    check_counts("multi_view_reconstruct", sfm_counts, {"oft_pyramid": 2 * (SFM_FRAMES - 1)})
    cpu = multi_view_reconstruct(frames, SFM_FOCAL, device="cpu")
    if card is None or cpu is None:
        raise AssertionError(f"multi_view_reconstruct gave no model (card {card}, cpu {cpu})")
    res = {"launches": sfm_counts}
    for name, rec in (("card", card), ("cpu", cpu)):
        txs = rec.cams[:, 3] * np.sign(rec.cams[-1, 3])
        steps = np.diff(txs)
        res[name] = {"points": int(rec.points.shape[0]), "rmse_before": rec.rmse_before,
                     "rmse_after": rec.rmse_after, "x_translations": txs.tolist(),
                     "step_ratio": float(steps.max() / max(steps.min(), 1e-12))}
        if not (rec.rmse_after <= rec.rmse_before and rec.rmse_after < 3.0 and np.all(steps > 0)
                and res[name]["step_ratio"] < 1.8):
            raise AssertionError(f"multi_view_reconstruct ({name}): {res[name]}")
    centres = [camera_centres(r.cams) for r in (card, cpu)]
    baseline = float(np.linalg.norm(centres[1][-1]))
    res["tracks_shared"] = shared_share(card.tracks[0], cpu.tracks[0])
    res["centre_max_diff_over_baseline"] = float(np.abs(centres[0] - centres[1]).max() / baseline)
    if res["tracks_shared"] < 0.99 or res["centre_max_diff_over_baseline"] > 1e-3:
        raise AssertionError(f"multi_view_reconstruct card vs CPU: {res}")
    out["a"] = res
    log(f"[13 a multi_view_reconstruct] {json.dumps(res)}")

    # (b) two_view_reconstruct on frames 0 and 3: the camera moves +x, so
    # t = X_2 - R X_1 points along -x
    two = {"card": two_view_reconstruct(card_frames[0], card_frames[3], SFM_FOCAL),
           "cpu": two_view_reconstruct(frames[0], frames[3], SFM_FOCAL, device="cpu")}
    res = {}
    h, w = SFM_HW
    for name, rec in two.items():
        if rec is None:
            raise AssertionError(f"two_view_reconstruct ({name}) gave no model")
        gx = np.clip(rec.pts1[:, 0].astype(int), 0, w - 1)
        gy = np.clip(rec.pts1[:, 1].astype(int), 0, h - 1)
        res[name] = {"points": int(rec.points.shape[0]), "t": rec.t.tolist(),
                     "in_front": float((rec.points[:, 2] > 0).mean()),
                     "depth_rho": float(np.corrcoef(depth[gy, gx], rec.points[:, 2])[0, 1]),
                     "rmse_before": rec.rmse_before, "rmse_after": rec.rmse_after}
        if not (abs(rec.t[0]) > 0.9 and res[name]["in_front"] >= 0.9 and res[name]["depth_rho"] > 0.7
                and rec.rmse_after <= rec.rmse_before):
            raise AssertionError(f"two_view_reconstruct ({name}): {res[name]}")
    res["tracks_shared"] = shared_share(two["card"].pts1, two["cpu"].pts1)
    cc = [-(r.R.astype(np.float64).T @ r.t.astype(np.float64)) for r in two.values()]
    res["centre_max_diff_over_baseline"] = float(np.abs(cc[0] - cc[1]).max())  # |t| = 1
    if res["tracks_shared"] < 0.99 or res["centre_max_diff_over_baseline"] > 1e-3:
        raise AssertionError(f"two_view_reconstruct card vs CPU: {res}")
    out["b"] = res
    log(f"[13 b two_view_reconstruct] {json.dumps(res)}")

    # (c) bundle_adjust at scale, float64, on the card (twice) and the CPU
    prob, _ = ba_scene()
    runs = [bundle_adjust(prob, iters=5, lam=1e-4, device=device)[0] for _ in range(2)]
    ref, _ = bundle_adjust(prob, iters=5, lam=1e-4)
    rmse0, rmse1 = float(reprojection_rmse(prob)), float(reprojection_rmse(runs[0]))
    res = {"observations": int(prob.obs.shape[0]), "rmse_before": rmse0, "rmse_after": rmse1,
           "rmse_after_cpu": float(reprojection_rmse(ref)),
           "cams_rel_diff_vs_cpu": rel_diff(runs[0].cams, ref.cams),
           "points_rel_diff_vs_cpu": rel_diff(runs[0].points, ref.points),
           "card_runs_bit_equal": bool(torch.equal(runs[0].cams, runs[1].cams)
                                       and torch.equal(runs[0].points, runs[1].points)),
           "card_runs_rel_diff": max(rel_diff(runs[0].cams, runs[1].cams),
                                     rel_diff(runs[0].points, runs[1].points))}
    if not (rmse1 < 0.1 * rmse0 and res["cams_rel_diff_vs_cpu"] <= 1e-8
            and res["points_rel_diff_vs_cpu"] <= 1e-8):
        raise AssertionError(f"bundle_adjust at scale: {res}")
    bad, true_cams = ba_scene(outliers=0.05)
    err = {}
    for name, kw in (("plain", {}), ("robust", dict(robust_delta=2.0))):
        sol, _ = bundle_adjust(bad, iters=5, lam=1e-4, device=device, **kw)
        err[name] = float(np.abs(sol.cams[:, 3:].cpu().numpy() - true_cams[:, 3:]).max())
    res["outliers_cam_err"] = err
    if not (err["robust"] < 0.1 * err["plain"] and err["robust"] < 0.15):
        raise AssertionError(f"robust bundle_adjust with 5% outliers: {err}")
    out["c"] = res
    log(f"[13 c bundle_adjust] {json.dumps(res)}")

    # (d) WindowedBA on the card: the trajectory's bars (tests/test_slam.py),
    # with one eye (the scale a gauge of the first window, held by the
    # damping alone) and with a right eye 0.3 along +x (the scale observed)
    res = {}
    for name, stereo in (("monocular", False), ("stereo", True)):
        wba, sizes, rmses, true_poses = windowed_trajectory(device, stereo)
        x = np.array([wba.poses[k][3] for k in range(len(true_poses))])
        xt = true_poses[:, 3]
        res[name] = {"retired": len(wba.retired), "live_observations": sizes,
                     "max_x_err": float(np.abs(x - xt).max()), "scale": float(x @ xt / (x @ x)),
                     "rmse_last": rmses[-1]}
        if not (len(wba.retired) > 50 and max(sizes) <= 12 * 4 * 7 * (1 + stereo)
                and sizes[-1] <= max(sizes[:-1]) and all(np.isfinite(rmses))
                and res[name]["max_x_err"] < 0.02 * xt[-1]):
            raise AssertionError(f"WindowedBA ({name}): {res[name]}")
    out["d"] = res
    log(f"[13 d WindowedBA] {json.dumps(res)}")

    # (e) times on the card, after the checks: (a)'s kept tracks between
    # frames 0 and N-1, its points against frame 3
    n0 = normalize_pixels(torch.from_numpy(card.tracks[0]).to(device), SFM_FOCAL, w / 2.0, h / 2.0)
    nN = normalize_pixels(torch.from_numpy(card.tracks[-1]).to(device), SFM_FOCAL, w / 2.0, h / 2.0)
    n3 = normalize_pixels(torch.from_numpy(card.tracks[3]).to(device), SFM_FOCAL, w / 2.0, h / 2.0)
    E, inl, _ = estimate_essential(n0, nN)
    R, t, _ = recover_pose(E, n0, nN, inl)
    X = torch.from_numpy(card.points).to(device=device, dtype=torch.float32)
    prob_card = BAProblem(*(x.to(device) if isinstance(x, torch.Tensor) else x for x in prob))
    design = torch.randn((512, n0.shape[0], 9), generator=torch.Generator().manual_seed(SEED)).to(device)
    calls = {
        "estimate_essential": lambda: estimate_essential(n0, nN),
        "ransac_essential_5pt": lambda: ransac_essential_5pt(n0, nN),
        "recover_pose": lambda: recover_pose(E, n0, nN, inl),
        "refine_pose": lambda: refine_pose(R, t, n0, nN, inl),
        "pnp_ransac": lambda: pnp_ransac(X, n3),
        "bundle_adjust_60k": lambda: bundle_adjust(prob_card, iters=5, lam=1e-4),
        "windowed_ba_optimize": wba.optimize,
        "two_view_reconstruct_720p": lambda: two_view_reconstruct(card_frames[0], card_frames[3],
                                                                  SFM_FOCAL),
        "multi_view_reconstruct_720p_8": lambda: multi_view_reconstruct(card_frames, SFM_FOCAL),
        # the 8-point null vector two ways, at estimate_essential's batch:
        # the SVD of the tall float32 design matrices (JAX's way) and eigh of
        # the float64 normal matrices (the port's)
        "svd_512x294x9_f32": lambda: torch.linalg.svd(design, full_matrices=False),
        "eigh_normal_512x9x9_f64": lambda: torch.linalg.eigh(design.double().mT @ design.double()),
    }
    out["e"] = {"points": int(n0.shape[0])}
    for name, fn in calls.items():
        out["e"][name] = call_profile(fn)
        log(f"[13 e time] {name}: {json.dumps(out['e'][name])}")
    return out, sfm_counts


# ------------------------------------------------------------ phase 14: the mapper


def depth_field(rng, hw):
    """The tests' depth field: 10x13 noise zoomed (cubic) to `hw`, in [3, 12]."""
    from scipy import ndimage

    h, w = hw
    return np.clip(4.0 + 6.0 * ndimage.zoom(rng.rand(10, 13).astype(np.float32),
                                            (h / 10, w / 13), order=3), 3.0, 12.0)


def loop_scene(hw, seed):
    """tests/test_incremental_slam.py's and tests/test_stereo_slam.py's
    scene at `hw`: a smooth uint8 texture (80x104 noise zoomed, cubic) and
    the depth field."""
    from scipy import ndimage

    rng = np.random.RandomState(seed)
    h, w = hw
    base = ndimage.zoom(rng.rand(80, 104).astype(np.float32), (h / 80, w / 104), order=3)
    return (255 * (base - base.min()) / np.ptp(base)).astype(np.uint8), depth_field(rng, hw)


def render_slam_loop(n=SLAM_FRAMES, hw=SLAM_HW, focal=SLAM_FOCAL, scale=SLAM_SCALE, seed=11):
    """tests/test_incremental_slam.py::_render_loop at `hw` without cv2: a
    camera on a loop of radii (0.12, 0.08) x `scale` over a textured plane
    with a depth field of [3, 12] (cubic zooms, bilinear REFLECT_101
    parallax). Returns (uint8 gray frames, true centres)."""
    from scipy import ndimage

    base, depth = loop_scene(hw, seed)
    base = base.astype(np.float32)
    h, w = hw
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    inv = focal / depth
    frames, centres = [], []
    for k in range(n):
        th = 2 * np.pi * k / n
        cx_w, cy_w = 0.12 * scale * np.sin(th), 0.08 * scale * (1 - np.cos(th))
        img = ndimage.map_coordinates(base, [ys + cy_w * inv, xs + cx_w * inv], order=1,
                                      mode="mirror")
        frames.append(np.clip(np.rint(img), 0, 255).astype(np.uint8))
        centres.append((cx_w, cy_w, 0.0))
    return frames, np.asarray(centres)


def render_view(base, depth, focal, cx_w, cy_w):
    """tests/test_stereo_slam.py::_view without cv2: the exact render of the
    textured surface from camera centre (cx_w, cy_w, 0), R = I, the inverse
    map solved by fixed-point iteration. Returns (image, source u, v)."""
    from scipy import ndimage

    h, w = base.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    u, v = xs.copy(), ys.copy()
    for _ in range(8):
        d = ndimage.map_coordinates(depth, [v, u], order=1, mode="nearest")
        u = (xs + focal * float(cx_w) / d).astype(np.float32)
        v = (ys + focal * float(cy_w) / d).astype(np.float32)
    img = ndimage.map_coordinates(base.astype(np.float32), [v, u], order=1, mode="mirror")
    return np.clip(np.rint(img), 0, 255).astype(np.uint8), u, v


def render_stereo_loop(n=SLAM_FRAMES, hw=SLAM_HW, focal=SLAM_FOCAL, scale=SLAM_SCALE, seed=11):
    """tests/test_stereo_slam.py::_render_stereo_loop at `hw`: rectified
    (left, right) pairs of a rig of baseline 0.3 x `scale` on (a)'s loop.
    Returns (pairs, true centres of the left camera)."""
    base, depth = loop_scene(hw, seed)
    pairs, centres = [], []
    for k in range(n):
        th = 2 * np.pi * k / n
        cx_w, cy_w = 0.12 * scale * np.sin(th), 0.08 * scale * (1 - np.cos(th))
        pairs.append((render_view(base, depth, focal, cx_w, cy_w)[0],
                      render_view(base, depth, focal, cx_w + 0.3 * scale, cy_w)[0]))
        centres.append((cx_w, cy_w, 0.0))
    return pairs, np.asarray(centres)


def render_textured_rig(hw=SLAM_HW, focal=SLAM_FOCAL, baseline=SLAM_BASELINE, seed=4):
    """tests/test_stereo_slam.py::_textured_rig at `hw` without cv2:
    per-pixel noise under a light blur (sigma 1.2, 5 taps), the rig's
    disparities those of the test (12-40 px). Returns (left, right, true
    disparity)."""
    from scipy import ndimage

    rng = np.random.RandomState(seed)
    h, w = hw
    base = ndimage.gaussian_filter((rng.rand(h, w) * 255).astype(np.float32), 1.2,
                                   truncate=2 / 1.2, mode="mirror")
    base = (255 * (base - base.min()) / np.ptp(base)).astype(np.uint8)
    depth = depth_field(rng, hw)
    left, ul, vl = render_view(base, depth, focal, 0.0, 0.0)
    right = render_view(base, depth, focal, baseline, 0.0)[0]
    d_src = ndimage.map_coordinates(depth.astype(np.float32), [vl, ul], order=1, mode="nearest")
    return left, right, focal * baseline / d_src


def centre_errors(res, centres, scale_fit=True):
    """|estimated - true| camera centres of the keyframes, after one global
    scale (fitted on keyframe 1, as tests/test_incremental_slam.py does)
    unless the run is metric."""
    est = res.centers()
    true = np.asarray([centres[i] for i in res.keyframes])
    s = np.linalg.norm(true[1]) / max(np.linalg.norm(est[1]), 1e-9) if scale_fit else 1.0
    return np.linalg.norm(est * s - true, axis=1), s


def compare_slam(what, card, cpu, centres, scale_fit):
    """Card against CPU: the same keyframes and loop edges, camera centres
    within 1e-3 of the loop radius (in the truth's units)."""
    if card is None or cpu is None:
        raise AssertionError(f"{what}: no map (card {card}, cpu {cpu})")
    _, s = centre_errors(cpu, centres, scale_fit)
    diff = float(np.abs(card.centers() - cpu.centers()).max() * s / SLAM_RADIUS)
    same = {"keyframes_equal": card.keyframes == cpu.keyframes,
            "loop_edges_equal": [e[:2] for e in card.loop_edges] == [e[:2] for e in cpu.loop_edges],
            "centre_max_diff_over_radius": diff}
    if not (same["keyframes_equal"] and same["loop_edges_equal"] and diff < 1e-3):
        raise AssertionError(f"{what} card vs CPU: {same}, keyframes {card.keyframes} / "
                             f"{cpu.keyframes}, loop edges {card.loop_edges} / {cpu.loop_edges}")
    return same


def slam_summary(res, centres, scale_fit):
    err, _ = centre_errors(res, centres, scale_fit)
    return {"keyframes": res.keyframes, "loop_edges": [list(e) for e in res.loop_edges],
            "points": int(res.points.shape[0]), "rmse": res.rmse,
            "centre_err_over_radius_mean": float(err.mean() / SLAM_RADIUS),
            "centre_err_over_radius_max": float(err.max() / SLAM_RADIUS)}


def dense_level_counts(shape, levels, pyr_impl):
    """The launches dense_disparity makes on the card: both pyramids (K2,
    one call each, where the config's pyr_impl is 'auto'; its default
    'poly' is the plain pyramid), K1 at the coarsest level, then per finer
    level K3 where the coarse flow is exactly half the level, else K4."""
    shapes = [tuple(shape)]
    for _ in range(levels - 1):
        shapes.append(tuple((n + 1) // 2 for n in shapes[-1]))
    k3 = [f for f, c in zip(shapes[:-1], shapes[1:]) if (2 * c[0], 2 * c[1]) == f]
    return {"oft_pyramid": 2 if pyr_impl == "auto" else 0, "oft_lk": 1,
            "oft_pyrup_warp_lk": len(k3), "oft_warp_lk": levels - 1 - len(k3)}, k3


def phase_slam(device):
    """Phase 14: the mapper. Returns (summary, launch counts of (a)'s card
    run, launch counts of (c)'s dense_disparity, K3's rows at C = 12)."""
    import pathlib

    import torch

    from optical_flow_tpu_torch import kernels
    from optical_flow_tpu_torch.config import FlowConfig
    from optical_flow_tpu_torch.kernels.warp_lk_kernel import pyrup_warp_lk_cuda, pyrup_warp_lk_plain
    from optical_flow_tpu_torch.ops.pyramid import max_pyramid_levels, pyr_up_cols_first
    from optical_flow_tpu_torch.ops.warp import symmetric_warp
    from optical_flow_tpu_torch.slam import dense_disparity, incremental_slam
    from optical_flow_tpu_torch.utils.interop import load_tum_trajectory
    from optical_flow_tpu_torch.utils.profiling import Cost, kernel_cost, stage_roofline, time_use_once

    out = {}
    h, w = SLAM_HW

    # (a) the monocular loop, every frame a keyframe candidate, card and CPU
    frames, centres = render_slam_loop()
    card_frames = [torch.from_numpy(f).to(device) for f in frames]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    card = incremental_slam(card_frames, SLAM_FOCAL, **SLAM_KW)
    torch.cuda.synchronize()
    card_sec = time.perf_counter() - t0
    slam_counts = kernels.launch_counts()
    t0 = time.perf_counter()
    cpu = incremental_slam(frames, SLAM_FOCAL, device="cpu", **SLAM_KW)
    cpu_sec = time.perf_counter() - t0
    res = {"launches": slam_counts, "first_call_s": {"card": card_sec, "cpu": cpu_sec},
           **compare_slam("incremental_slam", card, cpu, centres, True),
           "card": slam_summary(card, centres, True), "cpu": slam_summary(cpu, centres, True)}
    want = mapper_k2(SLAM_FRAMES, len(card.keyframes), len(card.loop_edges),
                     SLAM_KW["loop_min_separation"])
    check_counts("incremental_slam", slam_counts, {"oft_pyramid": want})
    c = res["card"]
    if not (c["centre_err_over_radius_mean"] < 0.05 / 0.12 and c["centre_err_over_radius_max"]
            < 0.10 / 0.12 and card.keyframes[-1] == SLAM_FRAMES - 1 and card.rmse < 5.0
            and any(j - i >= 6 for i, j, _ in card.loop_edges)):
        raise AssertionError(f"incremental_slam against the truth: {res}")
    out["a"] = res
    log(f"[14 a incremental_slam] {json.dumps(res)}")

    # (b) the stereo rig on the same loop: a metric map, no scale fit
    pairs_np, s_centres = render_stereo_loop()
    pairs_card = [tuple(torch.from_numpy(x).to(device) for x in p) for p in pairs_np]
    skw = dict(stereo_baseline=SLAM_BASELINE, loop_min_separation=20, min_tracks=40, window=8)
    st_card = incremental_slam(pairs_card, SLAM_FOCAL, **skw)
    st_cpu = incremental_slam(pairs_np, SLAM_FOCAL, device="cpu", **skw)
    res = {**compare_slam("stereo incremental_slam", st_card, st_cpu, s_centres, False),
           "card": slam_summary(st_card, s_centres, False),
           "cpu": slam_summary(st_cpu, s_centres, False),
           "median_depth": float(np.median(st_card.points[:, 2]))}
    c = res["card"]
    # tests/test_stereo_slam.py:132-155 in the loop radius' units
    if not (c["centre_err_over_radius_mean"] < 0.05 / 0.12 and c["centre_err_over_radius_max"]
            < 0.10 / 0.12 and st_card.keyframes == list(range(SLAM_FRAMES))
            and 3.0 < res["median_depth"] < 12.0 and st_card.rmse < 5.0):
        raise AssertionError(f"stereo incremental_slam against the truth: {res}")
    out["b"] = res
    log(f"[14 b stereo incremental_slam] {json.dumps(res)}")

    # (c) dense disparity on one rig pair: K1 and K3 at C = 12
    left, right, true_disp = render_textured_rig()
    lt, rt = (torch.from_numpy(x).to(device) for x in (left, right))
    levels = max_pyramid_levels(SLAM_HW)
    want, k3_shapes = dense_level_counts(SLAM_HW, levels, FlowConfig().pyr_impl)
    kernels.reset_launch_counts()
    disp, valid = dense_disparity(lt, rt)
    torch.cuda.synchronize()
    stereo_counts = kernels.launch_counts()
    check_counts("dense_disparity", stereo_counts, want)
    plain, plain_valid = dense_disparity(lt, rt, config=FlowConfig(mode="corrected", warp_clamp=24.0,
                                                                   impl="torch"))
    d = (disp - plain).abs().flatten()
    m = np.zeros(SLAM_HW, bool)
    m[20:-20, 20:-60] = True  # outside the warp's boundary band, as the test
    v = valid.cpu().numpy()
    err = np.abs(disp.cpu().numpy() - true_disp)[v & m]
    res = {"launches": stereo_counts, "levels": levels,
           "vs_plain_median_px": float(d.median()), "vs_plain_q99_px": float(torch.quantile(d, 0.99)),
           "vs_plain_max_px": float(d.max()),
           "valid_equal_share": float((valid == plain_valid).double().mean()),
           "valid_share": float(v[m].mean()), "median_err_px": float(np.median(err))}
    if not (res["vs_plain_median_px"] < 1e-3 and res["vs_plain_q99_px"] < 0.02
            and res["valid_share"] > 0.85 and res["median_err_px"] < 1.5):
        raise AssertionError(f"dense_disparity: {res}")
    # K3 at C = 12 at each of its shapes: bit for bit with its plain version
    # on the well-conditioned pixels, device time on use-once inputs, bound
    rng = np.random.RandomState(SEED + 14)
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    kw = dict(max_disp=12, clamp=24.0)
    ranges = [(0.0, 1.0)] * 2 + [(-12.0, 12.0)] * 2
    k3_rows = []
    for H, W in k3_shapes:
        a, b = (torch.from_numpy(rng.rand(H, W).astype(np.float32)).to(device) for _ in range(2))
        uc, vc = (torch.from_numpy(f).to(device) for f in smooth_flow(rng, (H // 2, W // 2), 18.0))
        got, ref = pyrup_warp_lk_cuda(a, b, uc, vc, **kw), pyrup_warp_lk_plain(a, b, uc, vc, **kw)
        upu, upv = 2.0 * pyr_up_cols_first(uc), 2.0 * pyr_up_cols_first(vc)
        mask = well_conditioned(*symmetric_warp(a, b, -upu.clamp(-24.0, 24.0), -upv.clamp(-24.0, 24.0),
                                                quantize=True, impl="shift_sep", max_disp=12))
        e = max(masked_err(got[0], ref[0], mask), masked_err(got[1], ref[1], mask))
        unmasked = max(float((x - y).abs().max()) for x, y in zip(got, ref))
        if not e <= ATOL_WARP_LK:
            raise AssertionError(f"K3 at C = 12, {H}x{W}: max|err| {e:.3g}")
        sets = [tuple(torch.empty(x.shape, device=device).uniform_(lo, hi, generator=gen)
                      for x, (lo, hi) in zip((a, b, uc, vc), ranges)) for _ in range(USE_ONCE_SETS + 1)]
        dev_ms = time_use_once(lambda *x: pyrup_warp_lk_cuda(*x, **kw), sets, device)
        ms, pms = time_pair(lambda: pyrup_warp_lk_plain(a, b, uc, vc, **kw),
                            lambda: pyrup_warp_lk_cuda(a, b, uc, vc, **kw), 20)
        cost = kernel_cost("pyrup_warp_lk", [a, b, uc, vc], list(got))
        k3_rows.append({"shape": [H, W], "max_disp": 12, "run": "stereo", "max_abs_err": e,
                        "max_abs_err_unmasked": unmasked, "well_conditioned_share":
                        float(mask.double().mean()), "device_ms": dev_ms, "ms": ms,
                        "plain_ms": pms, "library_ms": None,
                        "bound_ms": stage_roofline(Cost(cost.bytes, cost.ops))["bound_ms"],
                        "bytes": cost.bytes, "ops": cost.ops})
        log(f"  pyrup_warp_lk C=12 {H}x{W}: max|err| {e:.3g}, unmasked {unmasked:.3g}, device "
            f"{dev_ms * 1e3:.2f} us, kernel {ms * 1e3:.1f} us, plain {pms * 1e3:.1f} us, bound "
            f"{k3_rows[-1]['bound_ms'] * 1e3:.2f} us")
    res["k3_c12"] = k3_rows
    out["c"] = res
    log(f"[14 c dense_disparity] {json.dumps(res)}")

    # (d) the CLI on (a)'s frames written raw (BGR24, B = G = R)
    root = pathlib.Path(__file__).resolve().parent
    raw = root / "chiprun_out" / "phase14_frames.raw"
    tum = root / "chiprun_out" / "phase14_trajectory.tum"
    raw.parent.mkdir(exist_ok=True)
    np.stack([np.repeat(f[..., None], 3, axis=-1) for f in frames]).tofile(raw)
    try:
        cmd = [sys.executable, "-m", "optical_flow_tpu_torch", "slam", "--input",
               f"pipe:{w}x{h}:{raw}", "--frames", str(SLAM_FRAMES), "--focal", str(SLAM_FOCAL),
               "--kf-disparity", "0"]
        cli = subprocess.run(cmd + ["--out-tum", str(tum)], cwd=root, capture_output=True,
                             text=True, timeout=600)
    finally:
        raw.unlink()
    lines = cli.stdout.splitlines()
    if cli.returncode != 0 or not lines or not lines[0].startswith("keyframes "):
        raise AssertionError(f"slam CLI: rc {cli.returncode}\n{cli.stdout}\n{cli.stderr[-2000:]}")
    ts, _, _ = load_tum_trajectory(tum)
    n_kf = int(lines[0].split()[1])
    if len(ts) != n_kf:
        raise AssertionError(f"slam CLI: {len(ts)} TUM poses for {n_kf} keyframes")
    out["d"] = {"rc": cli.returncode, "first_line": lines[0], "tum_poses": len(ts)}
    log(f"[14 d slam CLI] {json.dumps(out['d'])}")

    # (e) times on the card, after the checks
    calls = {
        "incremental_slam_720p_10": (lambda: incremental_slam(card_frames, SLAM_FOCAL, **SLAM_KW), 2),
        "stereo_incremental_slam_720p_10": (lambda: incremental_slam(pairs_card, SLAM_FOCAL, **skw), 1),
        "dense_disparity_720p": (lambda: dense_disparity(lt, rt), TIMED_CALLS),
    }
    out["e"] = {}
    for name, (fn, n) in calls.items():
        out["e"][name] = call_profile(fn, n=n)
        log(f"[14 e time] {name}: {json.dumps(out['e'][name])}")
    for name, res_ in (("incremental_slam_720p_10", card), ("stereo_incremental_slam_720p_10", st_card)):
        e = out["e"][name]
        e["keyframes"] = len(res_.keyframes)
        e["ms_per_keyframe"] = e["ms_per_call"] / len(res_.keyframes)
        log(f"  {name}: {e['ms_per_keyframe']:.1f} ms per keyframe ({len(res_.keyframes)} keyframes)")
    maps = {"mono": card, "stereo": st_card, "frames": frames, "centres": centres,
            "stereo_centres": s_centres}
    return out, slam_counts, stereo_counts, k3_rows, maps


# ------------------------------------------------ phase 15: visual-inertial


def mapper_k2(n_frames, n_keyframes, n_loops, min_separation):
    """K2 launches of one incremental_slam run: each frame's tracking pyramid
    once, then both pyramids of every verified loop candidate (up to 3 of the
    5 closest pairs >= min_separation keyframes apart) and of every accepted
    loop's Sim(3) measurement."""
    pairs = sum(n_keyframes - d for d in range(min_separation, n_keyframes))
    return n_frames + 2 * min(3, pairs) + 2 * n_loops


def vi_traj(t):
    """tests/test_vi_ba.py::_traj without cv2: camera centres, world
    accelerations and world->cam rotations Rx(0.15 sin(2 om t + 0.5)) Ry(0.25
    sin(om t)) of the analytic trajectory, at the times `t` (any shape)."""
    om = 2 * np.pi / 8.0
    r, a = 0.4, 0.1
    t = np.asarray(t, np.float64)
    c = np.stack([r * np.sin(om * t), a * (1 - np.cos(2 * om * t)), r * (1 - np.cos(om * t))], -1)
    acc = np.stack([-r * om * om * np.sin(om * t), 4 * a * om * om * np.cos(2 * om * t),
                    r * om * om * np.cos(om * t)], -1)
    ay, ax = 0.25 * np.sin(om * t), 0.15 * np.sin(2 * om * t + 0.5)
    one, zero = np.ones_like(t), np.zeros_like(t)
    ry = np.stack([np.stack([np.cos(ay), zero, np.sin(ay)], -1), np.stack([zero, one, zero], -1),
                   np.stack([-np.sin(ay), zero, np.cos(ay)], -1)], -2)
    rx = np.stack([np.stack([one, zero, zero], -1), np.stack([zero, np.cos(ax), -np.sin(ax)], -1),
                   np.stack([zero, np.sin(ax), np.cos(ax)], -1)], -2)
    return c, acc, rx @ ry


def vi_scene(C=VI_KEYFRAMES, P=VI_POINTS, seed=SEED + 15):
    """tests/test_vi_ba.py::_make_scene at the size of phase 13 (c)'s BA:
    C keyframes VI_DT_KF apart, P points each seen by VI_TRACK consecutive
    keyframes (exact projections at BA_FOCAL), the exact IMU log of each
    interval (gyro from the relative rotation of each sample period, accel
    at its midpoint), the true velocities."""
    import torch

    from optical_flow_tpu_torch.slam.frontend import _rotmat_to_axis_angle
    from optical_flow_tpu_torch.slam.imu import _log_so3

    rng = np.random.RandomState(seed)
    kf_t = np.arange(C) * VI_DT_KF
    centers, _, poses = vi_traj(kf_t)
    trans = np.einsum("kij,kj->ki", poses, -centers)
    X = np.stack([rng.uniform(-1.2, 1.2, P), rng.uniform(-0.9, 0.9, P), rng.uniform(3.0, 6.0, P)], -1)
    first = rng.randint(0, C - VI_TRACK + 1, size=P)
    ci = (first[:, None] + np.arange(VI_TRACK)[None, :]).reshape(-1)
    pi = np.repeat(np.arange(P), VI_TRACK)
    Xc = np.einsum("mij,mj->mi", poses[ci], X[pi]) + trans[ci]
    obs = BA_FOCAL * Xc[:, :2] / Xc[:, 2:3]
    n, h = int(round(VI_DT_KF * VI_RATE)), 1.0 / VI_RATE
    t0 = kf_t[:-1, None] + np.arange(n)[None, :] * h  # (C-1, n)
    R0, R1 = vi_traj(t0)[2], vi_traj(t0 + h)[2]
    gyro = _log_so3(torch.from_numpy(R0 @ np.swapaxes(R1, -1, -2))).numpy() / h
    _, am, Rm = vi_traj(t0 + 0.5 * h)
    accel = np.einsum("...ij,...j->...i", Rm, am - G_W)
    eps = 1e-6
    vel = (vi_traj(kf_t + eps)[0] - vi_traj(kf_t - eps)[0]) / (2 * eps)
    cams = np.concatenate([np.stack([_rotmat_to_axis_angle(R) for R in poses]), trans], -1)
    return {"kf_t": kf_t, "poses": poses, "trans": trans, "centers": centers, "vel": vel, "X": X,
            "cams": cams, "cam_idx": ci, "pt_idx": pi, "obs": obs, "gyro": gyro, "accel": accel,
            "dt": np.full((C - 1, n), h)}


def vi_problem(sc, device, bias_jac=False, seed=7):
    """(a)'s float32 VI problem on `device`: the start of
    test_vi_ba_converges_from_perturbed_init (seed 7) on the scene, deltas
    preintegrated there (with their bias Jacobians for 15-DOF states)."""
    import torch

    from optical_flow_tpu_torch.slam import BAProblem, vi_problem_from_ba
    from optical_flow_tpu_torch.slam.imu import preintegrate, preintegrate_with_bias_jacobians

    rng = np.random.RandomState(seed)
    pert = np.concatenate([sc["cams"], sc["vel"]], -1)
    pert[1:, :3] += rng.randn(len(pert) - 1, 3) * 0.01
    pert[1:, 3:6] += rng.randn(len(pert) - 1, 3) * 0.02
    pert[:, 6:9] += rng.randn(len(pert), 3) * 0.05
    Xp = sc["X"] + rng.randn(*sc["X"].shape) * 0.02
    J = None
    if bias_jac:
        dR, dv, dp, J = preintegrate_with_bias_jacobians(sc["gyro"], sc["accel"], sc["dt"],
                                                         device=device)
    else:
        dR, dv, dp = preintegrate(sc["gyro"], sc["accel"], sc["dt"], device=device)

    def f32(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=device)

    base = BAProblem(f32(pert[:, :6]), f32(Xp), torch.from_numpy(sc["cam_idx"]).to(device),
                     torch.from_numpy(sc["pt_idx"]).to(device), f32(sc["obs"]), BA_FOCAL)
    return vi_problem_from_ba(base, pert[:, 6:9], dR, dv, dp, sc["dt"].sum(-1), G_W, bias_jac=J)


def state_centres(states):
    """Camera centres -R^T t of (C, >= 6) states (float64 on the host)."""
    from optical_flow_tpu_torch.slam.vi_ba import states_to_poses

    poses, trans = states_to_poses(states)
    return -np.einsum("kji,kj->ki", poses, trans)


def vi_summary(out, hist, sc):
    """test_vi_ba_converges_from_perturbed_init's measures: mean centre
    error (m), scale (mean |c_est| / |c_true| over the keyframes at least 0.1
    m from the origin, where the test's ratio is defined: the loop passes
    through it), velocity error (max, m/s), the history's first and last
    visual mean square; bias deltas (max |.|) of 15-DOF states."""
    st = out.states.detach().cpu().numpy()
    est = state_centres(st)
    far = np.linalg.norm(sc["centers"], axis=1) > 0.1
    h = hist.cpu().numpy()
    res = {"centre_err_mean_m": float(np.linalg.norm(est - sc["centers"], axis=1).mean()),
           "scale": float(np.mean(np.linalg.norm(est[far], axis=1)
                                  / np.linalg.norm(sc["centers"][far], axis=1))),
           "vel_err_max": float(np.abs(st[:, 6:9] - sc["vel"]).max()),
           "hist_vis_first": float(h[0, 0]), "hist_vis_last": float(h[-1, 0]),
           "hist_imu_last": float(h[-1, 1])}
    if st.shape[1] == 15:
        res["bias_delta_max"] = float(np.abs(st[:, 9:15]).max())
    return res, est


def vi_bars(what, r):
    if not (r["centre_err_mean_m"] < 5e-3 and abs(r["scale"] - 1.0) < 0.01
            and r["vel_err_max"] < 0.03 and r["hist_vis_last"] < r["hist_vis_first"]
            and r.get("bias_delta_max", 0.0) < 5e-3):
        raise AssertionError(f"{what} against the truth: {r}")


def loop_imu_log(rate=200.0):
    """The IMU log of phase 14's loop (radii x SLAM_SCALE) over one period
    of IMU_PERIOD s: zero gyro (R = I), accel a - g, as
    tests/test_vi_ba.py::test_refine_slam_result_with_imu builds it.
    Returns (t, gyro, accel)."""
    om = 2 * np.pi / IMU_PERIOD
    t = np.arange(0.0, IMU_PERIOD, 1.0 / rate)
    acc = SLAM_SCALE * np.stack([-0.12 * om * om * np.sin(om * t), 0.08 * om * om * np.cos(om * t),
                                 np.zeros_like(t)], -1)
    return t, np.zeros((len(t), 3)), acc - G_W


def metric_errors(est, keyframes, centres):
    """Refined keyframe centres against the truth with no scale fit: (mean
    error in loop radii, span ratio)."""
    true = np.asarray([centres[i] for i in keyframes])
    err = np.linalg.norm(est - true, axis=1)
    span = np.linalg.norm(np.diff(est, axis=0), axis=1).sum() / np.linalg.norm(
        np.diff(true, axis=0), axis=1).sum()
    return float(err.mean() / SLAM_RADIUS), float(span)


def phase_vi(device, maps):
    """Phase 15: the visual-inertial back end. `maps` holds phase 14's
    SlamResults and frames. Returns (summary, launch counts of (a) and (b),
    launch counts of (c)'s in-process slam --imu)."""
    import contextlib
    import io
    import pathlib

    import torch

    from optical_flow_tpu_torch import kernels
    from optical_flow_tpu_torch.__main__ import main as cli_main
    from optical_flow_tpu_torch.slam import imu, refine_slam_with_imu, vi_ba, vi_bundle_adjust

    out = {}
    sc = vi_scene()
    iters, lam = 12, 1e-4

    # (a) VI-BA at 60,000 observations, float32, card and CPU, 9 and 15 DOF;
    # whether TF32 was off inside the solve (the global setting on)
    solve_precision = []
    solve = vi_ba._solve_cameras

    def recording_solve(*args, **kw):
        solve_precision.append(torch.backends.cuda.matmul.fp32_precision)
        return solve(*args, **kw)

    kernels.reset_launch_counts()
    res, card_probs = {}, {}
    for dof, bias in (("9dof", False), ("15dof", True)):
        card_probs[dof] = vi_problem(sc, device, bias_jac=bias)
        t0 = time.perf_counter()
        card, card_hist = vi_bundle_adjust(card_probs[dof], iters=iters, lam=lam)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu, cpu_hist = vi_bundle_adjust(vi_problem(sc, "cpu", bias_jac=bias), iters=iters, lam=lam)
        cpu_s = time.perf_counter() - t0
        r_card, c_card = vi_summary(card, card_hist, sc)
        r_cpu, c_cpu = vi_summary(cpu, cpu_hist, sc)
        vi_bars(f"vi_bundle_adjust {dof} on the card", r_card)
        vi_bars(f"vi_bundle_adjust {dof} on the CPU", r_cpu)
        diff = {"centre_max_diff_m": float(np.abs(c_card - c_cpu).max()),
                "scale_diff": abs(r_card["scale"] - r_cpu["scale"])}
        if not (diff["centre_max_diff_m"] < 1e-3 and diff["scale_diff"] < 1e-4):
            raise AssertionError(f"vi_bundle_adjust {dof} card vs CPU: {diff}")
        res[dof] = {"card": r_card, "cpu": r_cpu, **diff, "first_call_s": {"card": card_s,
                                                                           "cpu": cpu_s}}
    # the global setting at TF32: the solve must still run in IEEE float32
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    try:
        vi_ba._solve_cameras = recording_solve
        vi_bundle_adjust(card_probs["9dof"], iters=iters, lam=lam)
        off = solve_precision == ["ieee"] * iters
        # reported, not required: the scale reached with TF32 on inside the solve
        solve_precision.clear()
        with contextlib.ExitStack() as stack:
            stack.callback(setattr, vi_ba, "_ieee_f32_matmul", vi_ba._ieee_f32_matmul)
            vi_ba._ieee_f32_matmul = contextlib.nullcontext
            tf32, tf32_hist = vi_bundle_adjust(card_probs["9dof"], iters=iters, lam=lam)
        res["tf32"] = {"off_inside_solve": off, "with_tf32_on": vi_summary(tf32, tf32_hist, sc)[0],
                       "precision_seen_with_tf32_on": sorted(set(solve_precision))}
    finally:
        vi_ba._solve_cameras = solve
        torch.backends.cuda.matmul.fp32_precision = "ieee"
    if not off:
        raise AssertionError(f"TF32 inside vi_bundle_adjust's solve: {solve_precision}")
    out["a"] = res
    log(f"[15 a vi_bundle_adjust] {json.dumps(res)}")

    # (b) refine_slam_with_imu on phase 14's SlamResults, card and CPU
    t, gyro, accel = loop_imu_log()
    res = {}
    for name in ("mono", "stereo"):
        slam = maps[name]
        centres = maps["centres" if name == "mono" else "stereo_centres"]
        kf_t = np.asarray(slam.keyframes) * (IMU_PERIOD / SLAM_FRAMES)
        runs = {}
        for dev in (device, "cpu"):
            refined, info = refine_slam_with_imu(slam, SLAM_FOCAL, t, gyro, accel, kf_t,
                                                 estimate_accel_bias=False, device=dev)
            est = state_centres(refined.states)
            err, span = metric_errors(est, slam.keyframes, centres)
            runs["cpu" if dev == "cpu" else "card"] = {
                "est": est, "centre_err_over_radius_mean": err, "span_ratio": span,
                "scale": info["scale"], "scale_applied": info["scale_applied"]}
        diff = float(np.abs(runs["card"].pop("est") - runs["cpu"].pop("est")).max() / SLAM_RADIUS)
        r = {**runs, "centre_max_diff_over_radius": diff}
        for k in ("card", "cpu"):
            q = runs[k]
            if not (q["centre_err_over_radius_mean"] < 0.05 / 0.12 and abs(q["span_ratio"] - 1) < 0.15
                    and (name == "mono" or q["scale_applied"] == 1.0)):
                raise AssertionError(f"refine_slam_with_imu ({name}, {k}) against the truth: {r}")
        if not diff < 1e-3:
            raise AssertionError(f"refine_slam_with_imu ({name}) card vs CPU: {r}")
        res[name] = r
    vi_counts = kernels.launch_counts()
    check_counts("the IMU functions and vi_bundle_adjust", vi_counts, {})
    out["b"] = res
    log(f"[15 b refine_slam_with_imu] {json.dumps(res)}")

    # (c) slam --imu on phase 14's frames: in-process with the launches
    # counted, then as a command with --imu-bias-states; its files in the
    # checkout's git-ignored build/, deleted after
    h, w = SLAM_HW
    root = pathlib.Path(__file__).resolve().parent
    work = root / "build" / "phase15"
    raw, log_path, traj = work / "frames.raw", work / "imu.npz", work / "trajectory.npz"
    work.mkdir(parents=True, exist_ok=True)
    np.stack([np.repeat(f[..., None], 3, axis=-1) for f in maps["frames"]]).tofile(raw)
    np.savez(log_path, t=t, gyro=gyro, accel=accel)
    args = ["slam", "--input", f"pipe:{w}x{h}:{raw}", "--frames", str(SLAM_FRAMES), "--focal",
            str(SLAM_FOCAL), "--kf-disparity", "0", "--imu", str(log_path), "--video-fps",
            str(SLAM_FRAMES / IMU_PERIOD), "--no-accel-bias"]
    try:
        buf = io.StringIO()
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(args + ["--out", str(traj)])
        torch.cuda.synchronize()
        cli_counts = kernels.launch_counts()
        bias = subprocess.run([sys.executable, "-m", "optical_flow_tpu_torch", *args,
                               "--imu-bias-states"], cwd=root, capture_output=True, text=True,
                              timeout=600)
        saved = np.load(traj)
        poses, trans, keyframes = saved["poses"], saved["trans"], saved["keyframes"]
    finally:
        for f in (raw, log_path, traj):
            f.unlink(missing_ok=True)
        work.rmdir()
    lines = buf.getvalue().splitlines()
    n_kf, n_loops = int(lines[0].split()[1]), int(lines[0].split()[-1])
    metric = [line for line in lines if "METRIC center" in line]
    vi_line = [line for line in lines if line.startswith("VI refinement: scale ")]
    est = -np.einsum("kji,kj->ki", poses, trans)
    err, span = metric_errors(est, keyframes, maps["centres"])
    want_k2 = mapper_k2(SLAM_FRAMES, n_kf, n_loops, 6)  # the CLI's loop_min_separation
    check_counts("slam --imu", cli_counts, {"oft_pyramid": want_k2})
    bias_lines = [line for line in bias.stdout.splitlines() if "bias states: gyro walked" in line]
    res = {"rc": rc, "first_line": lines[0], "vi_line": vi_line[0] if vi_line else None,
           "metric_lines": len(metric), "launches": cli_counts,
           "centre_err_over_radius_mean": err, "span_ratio": span,
           "bias_states_rc": bias.returncode, "bias_states_line": bias_lines[:1]}
    if not (rc == 0 and vi_line and len(metric) == n_kf == len(keyframes)
            and err < 0.05 / 0.12 and abs(span - 1) < 0.15):
        raise AssertionError(f"slam --imu: {res}\n{buf.getvalue()[-3000:]}")
    if bias.returncode != 0 or len(bias_lines) != 1:
        raise AssertionError(f"slam --imu --imu-bias-states: rc {bias.returncode}\n{bias.stdout}"
                             f"\n{bias.stderr[-2000:]}")
    out["c"] = res
    log(f"[15 c slam --imu] {json.dumps(res)}")

    # (e) times on the card, after the checks
    gyro_t, accel_t, dt_t = (torch.tensor(sc[k], dtype=torch.float32, device=device)
                             for k in ("gyro", "accel", "dt"))
    mono = maps["mono"]
    kf_t = np.asarray(mono.keyframes) * (IMU_PERIOD / SLAM_FRAMES)
    calls = {
        "preintegrate_49x100": (lambda: imu.preintegrate(gyro_t, accel_t, dt_t), TIMED_CALLS),
        "preintegrate_with_bias_jacobians_49x100": (
            lambda: imu.preintegrate_with_bias_jacobians(gyro_t, accel_t, dt_t), 1),
        "estimate_gyro_bias_3_iters": (
            lambda: imu.estimate_gyro_bias(sc["poses"], gyro_t, dt_t, iters=3), 1),
        "visual_inertial_alignment_with_bias": (
            lambda: imu.visual_inertial_alignment_with_bias(
                sc["poses"], sc["trans"], sc["dt"].sum(-1), gyro_t, accel_t, dt_t), 1),
        "vi_bundle_adjust_9dof_60k_obs_12_iters": (
            lambda: vi_bundle_adjust(card_probs["9dof"], iters=iters, lam=lam), 2),
        "vi_bundle_adjust_15dof_60k_obs_12_iters": (
            lambda: vi_bundle_adjust(card_probs["15dof"], iters=iters, lam=lam), 2),
        "refine_slam_with_imu_mono": (
            lambda: refine_slam_with_imu(mono, SLAM_FOCAL, t, gyro, accel, kf_t,
                                         estimate_accel_bias=False), 1),
    }
    out["e"] = {}
    for name, (fn, n) in calls.items():
        out["e"][name] = call_profile(fn, n=n)
        log(f"[15 e time] {name}: {json.dumps(out['e'][name])}")
    return out, vi_counts, cli_counts


# ------------------------------------------------------ phase 16: serving

SERVE_PROC = (SIZE, SIZE)  # the fast stream at full width
SERVE_FAITHFUL_PROC = (256, 256)  # the protocol's and the CLI's default proc size
SERVE_TRACED = 5  # served frames under the tracer (e)
SERVE_WINDOW = 300  # frames of (e)'s split window, phase 4's cycled; the first 3 not counted


def served_stream(client, frames, reset_at=None, **kw):
    """Stream `frames` on an open FlowClient. Returns the handshake reply,
    the replies, the end reply, ms from each send to its reply, the seconds
    from the handshake to the first result (the third frame's reply), and
    the launch counts from frame `reset_at` on (counters reset just before
    it is sent; None: not reset)."""
    from optical_flow_tpu_torch import kernels

    H, W = frames[0].shape[:2]
    t0 = time.perf_counter()
    hello = client.start_stream(H, W, **kw)
    if not hello.get("ok"):
        raise AssertionError(f"handshake refused: {hello}")
    replies, ms, first = [], [], None
    for k, f in enumerate(frames):
        if k == reset_at:
            kernels.reset_launch_counts()
        t1 = time.perf_counter()
        replies.append(client.push(f))
        ms.append((time.perf_counter() - t1) * 1e3)
        if k == 2:
            first = time.perf_counter() - t0
    counts = kernels.launch_counts() if reset_at is not None else None
    return hello, replies, client.end_stream(), ms, first, counts


def _quantiles(ms):
    return {"median": float(np.median(ms)), "p10": float(np.quantile(ms, 0.1)),
            "p90": float(np.quantile(ms, 0.9))}


def served_split(srv, frames, n, **hs):
    """Stream n frames (`frames` cycled) on a pooled pipeline of `srv` and
    split each steady frame's host time, in ms: the client's send of the
    frame; the server's step, its push (synchronized) and the rest of it
    (the gesture's scalars and the flow's copy to the host); the client's
    wait for the reply line beyond the step (the server's read of the
    payload, its JSON write, the threads' hand-offs); and the receipt of
    the flow (the server's write and the client's reads). Quantiles over
    frames 3..n-1."""
    import torch

    from optical_flow_tpu_torch.pipeline.serve import _U32, FlowClient

    H, W = frames[0].shape[:2]
    push_ms, step_ms = [], []
    step = srv.step

    def timed_push(push):
        def run(frame):
            t0 = time.perf_counter()
            r = push(frame)
            torch.cuda.synchronize()
            push_ms.append((time.perf_counter() - t0) * 1e3)
            return r
        return run

    def timed_step(*args):
        t0 = time.perf_counter()
        r = step(*args)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return r

    pipes = [p for _, p in pooled_pipelines(srv)]
    for p in pipes:
        p.push = timed_push(p.push)
    srv.step = timed_step
    payloads = [_U32.pack(f.nbytes) + np.ascontiguousarray(f).tobytes() for f in frames]
    send, wait, recv = [], [], []
    try:
        with FlowClient(srv.address) as c:
            hello = c.start_stream(H, W, **hs)
            if hello != {"ok": True, "pooled": True}:
                raise AssertionError(f"split window: not a pooled stream: {hello}")
            for k in range(n):
                t0 = time.perf_counter()
                c._sock.sendall(payloads[k % len(payloads)])
                t1 = time.perf_counter()
                reply = c._read_json()
                t2 = time.perf_counter()
                if hs.get("return_flow") and not reply.get("warmup"):
                    c._read_blob()
                t3 = time.perf_counter()
                if k >= 2 and not np.isfinite([reply["cx"], reply["cy"]]).all():
                    raise AssertionError(f"split window: reply {k}: {reply}")
                send.append((t1 - t0) * 1e3)
                wait.append((t2 - t1) * 1e3)
                recv.append((t3 - t2) * 1e3)
            if c.end_stream() != {"end": True, "frames": n}:
                raise AssertionError("split window: wrong end reply")
    finally:
        del srv.step
        for p in pipes:
            del p.push
    if not (len(push_ms) == len(step_ms) == n):
        raise AssertionError(f"split window: {len(push_ms)} pushes, {len(step_ms)} steps timed")
    steady = slice(3, None)
    send, wait, recv = (np.array(x[steady]) for x in (send, wait, recv))
    push, stp = np.array(push_ms[steady]), np.array(step_ms[steady])
    return {"frames": n - 3, "total": _quantiles(send + wait + recv),
            "client_send": _quantiles(send), "server_push_synced": _quantiles(push),
            "server_scalars_and_d2h": _quantiles(stp - push),
            "wait_beyond_step": _quantiles(wait - stp), "flow_receipt": _quantiles(recv)}


def same_as_direct(what, replies, direct, flow=True):
    """Raise unless the replies are two warm-ups and then the direct
    results bit for bit: u and v as float32 bits, votes, detected, cx, cy."""
    if [r.get("warmup", False) for r in replies[:2]] != [True, True] or \
            len(replies) - 2 != len(direct):
        raise AssertionError(f"{what}: {len(replies)} replies for {len(direct)} results")
    for k, (r, d) in enumerate(zip(replies[2:], direct)):
        g = d.gesture
        ok = (r.get("frame") == k + 2 and r["votes"] == int(g.votes)
              and r["detected"] == bool(g.detected) and r["cx"] == float(g.cx)
              and r["cy"] == float(g.cy))
        for name in ("u", "v") if flow else ():
            want = getattr(d, name).float().cpu().numpy()
            ok = ok and r[name].shape == want.shape and np.array_equal(
                r[name].view(np.uint32), want.view(np.uint32))
        if not ok:
            raise AssertionError(f"{what}: served result {k} differs from the direct push")


def pooled_pipelines(srv):
    """(key, pipeline) of every idle pipeline in the server's pool."""
    return [(k, p) for k, free in srv.pool._free.items() for p in free]


def phase_serve(device, frames):
    """Phase 16: FlowServer answering socket streams on the card. (a) fast
    at full width over TCP, bit for bit with the direct push, steady counts
    per frame, then a pooled stream that replays the captured graph; (b)
    two concurrent clients, a faithful stream at 256^2, a Unix socket, the
    JAX impl names; (c) `video --fast` and (d) `flow` as commands; (e)
    served ms a frame with and without the flow, direct push beside it, the
    time to a first result, a traced served frame and memory per pooled
    pipeline."""
    import os
    import pathlib
    import shutil
    import tempfile
    import threading

    import torch
    from PIL import Image
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from optical_flow_tpu_torch import kernels
    from optical_flow_tpu_torch.config import FlowConfig
    from optical_flow_tpu_torch.flow.coarse_to_fine import coarse_to_fine
    from optical_flow_tpu_torch.pipeline.serve import FlowClient, FlowServer, _make_config
    from optical_flow_tpu_torch.pipeline.video import VideoPipeline
    from optical_flow_tpu_torch.utils.goldens import save_mat
    from optical_flow_tpu_torch.utils.images import imread_gray
    from optical_flow_tpu_torch.utils.interop import load_flo

    F = len(frames)
    H, W = frames[0].shape[:2]
    out = {}
    fast = _make_config("fast", SERVE_PROC, "auto")
    faithful = _make_config("faithful", SERVE_FAITHFUL_PROC, "auto")
    kernels.reset_launch_counts()
    direct, direct_ms = run_stream(fast, frames, device)
    direct_counts = kernels.launch_counts()
    check_counts("direct fast push", direct_counts,
                 {"oft_pyramid": F - 1, "oft_lk": F - 2, "oft_pyrup_warp_lk": 3 * (F - 2),
                  "oft_diff_features": F - 1})
    frames_b = synthetic_frames(np.random.RandomState(SEED + 1), F, FRAME_HW)
    direct_b, _ = run_stream(fast, frames_b, device)
    kernels.reset_launch_counts()
    direct_f, direct_f_ms = run_stream(faithful, frames, device)
    faithful_counts = kernels.launch_counts()
    torch.cuda.synchronize()
    mem = [torch.cuda.memory_allocated(device)]
    fast_hs = dict(preset="fast", proc_size=SERVE_PROC, return_flow=True)

    srv = FlowServer(port=0)  # on the card: its default device
    srv.start_background()
    try:
        with FlowClient(srv.address) as c:
            # (a) a new pipeline (captured at its third frame), then the
            # served steady frames counted; then the same stream pooled
            hello1, r1, tail1, ms1, first1, steady = served_stream(c, frames, reset_at=3, **fast_hs)
            if hello1 != {"ok": True, "pooled": False} or tail1 != {"end": True, "frames": F}:
                raise AssertionError(f"first served stream: {hello1}, {tail1}")
            same_as_direct("served fast stream", r1, direct)
            n_steady = F - 3
            check_counts("served steady frames", steady, {
                "oft_pyramid": n_steady, "oft_lk": n_steady, "oft_pyrup_warp_lk": 3 * n_steady,
                "oft_diff_features": n_steady})
            torch.cuda.synchronize()
            mem.append(torch.cuda.memory_allocated(device))
            ((key, pipe),) = pooled_pipelines(srv)
            graphs = dict(pipe._graphs)
            hello2, r2, tail2, ms2, first2, pooled_counts = served_stream(c, frames, reset_at=0,
                                                                          **fast_hs)
            if hello2 != {"ok": True, "pooled": True} or tail2 != {"end": True, "frames": F}:
                raise AssertionError(f"pooled served stream: {hello2}, {tail2}")
            same_as_direct("pooled served stream", r2, direct)
            if len(graphs) != 1 or pipe._graphs.keys() != graphs.keys() or any(
                    pipe._graphs[k] is not g for k, g in graphs.items()):
                raise AssertionError(f"the pooled stream captured a new graph: {list(pipe._graphs)}")
            check_counts("pooled served stream", pooled_counts, direct_counts)
            # (e) without the flow, pooled
            _, r3, _, ms3, _, _ = served_stream(c, frames, preset="fast", proc_size=SERVE_PROC)
            same_as_direct("served fast stream without the flow", r3, direct, flow=False)
        # the same stream through a server whose pipelines tile the flow
        # over a 2x2 mesh on the card: phase 7's launches (K2 1, K1 1, K3 1
        # at 270^2, K5 per tile at 540^2 and 1080^2; P1 once per tile at
        # the new mesh's first sharded call)
        tiles = GRID[0] * GRID[1]
        msrv = FlowServer(port=0, mesh=grid_mesh(device))
        msrv.start_background()
        try:
            with FlowClient(msrv.address) as c:
                _, rm, tailm, msm, _, mesh_counts = served_stream(c, frames, reset_at=0,
                                                                  **fast_hs)
        finally:
            msrv.shutdown()
        if tailm != {"end": True, "frames": F}:
            raise AssertionError(f"mesh-served stream: {tailm}")
        same_as_direct("mesh-served stream", rm, direct)
        check_counts("mesh-served stream", mesh_counts, {
            "oft_pyramid": F - 1, "oft_lk": F - 2, "oft_pyrup_warp_lk": F - 2,
            "oft_pyrup_warp_lk_tile": 2 * tiles * (F - 2), "oft_tile_copy": tiles,
            "oft_diff_features": F - 1})
        out["a"] = {"pooled": [hello1["pooled"], hello2["pooled"]], "results": len(r1) - 2,
                    "bit_identical": True, "steady_launches_per_frame": {
                        k: v / n_steady for k, v in steady.items() if v},
                    "pooled_stream_launches": pooled_counts, "graphs": len(graphs),
                    "mesh_stream_launches": mesh_counts,
                    "mesh_ms_per_frame_median": float(np.median(msm[3:]))}
        log(f"[16 a served fast 1080^2] {json.dumps(out['a'])}")

        # (b) two clients at once, each its own frames: one takes the pooled
        # pipeline, the other builds and captures its own while the first is
        # answered
        results, errors = {}, []

        def client(name, fr):
            try:
                with FlowClient(srv.address) as cc:
                    results[name] = served_stream(cc, fr, **fast_hs)
            except Exception as e:  # re-raised below, in the main thread
                errors.append(f"{name}: {e!r}")

        threads = [threading.Thread(target=client, args=(n, fr))
                   for n, fr in (("seed0", frames), ("seed1", frames_b))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"concurrent clients: {errors}, alive "
                                 f"{[t.is_alive() for t in threads]}")
        same_as_direct("concurrent client, seed 0", results["seed0"][1], direct)
        same_as_direct("concurrent client, seed 1", results["seed1"][1], direct_b)
        torch.cuda.synchronize()
        mem.append(torch.cuda.memory_allocated(device))
        b = {"concurrent_pooled": sorted(r[0]["pooled"] for r in results.values()),
             "pooled_fast_pipelines": len(pooled_pipelines(srv))}
        with FlowClient(srv.address) as c:
            _, rf, _, msf, _, served_f = served_stream(
                c, frames, reset_at=0, preset="faithful", proc_size=SERVE_FAITHFUL_PROC,
                return_flow=True)
            same_as_direct("served faithful stream", rf, direct_f)
            check_counts("served faithful stream", served_f, faithful_counts)
            if not (served_f["oft_lk"] and served_f["oft_pyrup"]):
                raise AssertionError(f"the faithful stream launched no K1 / S1: {served_f}")
            # the JAX package's impl names: "pallas" builds the "cuda" pipeline
            short = frames[:6]
            hp, rp, _, _, _, _ = served_stream(c, short, impl="pallas", **fast_hs)
            hc, rc_, _, _, _, _ = served_stream(c, short, impl="cuda", **fast_hs)
            same_as_direct("impl='pallas' stream", rp, direct[:4])
            same_as_direct("impl='cuda' stream", rc_, direct[:4])
            named = [p.config.flow.impl for k, p in pooled_pipelines(srv) if k[-1] == "cuda"]
            if (hp["pooled"], hc["pooled"]) != (False, True) or named != ["cuda"]:
                raise AssertionError(f"impl names: pallas {hp}, cuda {hc}, pooled {named}")
        b.update({"faithful_launches": served_f, "faithful_results": len(rf) - 2,
                  "pallas_then_cuda_pooled": [hp["pooled"], hc["pooled"]]})
        sock_dir = tempfile.mkdtemp()
        try:
            usrv = FlowServer(unix_path=os.path.join(sock_dir, "flow.sock"))
            usrv.start_background()
            try:
                with FlowClient(usrv.address) as c:
                    _, ru, tailu, _, _, _ = served_stream(c, short, **fast_hs)
            finally:
                usrv.shutdown()
        finally:
            shutil.rmtree(sock_dir, ignore_errors=True)
        same_as_direct("Unix-socket stream", ru, direct[:4])
        b["unix_frames"] = tailu["frames"]
        out["b"] = b
        log(f"[16 b concurrency and surfaces] {json.dumps(b)}")

        # (e) the split window, with and without the flow, and the direct
        # push on the same cycled frames
        split = {"with_flow": served_split(srv, frames, SERVE_WINDOW, **fast_hs),
                 "without_flow": served_split(srv, frames, SERVE_WINDOW,
                                              **dict(fast_hs, return_flow=False))}
        dpipe = VideoPipeline(fast, device=device)
        dms = []
        for k in range(SERVE_WINDOW):
            t0 = time.perf_counter()
            dpipe.push(frames[k % F])
            torch.cuda.synchronize()
            dms.append((time.perf_counter() - t0) * 1e3)
        del dpipe
        split["direct_push_synced"] = _quantiles(dms[3:])
        log(f"[16 e split, {SERVE_WINDOW} frames] {json.dumps(split)}")

        # (e) one traced window of served frames (pooled, with the flow):
        # the device events of the server's thread, busy and idle share
        with FlowClient(srv.address) as c:
            c.start_stream(H, W, **fast_hs)
            for f in frames[:3]:
                c.push(f)
            walls = []
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for f in frames[3 : 3 + SERVE_TRACED]:
                    t0 = time.perf_counter()
                    c.push(f)
                    walls.append((time.perf_counter() - t0) * 1e3)
            c.end_stream()
    finally:
        srv.shutdown()
    # the tracer sees the server thread's device work (None: not measured)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _busy_ms([(e.time_range.start, e.time_range.end) for e in events]) if events else None
    by_name = {}
    for e in events:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6])

    # (c) `video --fast` and (d) `flow` as commands, their files in the
    # checkout's git-ignored build/, deleted after
    root = pathlib.Path(__file__).resolve().parent
    work = root / "build" / "phase16"
    work.mkdir(parents=True, exist_ok=True)
    try:
        raw = work / "frames.raw"
        np.stack(frames).tofile(raw)
        video = subprocess.run(
            [sys.executable, "-m", "optical_flow_tpu_torch", "video", "--input",
             f"pipe:{W}x{H}:{raw}", "--fast", "--size", str(SIZE), "--frames", str(F),
             "--metrics"], cwd=root, capture_output=True, text=True, timeout=600)
        lines = [ln for ln in video.stdout.splitlines() if ln.startswith("frame ")]
        want = [f"frame {k}: votes={int(d.gesture.votes)} detected={bool(d.gesture.detected)} "
                f"centroid=({float(d.gesture.cx):.1f},{float(d.gesture.cy):.1f})"
                for k, d in enumerate(direct)]
        metrics = [json.loads(ln) for ln in video.stderr.splitlines() if ln.startswith("{")]
        counters = metrics[-1]["counters"] if metrics else {}
        if (video.returncode != 0 or lines != want or "GUARD TRIPPED" in video.stdout
                or counters.get("frames") != F - 2 or "guard_trips" in counters):
            raise AssertionError(f"video --fast: rc {video.returncode}\n{video.stdout}\n"
                                 f"{video.stderr[-2000:]}")
        out["c"] = {"rc": video.returncode, "frame_lines": len(lines), "counters": counters,
                    "frame_ms_mean": metrics[-1]["histograms"]["frame"]["mean_ms"]}
        log(f"[16 c video --fast] {json.dumps(out['c'])}")

        img1, img2 = shifted_pair(device, SIZE)
        pngs = []
        for name, img in (("a.png", img1), ("b.png", img2)):
            Image.fromarray(np.clip(np.rint(img.cpu().numpy() * 255.0), 0, 255)
                            .astype(np.uint8)).save(work / name)
            pngs.append(str(work / name))
        flow = subprocess.run(
            [sys.executable, "-m", "optical_flow_tpu_torch", "flow", *pngs, "--out-prefix",
             str(work / "cli"), "--flo", str(work / "cli.flo")], cwd=root, capture_output=True,
            text=True, timeout=600)
        if flow.returncode != 0:
            raise AssertionError(f"flow: rc {flow.returncode}\n{flow.stdout}\n{flow.stderr[-2000:]}")
        a, b_ = (torch.from_numpy(imread_gray(p).astype(np.float32) / 255.0).to(device)
                 for p in pngs)
        kernels.reset_launch_counts()
        u, v = coarse_to_fine(a, b_, config=FlowConfig())
        flow_counts = kernels.launch_counts()
        save_mat(u, work / "direct_u.txt")
        save_mat(v, work / "direct_v.txt")
        fu, fv = load_flo(str(work / "cli.flo"))
        same = {name: (work / f"cli_{name}.txt").read_bytes() == (work / f"direct_{name}.txt")
                .read_bytes() for name in ("u", "v")}
        flo_same = bool(np.array_equal(fu, u.cpu().numpy()) and np.array_equal(fv, v.cpu().numpy()))
        if not (all(same.values()) and flo_same and np.isfinite(fu).all()
                and (work / "cli_flow.png").stat().st_size > 0):
            raise AssertionError(f"flow: text files equal {same}, .flo equal {flo_same}")
        inner = (slice(8, -8), slice(8, -8))
        epe = float(torch.hypot(u[inner] - SHIFT[0], v[inner] - SHIFT[1]).median())
        out["d"] = {"rc": flow.returncode, "txt_equal_direct": same, "flo_equal_direct": flo_same,
                    "launches": {k: n for k, n in flow_counts.items() if n},
                    "median_epe_to_the_shift_px": epe, "line": flow.stdout.splitlines()[0]}
        log(f"[16 d flow] {json.dumps(out['d'])} (reference mode, the CLI's default: the flow "
            f"is not doubled between levels, so it is not the pair's displacement; phase 5 "
            f"holds the corrected controller to the shift)")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    steady = slice(3, None)
    out["e"] = {
        "served_ms_per_frame_with_flow_median": float(np.median(ms1[steady])),
        "served_ms_per_frame_with_flow_pooled_median": float(np.median(ms2[steady])),
        "served_ms_per_frame_without_flow_median": float(np.median(ms3[steady])),
        "direct_push_ms_per_frame_median": float(np.median(direct_ms)),
        "served_faithful_256_ms_per_frame_median": float(np.median(msf[steady])),
        "direct_faithful_256_push_ms_per_frame_median": float(np.median(direct_f_ms)),
        "first_result_s_new_pipeline": first1, "first_result_s_pooled": first2,
        "split": split,
        "flow_bytes_per_frame": 2 * SIZE * SIZE * 4,
        "traced": {"frames": SERVE_TRACED, "wall_ms_per_frame": float(np.mean(walls)),
                   "device_events_per_frame": len(events) / SERVE_TRACED,
                   "device_busy_ms_per_frame": None if busy is None else busy / SERVE_TRACED,
                   "idle_share": None if busy is None else 1.0 - busy / float(np.sum(walls)),
                   "top_device_ms": top},
        "memory_allocated_bytes": {"before": mem[0], "one_pooled_fast_pipeline": mem[1] - mem[0],
                                   "second_pooled_fast_pipeline": mem[2] - mem[1]},
        "memory_reserved_bytes": torch.cuda.memory_reserved(device),
    }
    log(f"[16 e time] {json.dumps(out['e'])}")
    return out, pooled_counts, served_f, mesh_counts


# ------------------------------------------ phase 17: the mesh across processes

SHARD_MESH = (2, 2, 2)  # (a), (b): eight shards, every slot the one card
RANKS = 2
RANK_MESH = (4, 2, 1)  # (c): frames ride the ranks, rank r holds frame indices 2r, 2r+1
RANK_TIMEOUT_S = 300
BA_ITERS, BA_LAM = 5, 1e-4  # phase 13 (c)'s solve


def local_points(prob, n):
    """A point-major problem (phase 13's and 15's scenes list each point's
    observations together) in the sharded layout: pt_idx local to each of n
    shards."""
    return prob._replace(pt_idx=prob.pt_idx % (prob.points.shape[0] // n))


def timed_ms(fn, n=3):
    """Host ms per call of `fn` (synchronized), median of n after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def phase_sharded(device):
    """Phase 17: the sharded solvers on one card, two ranks on the card, and
    dryrun_multichip. Returns (summary, rank 0's launch counts of (c)'s
    sharded_coarse_to_fine)."""
    import torch

    from optical_flow_tpu_torch import kernels
    from optical_flow_tpu_torch.dryrun import dryrun_multichip
    from optical_flow_tpu_torch.parallel import flow_mesh
    from optical_flow_tpu_torch.slam import (
        bundle_adjust,
        reprojection_rmse,
        sharded_bundle_adjust,
        sharded_vi_bundle_adjust,
        vi_bundle_adjust,
    )

    out = {}
    mesh = flow_mesh(*SHARD_MESH, devices=[device] * int(np.prod(SHARD_MESH)))
    n = mesh.size

    # (a) sharded BA, float64, 60,000 observations over 8 shards of the card
    prob, _ = ba_scene()
    flat, _ = bundle_adjust(prob, iters=BA_ITERS, lam=BA_LAM, device=device)
    kernels.reset_launch_counts()
    sol, hist = sharded_bundle_adjust(local_points(prob, n), mesh, iters=BA_ITERS, lam=BA_LAM)
    torch.cuda.synchronize()
    ba_counts = kernels.launch_counts()
    rmse0 = float(reprojection_rmse(prob))
    rmse1 = float(reprojection_rmse(sol._replace(pt_idx=prob.pt_idx)))
    res = {"shards": n, "observations": int(prob.obs.shape[0]), "rmse_before": rmse0,
           "rmse_after": rmse1, "history": hist.tolist(),
           "cams_rel_diff_vs_unsharded": rel_diff(sol.cams, flat.cams),
           "points_rel_diff_vs_unsharded": rel_diff(sol.points, flat.points)}
    bad, true_cams = ba_scene(outliers=0.05)
    rob_flat, _ = bundle_adjust(bad, iters=BA_ITERS, lam=BA_LAM, robust_delta=2.0, device=device)
    rob, _ = sharded_bundle_adjust(local_points(bad, n), mesh, iters=BA_ITERS, lam=BA_LAM,
                                   robust_delta=2.0)
    res["robust"] = {"cams_rel_diff_vs_unsharded": rel_diff(rob.cams, rob_flat.cams),
                     "points_rel_diff_vs_unsharded": rel_diff(rob.points, rob_flat.points),
                     "cam_err": float(np.abs(rob.cams[:, 3:].cpu().numpy() - true_cams[:, 3:]).max())}
    if not (rmse1 < 0.1 * rmse0 and res["cams_rel_diff_vs_unsharded"] <= 1e-8
            and res["points_rel_diff_vs_unsharded"] <= 1e-8
            and res["robust"]["cams_rel_diff_vs_unsharded"] <= 1e-8
            and res["robust"]["points_rel_diff_vs_unsharded"] <= 1e-8
            and res["robust"]["cam_err"] < 0.15 and not any(ba_counts.values())):
        raise AssertionError(f"sharded_bundle_adjust on the card: {res}, launches {ba_counts}")
    out["a"] = res
    log(f"[17 a sharded_bundle_adjust] {json.dumps(res)}")

    # (b) sharded VI-BA, float32, phase 15 (a)'s scene and start, 9 and 15 DOF
    sc = vi_scene()
    res = {}
    for dof, bias in (("9dof", False), ("15dof", True)):
        vprob = vi_problem(sc, device, bias_jac=bias)
        t0 = time.perf_counter()
        vflat, vflat_hist = vi_bundle_adjust(vprob, iters=12, lam=1e-4)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        vsol, vhist = sharded_vi_bundle_adjust(local_points(vprob, n), mesh, iters=12, lam=1e-4)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        r, c = vi_summary(vsol, vhist, sc)
        r_flat, c_flat = vi_summary(vflat, vflat_hist, sc)
        vi_bars(f"sharded_vi_bundle_adjust {dof}", r)
        res[dof] = {"sharded": r, "centre_max_diff_m": float(np.abs(c - c_flat).max()),
                    "scale_diff": abs(r["scale"] - r_flat["scale"]),
                    "states_max_abs_diff": float((vsol.states - vflat.states).abs().max()),
                    "points_max_abs_diff": float((vsol.points - vflat.points).abs().max()),
                    "first_call_s": {"unsharded": t1 - t0, "sharded": t2 - t1}}
        if not (res[dof]["centre_max_diff_m"] < 1e-3 and res[dof]["scale_diff"] < 1e-4):
            raise AssertionError(f"sharded_vi_bundle_adjust {dof} against vi_bundle_adjust: "
                                 f"{res[dof]}")
    out["b"] = res
    log(f"[17 b sharded_vi_bundle_adjust] {json.dumps(res)}")

    # (c) two ranks on the card, over gloo on loopback
    ranks = run_ranks()
    for r in ranks:
        log(f"[17 c rank {r['rank']}] {json.dumps(r)}")
    out["c"] = ranks
    out["c_gloo_cuda_send"] = gloo_cuda_send()
    log(f"[17 c gloo send of a CUDA tensor, reported] {json.dumps(out['c_gloo_cuda_send'])}")

    # (d) dryrun_multichip on 4 slots of the card
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    dry = dryrun_multichip(4)
    torch.cuda.synchronize()
    dry["s"] = time.perf_counter() - t0
    dry["launches"] = {k: v for k, v in kernels.launch_counts().items() if v}
    out["d"] = dry
    log(f"[17 d dryrun_multichip(4)] {json.dumps(dry)}")

    # (e) ms per call beside the unsharded counterparts; one traced call each
    local = local_points(prob, n)
    out["e"] = {
        "bundle_adjust": call_profile(
            lambda: bundle_adjust(prob, iters=BA_ITERS, lam=BA_LAM, device=device), n=2),
        "sharded_bundle_adjust_8_shards": call_profile(
            lambda: sharded_bundle_adjust(local, mesh, iters=BA_ITERS, lam=BA_LAM), n=2),
        "vi_first_call_s": {dof: v["first_call_s"] for dof, v in res.items()},
        "ranks_ms": {r["rank"]: r["ms"] for r in ranks},
        "ranks_wire_bytes": {r["rank"]: r["wire_bytes"] for r in ranks},
    }
    log(f"[17 e time] {json.dumps(out['e'])}")
    return out, ranks[0]["launches"]["ctf"]


def run_ranks():
    """(c): RANKS processes of this script (``--rank PORT RANK``) started
    together, each waited for with a timeout; their output goes to
    chiprun_out/phase17_rank{r}.log. Returns each rank's result line."""
    import os
    import pathlib
    import socket

    here = pathlib.Path(__file__).resolve().parent
    logs = here / "chiprun_out"
    logs.mkdir(exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    files = [open(logs / f"phase17_rank{r}.log", "w+") for r in range(RANKS)]
    procs = [subprocess.Popen([sys.executable, str(here / "chip_smoke.py"), "--rank", str(port),
                               str(r)], cwd=here, env=env, stdout=f, stderr=subprocess.STDOUT,
                              text=True) for r, f in enumerate(files)]
    try:
        deadline = time.monotonic() + RANK_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, f) in enumerate(zip(procs, files)):
        f.seek(0)
        text = f.read()
        f.close()
        lines = [ln for ln in text.splitlines() if ln.startswith("RANK_RESULT ")]
        if p.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n{text[-4000:]}")
        results.append(json.loads(lines[0][len("RANK_RESULT "):]))
    return results


def gloo_cuda_send():
    """Whether gloo sends a CUDA tensor point to point (two ranks of this
    script, ``--gloo-send PORT RANK``, 1000 floats from rank 0 to rank 1):
    the reason the port's halo strips cross gloo through pinned host memory.
    Reported: each rank's exit code and its last line."""
    import os
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen([sys.executable, __file__, "--gloo-send", str(port), str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(RANKS)]
    out = {}
    for r, p in enumerate(procs):
        try:
            text, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
        lines = [ln for ln in text.strip().splitlines() if ln.strip()]
        out[r] = {"exit": p.returncode, "last_line": lines[-1][-300:] if lines else ""}
    return out


def gloo_send_worker(port: int, rank: int) -> int:
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=RANKS,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    x = torch.full((1000,), 1.0 + rank, device="cuda")
    if rank == 0:
        dist.send(x, 1)
    else:
        dist.recv(x, 0)
    print(f"received {float(x.sum())}" if rank else "sent", flush=True)
    return 0


def rank_worker(port: int, rank: int) -> int:
    """One rank of (c): the JAX package's tests/_distributed_worker.py legs
    at full width, each against the unsharded path on this rank; prints one
    RANK_RESULT line."""
    import torch

    from optical_flow_tpu_torch import kernels
    from optical_flow_tpu_torch.config import PreprocessConfig, VideoConfig
    from optical_flow_tpu_torch.flow.coarse_to_fine import coarse_to_fine
    from optical_flow_tpu_torch.flow.lk import lucas_kanade
    from optical_flow_tpu_torch.parallel import distributed as tdist
    from optical_flow_tpu_torch.parallel import sharded_coarse_to_fine, sharded_lucas_kanade
    from optical_flow_tpu_torch.parallel.mesh import (
        local_indices,
        psum,
        reset_wire_counts,
        split,
        wire_counts,
    )
    from optical_flow_tpu_torch.pipeline.preprocess import preprocess_frame
    from optical_flow_tpu_torch.slam import bundle_adjust, sharded_bundle_adjust

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = tdist.initialize_distributed(f"127.0.0.1:{port}", RANKS, rank)
    device = torch.device("cuda", torch.cuda.current_device())
    res = {"rank": rank, "backend": backend, "world": torch.distributed.get_world_size(),
           "strips_through_pinned_host_memory": backend == "gloo", "launches": {}, "ms": {},
           "wire_bytes": {}}

    # phase 4's frames, round robin over the ranks, as gray 1080^2 frames
    frames = synthetic_frames(np.random.RandomState(SEED), FRAMES, FRAME_HW)
    pre = PreprocessConfig(size=(SIZE, SIZE), faithful_uint8=False)

    def gray(f):
        return preprocess_frame(torch.from_numpy(f).to(device), pre)

    local = [gray(f) for f in list(tdist.host_local_frames(frames))[:4]]
    mesh = tdist.global_flow_mesh(*RANK_MESH, devices=[device] * (int(np.prod(RANK_MESH)) // RANKS))
    img1, img2 = tdist.make_global_batch(local[:2], mesh), tdist.make_global_batch(local[2:], mesh)
    want = torch.stack([gray(frames[p + RANKS * i]) for p in range(RANKS) for i in range(2)])
    if not torch.equal(img1, want):
        raise AssertionError("make_global_batch: not the frames in rank order")

    kernels.reset_launch_counts()
    u, v = sharded_lucas_kanade(img1, img2, mesh)
    torch.cuda.synchronize()
    res["launches"]["lk"] = counts = kernels.launch_counts()
    tiles = len(mesh.local_slots())
    check_counts(f"rank {rank} sharded LK", counts, {"oft_lk": tiles, "oft_tile_copy": tiles})
    ou, ov = lucas_kanade(img1, img2)
    res["lk_bit_equal"] = bool(torch.equal(u, ou) and torch.equal(v, ov))
    t = split(u.double(), mesh)
    mean = float(psum([t[idx].sum() for idx in local_indices(t)], mesh)) / u.numel()
    res["global_mean_diff"] = abs(mean - float(ou.double().mean()))
    res["ms"]["sharded_lk"] = timed_ms(lambda: sharded_lucas_kanade(img1, img2, mesh))
    res["ms"]["lk"] = timed_ms(lambda: lucas_kanade(img1, img2))

    # the fast controller on phase 5's pair, the rows of a 2x2 mesh on two ranks
    mesh_sp = tdist.global_flow_mesh(1, 2, 2, devices=[device] * 2)
    if not (mesh_sp.ranks[0, 0] == 0).all() or not (mesh_sp.ranks[0, 1] == 1).all():
        raise AssertionError(f"the mesh's rows do not lie on different ranks: {mesh_sp}")
    a, b = shifted_pair(device, SIZE)
    cfg = VideoConfig.fast(size=(SIZE, SIZE)).flow
    u0, v0 = coarse_to_fine(a, b, 4, config=cfg)
    kernels.reset_launch_counts()
    reset_wire_counts()
    u2, v2 = sharded_coarse_to_fine(a, b, mesh_sp, 4, config=cfg)
    torch.cuda.synchronize()
    res["launches"]["ctf"] = counts = kernels.launch_counts()
    res["wire_bytes"]["ctf_first_call"] = wire_counts()["bytes"]
    tiles = len(mesh_sp.local_slots())
    # 135^2 (K1) and 270^2 (K3, odd 135^2 tiles) run whole on every rank
    check_counts(f"rank {rank} sharded_coarse_to_fine", counts,
                 {"oft_pyramid": 2, "oft_lk": 1, "oft_pyrup_warp_lk": 1,
                  "oft_pyrup_warp_lk_tile": 2 * tiles, "oft_tile_copy": tiles})
    res["ctf_bit_equal"] = bool(torch.equal(u2, u0) and torch.equal(v2, v0))
    res["ctf_median_epe_px"] = float(torch.hypot(u2[8:-8, 8:-8] - SHIFT[0],
                                                 v2[8:-8, 8:-8] - SHIFT[1]).median())
    res["ms"]["sharded_coarse_to_fine"] = timed_ms(
        lambda: sharded_coarse_to_fine(a, b, mesh_sp, 4, config=cfg))
    res["ms"]["coarse_to_fine"] = timed_ms(lambda: coarse_to_fine(a, b, 4, config=cfg))

    # phase 13 (c)'s BA, its 8 shards over both ranks
    prob, _ = ba_scene()
    flat, _ = bundle_adjust(prob, iters=BA_ITERS, lam=BA_LAM, device=device)
    local_prob = local_points(prob, mesh.size)
    sol, _ = sharded_bundle_adjust(local_prob, mesh, iters=BA_ITERS, lam=BA_LAM)
    res["ba_rel_diff_vs_unsharded"] = max(rel_diff(sol.cams, flat.cams),
                                          rel_diff(sol.points, flat.points))
    sent = []
    for iters in (BA_ITERS, BA_ITERS + 1):
        reset_wire_counts()
        sharded_bundle_adjust(local_prob, mesh, iters=iters, lam=BA_LAM)
        sent.append(wire_counts()["bytes"])
    res["wire_bytes"]["ba_per_gn_iteration"] = sent[1] - sent[0]
    res["wire_bytes"]["ba_call"] = sent[0]
    res["ms"]["sharded_bundle_adjust"] = timed_ms(
        lambda: sharded_bundle_adjust(local_prob, mesh, iters=BA_ITERS, lam=BA_LAM))
    res["ms"]["bundle_adjust"] = timed_ms(
        lambda: bundle_adjust(prob, iters=BA_ITERS, lam=BA_LAM, device=device))
    ok = (res["lk_bit_equal"] and res["global_mean_diff"] < 1e-9 and res["ctf_bit_equal"]
          and res["ba_rel_diff_vs_unsharded"] <= 1e-8 and res["world"] == RANKS)
    torch.distributed.destroy_process_group()
    print("RANK_RESULT " + json.dumps(res), flush=True)
    if not ok:
        raise AssertionError(f"rank {rank}: {res}")
    return 0


def pyramid_graph_capture(device):
    """Whether the pyramid's grids (programmatic dependent launch between its
    levels) can be captured into a CUDA graph and replayed on new input
    (compared with the plain pyramid). Reported only: no path of the port
    relies on it."""
    import torch

    from optical_flow_tpu_torch.kernels.pyrdown_kernel import gaussian_pyramid_cuda
    from optical_flow_tpu_torch.ops.pyramid import gaussian_pyramid

    shape, levels = PYRAMID
    x = torch.rand(*shape, device=device) * 255.0
    try:
        side = torch.cuda.Stream(device)  # warm up off the capturing stream
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            gaussian_pyramid_cuda(x, levels)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = gaussian_pyramid_cuda(x, levels)
        x.copy_(torch.rand(*shape, device=device) * 255.0)
        graph.replay()
        torch.cuda.synchronize()
        want = gaussian_pyramid(x, levels, impl="poly")
        return {"captured": True,
                "replay_max_abs_err": max(float((a - b).abs().max()) for a, b in zip(out, want))}
    except Exception as e:  # a refusal is the answer, not a failure of the run
        return {"captured": False, "error": f"{type(e).__name__}: {e}"[:300]}


def ptx_ops(source, kernels):
    """{mangled kernel name: {floating-point PTX op: count}} for the kernels
    of csrc/`source` whose name contains one of `kernels`, compiled to PTX with the
    library's flags (the PTX is what -fmad and the .rn intrinsics decide;
    ptxas then only schedules it)."""
    import pathlib

    from optical_flow_tpu_torch.kernels import _lib

    flags = [f for f in _lib.NVCC_FLAGS if f != "-gencode" and not f.startswith("arch=")]
    out = _lib.BUILD_DIR / f"{pathlib.Path(source).stem}.ptx"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_lib._nvcc(), "-arch=compute_90a", *flags, "-ptx", "-o", str(out),
                    str(_lib.CSRC / source)], capture_output=True, text=True, check=True,
                   timeout=300)
    counts, name = {}, None
    for line in out.read_text().splitlines():
        m = re.search(r"\.entry\s+([\w$]+)", line)
        if m:
            name = m[1] if any(k in m[1] for k in kernels) else None
            if name:
                counts[name] = {}
        elif name:
            for op in re.findall(r"(?<![\w.])((?:fma|mul|add|sub|neg|cvt)\.[\w.]+)", line):
                if "f32" in op or "bf16" in op:
                    counts[name][op] = counts[name].get(op, 0) + 1
    return counts


def chain_lane(name):
    """The lane type of S4's kernel `name`: bf16x2 on the bfloat16 16-byte
    path, bf16 on its scalar path, f32."""
    m = re.search(r"mul_add_chain_kernelI(f|13__nv_bfloat16)Lb([01])E", name)
    return "f32" if m[1] == "f" else "bf16x2" if m[2] == "1" else "bf16"


def ptx_faults(ops, lane_of, cvt_ok=lambda lane: False):
    """The kernels of `ops` whose PTX would not round each multiply and add
    apart: {name: (fused or converting ops, required ops missing)}. Every
    kernel needs mul.rn and add.rn of its lanes' type, `lane_of(name)`, and
    may hold no fma, nor a conversion unless `cvt_ok(lane)`."""
    faults = {}
    for name, found in ops.items():
        lane = lane_of(name)
        wrong = sorted(op for op in found
                       if op.startswith("fma.") or (op.startswith("cvt.") and not cvt_ok(lane)))
        missing = sorted({f"mul.rn.{lane}", f"add.rn.{lane}"} - set(found))
        if wrong or missing:
            faults[name] = (wrong, missing)
    return faults


def sass_counts(lib_path, kernel, ops=SASS_OPS):
    """{mangled kernel name: {op: instructions}} over the SASS
    (`cuobjdump -sass`) of the built library's kernels whose name contains
    `kernel`, and {name: up to two lines of each FFMA/HFMA2 form}."""
    import pathlib

    from optical_flow_tpu_torch.kernels import _lib

    cuobjdump = pathlib.Path(_lib._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, forms, name = {}, {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m[1] if kernel in m[1] else None
            if name:
                counts[name], forms[name] = dict.fromkeys(ops, 0), {}
            continue
        if name is None:
            continue
        for op in ops:
            if re.search(rf"\b{op}[ .]", line):
                counts[name][op] += 1
        f = re.search(r"\b(?:FFMA|HFMA2)\S*", line)
        if f and len(forms[name].setdefault(f[0], [])) < 2:
            forms[name][f[0]].append(re.sub(r"\s+", " ", line.split(";")[0].split("*/")[-1]).strip())
    return counts, forms


# ------------------------------------ phase 18: native runtime and examples

NATIVE_START = 5  # (a): read_frames(start=) seeks the container to this frame
EXAMPLE_FRAMES = 8  # (b): frames of the clip the video examples read
SCALING_SIZE = 540  # (b): scaling_report's frame size (the JAX script's default)
# scale_drift's lines as the JAX package's examples/scale_drift.py prints
# them (its default arguments, JAX on the CPU); the script is deterministic
JAX_SCALE_DRIFT_LINES = [
    "drifted (gamma=0.93, 16 keyframes): mean center error 4.585, endpoint 10.398 "
    "(node scale decays to 0.34)",
    "SE(3) closure:  mean 4.864, endpoint 0.006 (no scale dof — the spiral survives)",
    "Sim(3) closure: mean 0.018, endpoint 0.009 (node scales lifted back to 1.00)",
    "SE(3) / Sim(3) mean-error ratio: 273x",
]
FLOAT_RE = r"[-+]?\d+\.\d+"


def write_clip(path, frames, fps=30.0):
    """BGR frames into an MPEG-4 part 2 .mp4 with cv2's VideoWriter
    (keyframes and predicted frames: a seek decodes from a keyframe)."""
    import cv2

    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise AssertionError(f"cv2 cannot write {path}")
    for f in frames:
        writer.write(f)
    writer.release()


def staged_ms(source, device):
    """io/prefetch.py's per-frame producer spans (chunks of one frame) in a
    ``profiling.trace()`` of one pass over ``source``, medians in ms:
    decode_ms (``prefetch.pull``: pulling the frame from the reader),
    put_ms (``upload.pin`` and ``upload.stage``: the pinned copy and the
    copy enqueued, on the worker's thread) and h2d_ms (the copy's HtoD
    interval on the card)."""
    import tempfile

    import torch

    from optical_flow_tpu_torch.io.prefetch import prefetch_chunks_to_device
    from optical_flow_tpu_torch.utils import profiling

    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d):
            for _ in prefetch_chunks_to_device(source, 1, device=device):
                pass
            torch.cuda.synchronize(device)
        with open(f"{d}/trace.json") as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = {}
    for e in events:
        name, _, ident = e["name"].partition("#")
        if name in ("prefetch.pull", "upload.pin", "upload.stage") and ident:
            spans.setdefault(name, {})[int(ident)] = e["dur"] / 1e3
    staged = sorted(spans.get("upload.stage", {}))
    h2d = [e["dur"] / 1e3 for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]]
    if not staged or len(h2d) < len(staged):
        raise AssertionError(f"the trace holds {len(staged)} staged frames, {len(h2d)} copies")
    return {"decode_ms": float(np.median([spans["prefetch.pull"][i] for i in staged])),
            "put_ms": float(np.median([spans["upload.pin"][i] + spans["upload.stage"][i]
                                       for i in staged])),
            "h2d_ms": float(np.median(h2d)), "frames": len(staged)}


def gray_against_cv2(gray, bgr_cv2):
    """The one-hop decode-time luma against cv2's BT.601 gray of cv2's BGR
    decode: tests/test_native.py's bar (mean < 2, median <= 1)."""
    import cv2

    d = np.concatenate([np.abs(g.astype(np.int32) - cv2.cvtColor(b, cv2.COLOR_BGR2GRAY))
                        .ravel() for g, b in zip(gray, bgr_cv2)])
    out = {"max": int(d.max()), "mean": float(d.mean()), "median": float(np.median(d))}
    if not (out["mean"] < 2.0 and out["median"] <= 1):
        raise AssertionError(f"native gray against cv2's gray: {out}")
    return out


def phase_native_decode(device, frames, clip):
    """(a): returns (its results, the launch counts of the pipeline run from
    the native reader), or (results, None) where pkg-config finds no libav."""
    import torch

    from optical_flow_tpu_torch import kernels, native
    from optical_flow_tpu_torch.config import VideoConfig
    from optical_flow_tpu_torch.io.video_reader import VideoReader, read_frames
    from optical_flow_tpu_torch.pipeline.video import VideoPipeline

    flags, missing = native.av_flags()
    versions = {}
    for p in native.AV_PACKAGES:
        r = subprocess.run(["pkg-config", "--modversion", p], capture_output=True, text=True) \
            if "pkg-config not found" not in missing else None
        versions[p] = r.stdout.strip() if r is not None and r.returncode == 0 else None
    out = {"pkg_config": {"flags": list(flags), "missing": list(missing), "versions": versions}}
    log(f"[18 a libav] {json.dumps(out['pkg_config'])}")
    write_clip(clip, frames)
    out["staged_ms"] = {  # cv2's reader needs no libav
        "cv2_bgr": staged_ms(VideoReader(clip, backend="cv2"), device),
        "cv2_gray": staged_ms(VideoReader(clip, backend="cv2", gray=True), device)}
    log(f"[18 a staged] {json.dumps(out['staged_ms'])}")
    if missing:
        log(json.dumps({"native": "unavailable", "missing": list(missing)}))
        return out, None
    t0 = time.perf_counter()
    lib_path = native.build()
    native.require_library()
    out["build"] = {"library": str(lib_path.relative_to(lib_path.parents[2])),
                    "s": time.perf_counter() - t0}
    F = len(frames)
    if VideoReader(clip).backend != "native":
        raise AssertionError("'auto' did not take the native decoder")
    bgr, bgr_cv2 = list(VideoReader(clip, backend="native")), list(VideoReader(clip, backend="cv2"))
    if len(bgr) != F or len(bgr_cv2) != F or not all(
            np.array_equal(a, b) for a, b in zip(bgr, bgr_cv2)):
        raise AssertionError("native BGR decode differs from cv2's")
    gray = list(VideoReader(clip, backend="native", gray=True))
    if len(gray) != F or gray[0].shape != FRAME_HW or gray[0].dtype != np.uint8:
        raise AssertionError("native gray decode: wrong count or shape")
    out["bgr_equal_to_cv2"] = True
    out["gray_vs_cv2_gray"] = gray_against_cv2(gray, bgr_cv2)
    for g, full in ((False, bgr), (True, gray)):
        seeked = list(read_frames(clip, start=NATIVE_START, gray=g))
        with native.NativeFramePipe(clip, start=NATIVE_START, gray=g) as pipe:
            direct = list(pipe)
        if not (len(seeked) == len(direct) == F - NATIVE_START and all(
                np.array_equal(a, b) and np.array_equal(a, c)
                for a, b, c in zip(seeked, direct, full[NATIVE_START:]))):
            raise AssertionError(f"seek to {NATIVE_START} (gray={g}) differs from decode-and-skip")
    out["seek"] = {"start": NATIVE_START, "equal_to_decode_and_skip": True}

    fast = VideoConfig.fast(size=(SIZE, SIZE))
    kernels.reset_launch_counts()
    got = list(VideoPipeline(fast, device=device).run(read_frames(clip), prefetch=2))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check_counts("native stream", counts,
                 {"oft_pyramid": F - 1, "oft_lk": F - 2, "oft_pyrup_warp_lk": 3 * (F - 2),
                  "oft_diff_features": F - 1})
    same_results("native stream against cv2-decoded frames",
                 got, list(VideoPipeline(fast, device=device).run(bgr_cv2, prefetch=2)))
    got_gray = list(VideoPipeline(fast, device=device).run(read_frames(clip, gray=True),
                                                           prefetch=2))
    same_results("native gray stream against its frames pushed",
                 got_gray, list(VideoPipeline(fast, device=device).run(gray, prefetch=0)))
    # the luma path against the BGR path: one-hop luma moves gray by a
    # level or so, so the flows part by that (reported)
    d = torch.cat([torch.hypot(a.u - b.u, a.v - b.v).flatten() for a, b in zip(got_gray, got)])
    out["pipeline"] = {
        "launches": counts, "equal_to_cv2": True, "gray_equal_to_pushed": True,
        "gray_vs_bgr_flow": {"median": float(d.median()), "q99": float(torch.quantile(
            d.double().cpu(), 0.99)), "votes": [(int(a.gesture.votes), int(b.gesture.votes))
                                                 for a, b in zip(got_gray, got)]}}
    out["staged_ms"].update(native_bgr=staged_ms(read_frames(clip), device),
                            native_gray=staged_ms(read_frames(clip, gray=True), device))
    decode = {}
    for name, make in (("native_bgr", lambda: VideoReader(clip, backend="native")),
                       ("cv2_bgr", lambda: VideoReader(clip, backend="cv2")),
                       ("native_gray", lambda: VideoReader(clip, backend="native", gray=True)),
                       ("cv2_gray", lambda: VideoReader(clip, backend="cv2", gray=True))):
        spans = []
        for _ in range(3):
            t0 = time.perf_counter()
            n = sum(1 for _ in make())
            spans.append((time.perf_counter() - t0) / n * 1e3)
        decode[name] = spans
    out["decode_ms_per_frame"] = decode
    log(f"[18 a native decode] {json.dumps(out)}")
    return out, counts


def run_example(name, argv, transcript):
    """The port's example ``name`` in process through main(argv): (stdout
    lines, wall seconds); its lines go to ``transcript``; a non-zero exit
    raises."""
    import contextlib
    import importlib
    import io

    import torch

    mod = importlib.import_module(f"optical_flow_tpu_torch.examples.{name}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    transcript.write(f"$ {name} {' '.join(argv)}\n" + "\n".join(lines) + f"\n(exit {rc}, {s:.2f} s)\n")
    if rc != 0:
        raise AssertionError(f"example {name} exited {rc}: {lines[-5:]}")
    return lines, s


def _floats(line):
    return [float(x) for x in re.findall(FLOAT_RE, line)]


def _line(lines, prefix):
    return next(x for x in lines if x.startswith(prefix))


def phase_examples(device, clip, work):
    """(b): every example on the card, in process; returns each one's
    seconds, launch counts and checks."""
    import torch

    from optical_flow_tpu_torch import kernels
    from optical_flow_tpu_torch.config import VideoConfig
    from optical_flow_tpu_torch.examples.vi_odometry import make_scene
    from optical_flow_tpu_torch.io.video_reader import read_frames
    from optical_flow_tpu_torch.pipeline.serve import FlowServer
    from optical_flow_tpu_torch.pipeline.video import VideoPipeline
    from optical_flow_tpu_torch.utils.goldens import reference_dir

    F = EXAMPLE_FRAMES
    stream = {"oft_pyramid": F - 1, "oft_lk": F - 2, "oft_pyrup_warp_lk": 3 * (F - 2),
              "oft_diff_features": F - 1}
    logs = pathlib_root() / "chiprun_out"
    logs.mkdir(exist_ok=True)
    out, counts_by_key = {}, {}
    with open(logs / "phase18_examples.log", "w") as transcript:
        def run(key, name, argv, want_counts=None, must_launch=()):
            kernels.reset_launch_counts()
            lines, s = run_example(name, argv, transcript)
            counts = kernels.launch_counts()
            if want_counts is not None:
                check_counts(key, counts, want_counts)
            if any(counts[k] == 0 for k in must_launch):
                raise AssertionError(f"{key} launched none of {must_launch}: {counts}")
            out[key] = {"s": s, "launches": {k: v for k, v in counts.items() if v}}
            counts_by_key[key] = counts
            return lines

        clip_args = ["--input", str(clip)]
        lines = run("video_gesture", "video_gesture", clip_args + [
            "--frames", str(F), "--size", str(SIZE), "--fast"], stream)
        if sum(x.startswith("frame ") for x in lines) != F - 2:
            raise AssertionError(f"video_gesture printed {lines}")
        lines = run("live_gesture", "live_gesture", clip_args + [
            "--frames", str(F), "--size", str(SIZE)], stream)
        pipe = VideoPipeline(VideoConfig.fast(size=(SIZE, SIZE)), device=device)
        direct = [r.gesture for r in (pipe.push(f) for f in read_frames(clip, max_frames=F))
                  if r is not None]
        want = [f"frame {n:4d} {'GESTURE' if bool(g.detected) else '       '} votes="
                f"{int(g.votes):5d} centroid=({float(g.cx):6.1f},{float(g.cy):6.1f})"
                for n, g in enumerate(direct, start=1)]
        if lines[:-1] != want:
            raise AssertionError(f"live_gesture's lines are not the direct push's: {lines}")
        for name in ("trajectory", "stabilize", "sparse_track"):
            lines = run(name, name, clip_args + ["--frames", "6"], must_launch=("oft_pyramid",))
        lines = run("pair_scrub", "pair_scrub", clip_args + [
            "--script", "fbq", "--max-frames", "4", "--outdir", str(work / "scrub")],
            must_launch=("oft_pyramid",))
        if sorted(p.name for p in (work / "scrub").iterdir()) != ["pair_0000.png", "pair_0001.png"]:
            raise AssertionError("pair_scrub wrote the wrong files")

        srv = FlowServer(port=0, device=device)
        srv.start_background()
        try:
            host, port = srv.address
            lines = run("serve_stream", "serve_stream", clip_args + [
                "--host", host, "--port", str(port), "--frames", str(F), "--size", str(SIZE)],
                must_launch=("oft_pyramid", "oft_lk", "oft_pyrup_warp_lk"))
        finally:
            srv.shutdown()
        replies = [json.loads(x) for x in lines]
        served = [r for r in replies[1:-1] if r.get("votes") is not None]
        if replies[-1] != {"end": True, "frames": F} or len(served) != len(direct) or any(
                (r["votes"], r["detected"], r["cx"], r["cy"]) != (
                    int(g.votes), bool(g.detected), float(g.cx), float(g.cy))
                for r, g in zip(served, direct)):
            raise AssertionError(f"serve_stream's replies are not the direct push's: {lines}")

        lines = run("scaling_report", "scaling_report", ["--size", str(SCALING_SIZE),
                                                         "--iters", "4"],
                    must_launch=("oft_pyrup_warp_lk_tile", "oft_tile_copy"))
        if not lines[-1].endswith(": OK"):
            raise AssertionError(f"scaling_report: {lines[-1]}")
        out["scaling_report"]["lines"] = lines

        lines = run("scale_drift", "scale_drift", [])
        if lines != JAX_SCALE_DRIFT_LINES:
            raise AssertionError(f"scale_drift's lines are not the JAX script's: {lines}")
        lines = run("sfm_demo", "sfm_demo", ["--frames", "4"], must_launch=("oft_pyramid",))
        before, after = _floats(lines[1])
        txs = np.array([_floats(x)[1] for x in lines if x.startswith("cam ")])
        txs = txs * np.sign(txs[-1])
        steps = np.diff(txs)
        if not (after <= before + 1e-3 and after < 3.0 and np.all(steps > 0)
                and steps.max() / max(steps.min(), 1e-9) < 1.8):
            raise AssertionError(f"sfm_demo outside tests/test_epipolar.py's bars: {lines}")
        out["sfm_demo"]["rmse"] = [before, after]
        lines = run("loop_closure", "loop_closure", ["--frames", "8"], must_launch=("oft_pyramid",))
        end0, end1 = _floats(_line(lines, "endpoint error"))
        mean0, mean1 = _floats(_line(lines, "mean center error"))
        if not (end1 < 0.5 * end0 and mean1 < mean0):
            raise AssertionError(f"loop_closure outside tests/test_pose_graph.py's bars: {lines}")
        out["loop_closure"]["endpoint"], out["loop_closure"]["mean"] = [end0, end1], [mean0, mean1]
        lines = run("stereo_slam", "stereo_slam", ["--frames", "6"], must_launch=("oft_pyramid",))
        mono, stereo = _floats(_line(lines, "monocular:")), _floats(_line(lines, "stereo:"))
        m = re.search(r"stereo map: (\d+) landmarks, median depth (" + FLOAT_RE + ")", lines[-1])
        if not (mono[-1] < 0.05 and stereo[0] < 0.05 and int(m[1]) >= 50
                and 3.0 < float(m[2]) < 12.0):
            raise AssertionError(f"stereo_slam outside tests/test_stereo_slam.py's bars: {lines}")
        out["stereo_slam"]["centre_error"] = {"mono_fit": mono[-1], "stereo_raw": stereo[0]}
        span = float(np.linalg.norm(make_scene()["centers"], axis=1).max())
        for argv in (["--vis-noise", "0"], ["--vis-noise", "0", "--bias-drift"]):
            key = "vi_odometry" + ("_bias_drift" if "--bias-drift" in argv else "")
            lines = run(key, "vi_odometry", argv)
            vals = {k.strip(): v for k, v in (x.split(":", 1) for x in lines if ":" in x)}
            if key == "vi_odometry":
                scale = float(vals["alignment-recovered scale"])
                _, joint = _floats(vals["mean |center err| metric"])
                final = _floats(vals["final trajectory scale"])[0]
                if not (abs(scale - 3.0) / 3.0 < 0.05 and joint < 0.03 * span
                        and abs(final - 1.0) < 0.03):
                    raise AssertionError(f"vi_odometry outside tests/test_vi_ba.py's bars: {lines}")
                out[key].update(scale=scale, centre_error=joint, final_scale=final)
            else:
                err_f = _floats(vals["frozen-bias (9-DOF)  err"])[0]
                err_b = _floats(vals["bias-state (15-DOF)  err"])[0]
                if not (err_f > 2.0 * err_b and err_b < 0.03 * span):
                    raise AssertionError(f"vi_odometry --bias-drift outside "
                                         f"tests/test_vi_ba_bias_states.py's bars: {lines}")
                out[key].update(frozen=err_f, bias_states=err_b)
        if reference_dir() is not None:
            run("still_regression", "still_regression", ["--f32"])
        else:
            out["still_regression"] = "skipped: no reference checkout (OPTICAL_FLOW_REFERENCE_DIR)"
    log(f"[18 b examples] {json.dumps(out)}")
    log("  seconds: " + ", ".join(f"{k} {v['s']:.2f}" for k, v in out.items()
                                  if isinstance(v, dict)))
    return out, counts_by_key


def pathlib_root():
    import pathlib

    return pathlib.Path(__file__).resolve().parent


def phase_native(device, frames, ranks):
    """Phase 18: (a) native decode, (b) the examples, (c) the backend the
    one-card launch of phase 17 (c) chose. Its files go under the
    checkout's git-ignored build/phase18/, deleted after. Returns the
    native stream's (None without libav) and scaling_report's launch
    counts."""
    import shutil
    import socket

    work = pathlib_root() / "build" / "phase18"
    work.mkdir(parents=True, exist_ok=True)
    clip = work / "clip.mp4"
    try:
        t0 = time.perf_counter()
        dec, native_counts = phase_native_decode(device, frames, clip)
        t_a = time.perf_counter() - t0
        ex, ex_counts = phase_examples(device, clip, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    backends = sorted({r["backend"] for r in ranks})
    if backends != ["gloo"]:
        raise AssertionError(f"two ranks on one card chose {backends}, not gloo")
    log(f"[18 c backend] two ranks on one card ({socket.gethostname()}, "
        f"{len(ranks)} ranks, 1 card): {backends[0]}")
    log(f"  18 (a) {t_a:.1f} s, (b) {sum(v['s'] for v in ex.values() if isinstance(v, dict)):.1f} s")
    return native_counts, ex_counts["scaling_report"]


# ------------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this check needs a GPU")
    from optical_flow_tpu_torch.kernels import _lib
    from optical_flow_tpu_torch.utils.profiling import Cost, stage_roofline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[1 device] {kind}; count {torch.cuda.device_count()}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")

    t0 = time.perf_counter()
    path = _lib.build()
    _lib.library()
    log(f"[2 build] {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in _lib.ptxas_info("warp_lk_kernel"):
        m = re.search(r"warp_lk_kernelILb(\d)ELb(\d)ELi(\d+)E", line)
        log(f"  ptxas warp_lk_kernel<pyrup={m[1]}, tile={m[2]}, rows={m[3]}>: {line.split(': ', 1)[1]}"
            if m else f"  ptxas {line}")
    for line in _lib.ptxas_info("lk_strip_kernel"):
        m = re.search(r"lk_strip_kernelILi(\d+)ELi(\d+)ELb(\d)E", line)
        log(f"  ptxas lk_strip_kernel<rows={m[1]}, cols={m[2]}, vec={m[3]}>: "
            f"{line.split(': ', 1)[1]}" if m else f"  ptxas {line}")
    for line in _lib.ptxas_info("pyrup_strip_kernel"):
        m = re.search(r"pyrup_strip_kernelILi(\d+)ELb(\d)E", line)
        log(f"  ptxas pyrup_strip_kernel<rows={m[1]}, quad={m[2]}>: {line.split(': ', 1)[1]}"
            if m else f"  ptxas {line}")
    for line in _lib.ptxas_info("remap_pair_kernel"):
        m = re.search(r"remap_pair_kernelI(\w+?)Li(\d)ELb(\d)E", line)
        log(f"  ptxas remap_pair_kernel<{'uint8' if m and m[1] == 'h' else 'float'}, vec={m[2]}, "
            f"quantize={m[3]}>: {line.split(': ', 1)[1]}" if m else f"  ptxas {line}")
    for line in _lib.ptxas_info("diff_features_kernel"):
        m = re.search(r"diff_features_kernelI(\w)Lb(\d)ELi(\d)E", line)
        log(f"  ptxas diff_features_kernel<{'uint8' if m and m[1] == 'h' else 'float'}, "
            f"saturate={m[2]}, r={m[3]}>: {line.split(': ', 1)[1]}" if m else f"  ptxas {line}")
    for kernel in ("pyrdown_kernel", "tile_copy", "interleave", "colsum", "mul_add_chain"):
        for line in _lib.ptxas_info(kernel):
            log(f"  ptxas {line}")
    # S4 must round every multiply and add apart, as its PTX says; the SASS
    # is printed beside it (ptxas issues part of the packed bf16 multiplies
    # and adds as HFMA2.MMA with a zero addend or a multiplier of one)
    probe_ptx = ptx_ops("probes.cu", ("mul_add_chain", "colsum"))
    ptx = {k: c for k, c in probe_ptx.items() if "mul_add_chain" in k}
    sass, forms = sass_counts(path, "mul_add_chain")
    for name, c in ptx.items():
        log(f"  ptx {name}: {json.dumps(c)}")
    for name, c in sass.items():
        log(f"  sass {name}: {json.dumps(c)} {json.dumps(forms[name])}")
    faults = ptx_faults(ptx, chain_lane, cvt_ok=lambda lane: lane == "f32")
    if len(ptx) != 8 or faults:
        raise AssertionError(f"S4's PTX: {len(ptx)} kernels of 8, faults (fused or converting "
                             f"ops, ops missing): {faults}")
    # S3 must round every product and sum apart too, its weights folded
    ptx = {k: c for k, c in probe_ptx.items() if "colsum" in k}
    for name, c in ptx.items():
        log(f"  ptx {name}: {json.dumps(c)}")
    faults = ptx_faults(ptx, lambda name: "f32")
    if len(ptx) != 4 or faults:
        raise AssertionError(f"S3's PTX: {len(ptx)} kernels of 4, faults (fused or converting "
                             f"ops, ops missing): {faults}")

    per_kernel = phase_kernels(device)
    log("[3 kernels] all kernels agree with their plain versions")

    rng = np.random.RandomState(SEED)
    frames = synthetic_frames(rng, FRAMES, FRAME_HW)
    sl, stream_results = phase_slice(device, frames, SIZE)
    log(f"[4 slice] {json.dumps(sl)}")
    ctl = phase_controller(device, SIZE)
    log(f"[5 controller] {json.dumps(ctl)}")
    from optical_flow_tpu_torch.config import VideoConfig

    fast = VideoConfig.fast(size=(SIZE, SIZE))
    for graph, mode in ((False, "eager"), (True, "graph")):
        prof = phase_profile(device, fast, f"profile_slice_{mode}.json", graph)
        log(f"[6 profile, {mode}] {json.dumps(prof)}")
    msl = phase_mesh_slice(device, frames, SIZE, stream_results)
    log(f"[7 mesh slice] {json.dumps(msl)}")
    mctl = phase_mesh_controller(device, SIZE)
    log(f"[8 mesh controller] {json.dumps(mctl)}")
    ref, ref_results = phase_reference(device, frames)
    log(f"[9 reference slice] {json.dumps(ref)}")
    for graph, mode in ((False, "eager"), (True, "graph")):
        prof = phase_profile(device, VideoConfig(), f"profile_reference_{mode}.json", graph,
                             n=REFERENCE_PROFILE_FRAMES)
        log(f"[9 reference profile, {mode}] {json.dumps(prof)}")
    prb = phase_probes(device)
    log(f"[10 probes] {json.dumps(prb)}")
    floor = {"tile_copy": per_kernel["tile_copy"]["device_ms"],
             "clone": per_kernel["tile_copy"]["library_ms"]}
    for name in ("interleave", "colsum", "mul_add_chain"):
        for v, t in prb["ms"][name].items():
            log(f"  {name} {v}: {t * 1e3:.2f} us; launch floor: P1 {floor['tile_copy'] * 1e3:.2f} us, clone "
                f"{floor['clone'] * 1e3:.2f} us")
    host = phase_host_path(device, frames, {"fast": (stream_results, sl["launches"]),
                                            "reference": (ref_results, ref["launches"])})
    log(f"[11 host path] {json.dumps(host)}")
    trk, track_counts, shift_counts = phase_tracking(device, frames, SIZE)
    log("[12 tracking] the sparse-tracking path, Horn-Schunck and the 'shift' warp pass")
    t13 = time.perf_counter()
    sfm, sfm_counts = phase_sfm(device)
    log(f"[13 sfm] structure from motion passes ({time.perf_counter() - t13:.1f} s)")
    t14 = time.perf_counter()
    mapper, slam_counts, stereo_counts, k3_c12, maps = phase_slam(device)
    log(f"[14 slam] the mapper passes ({time.perf_counter() - t14:.1f} s)")
    t15 = time.perf_counter()
    _, vi_counts, slam_imu_counts = phase_vi(device, maps)
    log(f"[15 vi] the visual-inertial back end passes ({time.perf_counter() - t15:.1f} s)")
    del maps
    t16 = time.perf_counter()
    _, serve_counts, serve_faithful_counts, serve_mesh_counts = phase_serve(device, frames)
    log(f"[16 serve] the served path passes ({time.perf_counter() - t16:.1f} s)")
    t17 = time.perf_counter()
    sharded, ranks_counts = phase_sharded(device)
    log(f"[17 sharded] the sharded solvers, two ranks on the card and dryrun_multichip pass "
        f"({time.perf_counter() - t17:.1f} s)")
    t18 = time.perf_counter()
    native_counts, scaling_counts = phase_native(device, frames, sharded["c"])
    log(f"[18 native] the native runtime{'' if native_counts else ' (no libav: (a) skipped)'}, "
        f"the examples and the backend choice pass ({time.perf_counter() - t18:.1f} s)")
    del sharded
    per_kernel["pyrup_warp_lk"]["by_shape"] += k3_c12
    del stream_results, ref_results
    per_kernel["pyramid"]["graph_capture"] = pyramid_graph_capture(device)
    log(f"  pyramid graph capture: {json.dumps(per_kernel['pyramid']['graph_capture'])}")

    # Each count comes from one run, its counters reset just before it: the
    # streaming VideoPipeline.push run (phase 4) drives K2-K3, K4 runs on the
    # controller path, coarse_to_fine with level_iters=2 (phase 5), K5's K3
    # mode and P1 on the mesh stream (phase 7), K5's K4 mode on the mesh
    # controller with level_iters=2 (phase 8), K1 at all four levels, S1 and
    # W1 on the reference stream (phase 9; phase 3 times K1 at those four
    # shapes), and the probes S2-S4 in their own run (phase 10).
    meta = {
        "lk": (("oft_lk",), "reference", "optical_flow_tpu_torch/kernels/csrc/lk.cu",
               "optical_flow_tpu/kernels/lk_kernel.py:173"),
        # K2: every path calls it as oft_pyramid, one count a pyramid
        "pyramid": (("oft_pyramid",), "stream", "optical_flow_tpu_torch/kernels/csrc/pyrdown.cu",
                    "optical_flow_tpu/kernels/pyrdown_kernel.py:146"),
        "pyrup_warp_lk": (("oft_pyrup_warp_lk",), "stream",
                          "optical_flow_tpu_torch/kernels/csrc/warp_lk.cu",
                          "optical_flow_tpu/kernels/warp_lk_kernel.py:667"),
        "warp_lk": (("oft_warp_lk",), "controller",
                    "optical_flow_tpu_torch/kernels/csrc/warp_lk.cu",
                    "optical_flow_tpu/kernels/warp_lk_kernel.py:370"),
        "pyrup_warp_lk_tile": (("oft_pyrup_warp_lk_tile",), "mesh_stream",
                               "optical_flow_tpu_torch/kernels/csrc/warp_lk.cu",
                               "optical_flow_tpu/kernels/warp_lk_kernel.py:667"),
        "warp_lk_tile": (("oft_warp_lk_tile",), "mesh_controller",
                         "optical_flow_tpu_torch/kernels/csrc/warp_lk.cu",
                         "optical_flow_tpu/kernels/warp_lk_kernel.py:370"),
        "tile_copy": (("oft_tile_copy",), "mesh_stream",
                      "optical_flow_tpu_torch/kernels/csrc/tile_copy.cu",
                      "optical_flow_tpu/parallel/vma_compat.py:44"),
        "pyrup": (("oft_pyrup",), "reference", "optical_flow_tpu_torch/kernels/csrc/pyrup.cu",
                  "scripts/tpu_pyrup_poc.py:40"),
        "remap": (("oft_remap",), "reference", "optical_flow_tpu_torch/kernels/csrc/remap.cu",
                  "none (the JAX warp, optical_flow_tpu/ops/warp.py:50, is an XLA gather)"),
        "features": (("oft_diff_features",), "stream",
                     "optical_flow_tpu_torch/kernels/csrc/features.cu",
                     "none (the JAX diff_features, optical_flow_tpu/pipeline/preprocess.py, is "
                     "fused by XLA)"),
        "interleave": (("oft_interleave_cols_f2", "oft_interleave_cols_smem", "oft_interleave_rows"),
                       "probes", "optical_flow_tpu_torch/kernels/csrc/probes.cu",
                       "scripts/tpu_interleave_poc.py:76"),
        "colsum": (("oft_colsum_smem", "oft_colsum_shfl"), "probes",
                   "optical_flow_tpu_torch/kernels/csrc/probes.cu", "scripts/tpu_roll_micro.py:40"),
        "mul_add_chain": (("oft_mul_add_chain_f32", "oft_mul_add_chain_bf16"), "probes",
                          "optical_flow_tpu_torch/kernels/csrc/probes.cu",
                          "scripts/tpu_vpu_rate_probe.py:49"),
    }
    runs = {"stream": sl["launches"], "controller": ctl["launches"],
            "mesh_stream": msl["launches"], "mesh_controller": mctl["launches"],
            "reference": ref["launches"], "probes": prb["launches"],
            "track": track_counts, "shift_controller": shift_counts, "sfm": sfm_counts,
            "slam": slam_counts, "stereo": stereo_counts, "vi": vi_counts,
            "slam_imu": slam_imu_counts, "serve": serve_counts,
            "serve_faithful": serve_faithful_counts, "serve_mesh": serve_mesh_counts,
            "ranks": ranks_counts,
            "native": native_counts, "scaling_report": scaling_counts}
    # a run that did not take place (phase 18 (a) without libav) counts None,
    # printed as null beside the reason, never as zeros
    skipped = {} if native_counts else {"native": "not run: pkg-config found no libav, so "
                                                  "phase 18 (a) was skipped"}
    missing = [name for name, (entries, run, _, _) in meta.items()
               if any(runs[run][e] == 0 for e in entries)]
    if missing:
        raise AssertionError(f"kernels never launched on their path: {missing}")
    # phase 12's runs: K2 builds the tracking pyramids, K1 solves each level
    # of the 'shift' controller
    if not (runs["track"]["oft_pyramid"] > 0 and runs["shift_controller"]["oft_lk"] > 0):
        raise AssertionError(f"phase 12 launched no K2 / K1: {runs['track']}, "
                             f"{runs['shift_controller']}")
    # phase 13's run: K2 builds both tracking pyramids of every link
    if runs["sfm"]["oft_pyramid"] != 2 * (SFM_FRAMES - 1):
        raise AssertionError(f"phase 13 launched K2 {runs['sfm']['oft_pyramid']} times")
    # phase 14's runs: K2 builds every tracking pyramid of the mapper (its
    # exact count is asserted in the phase: each frame once, then the loop
    # closures'), K1 and K3 (at C = 12) solve the dense disparity
    want_k2 = mapper_k2(SLAM_FRAMES, len(mapper["a"]["card"]["keyframes"]),
                        len(mapper["a"]["card"]["loop_edges"]), SLAM_KW["loop_min_separation"])
    if not (runs["slam"]["oft_pyramid"] == want_k2 and runs["stereo"]["oft_lk"] > 0
            and runs["stereo"]["oft_pyrup_warp_lk"] > 0):
        raise AssertionError(f"phase 14 launched K2 {runs['slam']['oft_pyramid']} times (want "
                             f"{want_k2}), dense disparity {runs['stereo']}")
    # phase 15's runs: the IMU functions and VI-BA launch no kernel; slam
    # --imu launches K2 as the mapper does (exactly, asserted in the phase)
    if any(runs["vi"].values()) or not runs["slam_imu"]["oft_pyramid"]:
        raise AssertionError(f"phase 15 launches: VI {runs['vi']}, slam --imu {runs['slam_imu']}")
    # phase 16's runs: a served fast stream launches what phase 4's does (K2,
    # K1, K3, exactly, asserted in the phase), a faithful one K1, S1 and W1,
    # a mesh-served one what phase 7's does (K5, P1)
    if runs["serve"] != runs["stream"] or runs["serve_mesh"] != runs["mesh_stream"] or not (
            runs["serve_faithful"]["oft_lk"] and runs["serve_faithful"]["oft_pyrup"]
            and runs["serve_faithful"]["oft_remap"]):
        raise AssertionError(f"phase 16 launches: {runs['serve']}, {runs['serve_faithful']}, "
                             f"{runs['serve_mesh']}")

    # the probes' own rows: the first variant's time; all variants beside it
    first = {"interleave": "cols_float2", "colsum": "smem", "mul_add_chain": "f32"}
    for name, v0 in first.items():
        errs = {k.split("/", 1)[1]: e for k, e in prb["max_abs_err"].items() if k.startswith(name)}
        per_kernel[name] = {
            "max_abs_err": max(errs.values()), "ms": prb["ms"][name][v0],
            "plain_ms": prb["plain_ms"][name], "library_ms": prb["library_ms"][name],
            "device_ms": prb["ms"][name][v0],
            "bytes": prb["cost"][name]["bytes"], "ops": prb["cost"][name]["ops"],
            "variants": prb["ms"][name]}
        for key in ("plain_ms_by_variant", "library_ms_by_variant"):
            if name in prb[key]:
                per_kernel[name][key] = prb[key][name]
        per_kernel[name]["launch_floor_ms"] = floor
    # K2 has one row, the pyramid call of the paths (one count a call, one
    # grid a level below the input). Phase 3's single levels (oft_pyrdown,
    # the same kernel as one grid, called by no path) stand in its by_shape
    # and sweep, marked by their entry, and so does the tracking pyramid of
    # phase 12 (path "track"); its totals are the 1080^2 pyramid call's.
    single = per_kernel.pop("pyrdown")
    track = per_kernel.pop("pyramid_track")
    k2 = per_kernel["pyramid"]
    k2["max_abs_err"] = max(k2["max_abs_err"], single["max_abs_err"], track["max_abs_err"])
    k2["by_shape"] += track["by_shape"]
    k2["by_shape"] += [dict(b, entry="oft_pyrdown", levels=2) for b in single["by_shape"]]
    k2["sweep"] += [dict(c, entry="oft_pyrdown", levels=2) for c in single["sweep"]]
    k2["grids_per_call"] = PYRAMID[1] - 1
    # F1 has one row, the fast frame's float32 call; the faithful frame's
    # uint8 call and the chunks of 16 stand in its by_shape, marked
    f1 = per_kernel["features"]
    f1["by_shape"][0].update(dtype="float32", batch=1)
    for name, dtype, batch in (("features_u8", "uint8", 1), ("features_b16", "float32", 16),
                               ("features_u8_b16", "uint8", 16)):
        extra = per_kernel.pop(name)
        f1["max_abs_err"] = max(f1["max_abs_err"], extra["max_abs_err"])
        f1["by_shape"] += [dict(b, dtype=dtype, batch=batch) for b in extra["by_shape"]]
    sustained = {"bytes_per_s": prb["sustained"]["copy_bytes_per_s"],
                 "ops_per_s": {torch.float32: prb["sustained"]["f32_ops_per_s"]}}
    rows = []
    for name, (entries, run, source, replaces) in meta.items():
        r = per_kernel[name]
        # shares of the device time, where it was measured (not K5's)
        roof = stage_roofline(Cost(r["bytes"], r["ops"]), r["device_ms"], rates=sustained)
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": sum(runs[run][e] for e in entries), "run": RUNS[run],
               "launches_by_run": {k: None if c is None else sum(c[e] for e in entries)
                                   for k, c in runs.items()},
               "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
               "bound_ms": roof["bound_ms"], "bound_by": roof["bound_by"],
               "library_ms": r["library_ms"], "device_ms": r["device_ms"],
               "share_of_bound": roof.get("share_of_bound"),
               "sustained_ms": roof["sustained_ms"], "sustained_by": roof["sustained_by"],
               "share_of_sustained": roof.get("share_of_sustained")}
        for key in ("max_abs_err_unmasked", "device_ms_runs", "library_ms_runs", "sweep",
                    "graph_capture", "grids_per_call", "plain_ms_by_variant",
                    "library_ms_by_variant", "launch_floor_ms"):
            if key in r:
                row[key] = r[key]
        if skipped:
            row["runs_skipped"] = skipped
        if len(entries) > 1:
            row["launches_by_entry"] = {e: runs[run][e] for e in entries}
            row["variants_ms"] = r["variants"]
        if "by_shape" in r:
            row["by_shape"] = [dict(b, bound_ms=stage_roofline(Cost(b["bytes"], b["ops"]))["bound_ms"])
                               for b in r["by_shape"]]
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def main_phase18() -> int:
    """Phase 18 alone (``python3 chip_smoke.py --phase18``): the device line,
    the kernels' build, phase 17 (c)'s two ranks for (c), then phase 18."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this check needs a GPU")
    from optical_flow_tpu_torch.kernels import _lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"[1 device] {kind}; nvidia-smi: {smi.splitlines()[0]}")
    t0 = time.perf_counter()
    _lib.library()
    log(f"[2 build] {time.perf_counter() - t0:.1f} s")
    frames = synthetic_frames(np.random.RandomState(SEED), FRAMES, FRAME_HW)
    ranks = run_ranks()
    t18 = time.perf_counter()
    phase_native(device, frames, ranks)
    log(f"[18 native] passes ({time.perf_counter() - t18:.1f} s)")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase18"]:
        sys.exit(main_phase18())
    if sys.argv[1:2] == ["--rank"]:  # one rank of phase 17 (c), started by run_ranks
        sys.exit(rank_worker(int(sys.argv[2]), int(sys.argv[3])))
    if sys.argv[1:2] == ["--gloo-send"]:  # one rank of gloo_cuda_send
        sys.exit(gloo_send_worker(int(sys.argv[2]), int(sys.argv[3])))
    sys.exit(main())
