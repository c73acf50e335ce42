#!/usr/bin/env python3
"""Drive the PyTorch port's streaming 1080^2 flow paths (the fast preset,
unsharded and on a 2x2 tile mesh, and the reference-parity default
configuration), the sparse tracker, Horn-Schunck, the exact 'shift' warp and
structure from motion once on an NVIDIA GPU, and run the probes S2-S4.

    python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits non-zero):
  1. device: the card's name and its nvidia-smi name/power-limit line;
  2. build: compile the CUDA kernels from optical_flow_tpu_torch/kernels/csrc,
     and print what the compiler allotted K1-K5, S1 and P1 (registers,
     spills);
  3. each kernel against its plain PyTorch version at the shapes of the main
     path, float32, with its tolerance, timed with CUDA events in turns
     (plain, kernel, kernel, plain) after warm-up, and by its device time
     on use-once inputs; K5 (the tile mode of K3 and K4) on the 2x2 tile
     grid of the mesh path, also against the full-frame kernel's region
     (max |err| must be 0), timed as one frame's four tiles; K1 and K3-K5
     held to max |err| 0 (the unmasked max |err| printed beside it), K3-K5
     also over a ragged and C sweep (shapes that leave partial blocks, C =
     1, 4, 8), K1 over a ragged sweep on both sides of its launcher's
     strip rule;
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
     between them) and once with FlowConfig(impl='torch'), flows and votes
     compared, exact launch counts; the card's uint8 gray against the CPU's;
     then phase 6's profiles of the kernel path in this configuration
     (chiprun_out/profile_reference_{eager,graph}.json);
 10. the probes S2-S4 on use-once inputs, device time of back-to-back
     launches (utils/profiling.time_use_once), each against its plain
     version bit for bit, with the copy and elementwise rates they measure
     at their own shapes, and the plain version and library call of each
     variant where they differ (S2's rows, S4 in bfloat16); then the copy rate (S2) and float32 elementwise
     rate (S4) that the card sustains at sizes that fill it many times over;
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
     eigh of the float64 normal matrices).
Phase 3 also holds S1 at the three upsamples of a 1080^2 frame, and over
a ragged sweep at odd and even coarse widths on both sides of its
launcher's strip rule, bit for bit, and K1 at every level of the reference path, and times the one
PyTorch call that computes K2's and S1's function (cuDNN convolutions,
TF32 off; the pyramid's: one a level). At the end, whether the pyramid's
grids (one a level, programmatic dependent launch) can be captured into a
CUDA graph (reported, not required). Launch counters are reset just before
the runs of phases 4, 5, 7, 8, 9, 10, 11 (c), 12 (a), 12 (d) and 13 (a) and
read just after each. Then one
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
S1_SWEEP = [(2, 135, 135), (270, 271), (1, 1), (1, 9), (9, 1), (2, 7, 5), (33, 64), (31, 130),
            (2, 17, 66), (540, 541), (537, 530), (543, 511), (8, 135, 136)]
# K3-K5 follow their plain versions operation for operation: held to 0 on the
# well-conditioned pixels (the unmasked max |err| is printed beside it)
ATOL_WARP_LK = 0.0
# the ragged and C sweep of K3-K5: shapes that leave partial blocks of the
# kernel's tiles (29 columns, 32 or 64 rows), at several tap reaches C (clamp
# 2C, flows scaled so that the quantized half-flow reaches +-C)
SWEEP_C = (1, 4, 8)
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
        "sfm": "multi_view_reconstruct, 8 frames of 720x1280 (phase 13 a)"}
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
    from optical_flow_tpu_torch.kernels.tile_copy_kernel import tile_copy_cuda, tile_copy_plain
    from optical_flow_tpu_torch.kernels.warp_lk_kernel import pyrup_coarse_halo
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
                 {"oft_pyramid": F - 1, "oft_lk": F - 2, "oft_pyrup_warp_lk": 3 * (F - 2)})
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
                  "oft_pyrup_warp_lk_tile": 2 * tiles * (F - 2), "oft_tile_copy": tiles})
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
    next prevDiff. Per result frame: K1 at the four levels, S1 three
    times. Once through the kernels and once with impl='torch' (the plain
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
    check_counts("reference slice", counts, {"oft_lk": 4 * (F - 2), "oft_pyrup": 3 * (F - 2)})
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
    with the plain versions come after."""
    import torch
    import torch.nn.functional as F

    from optical_flow_tpu_torch import kernels
    from optical_flow_tpu_torch.kernels import probes as P
    from optical_flow_tpu_torch.utils.profiling import Cost, kernel_cost, stage_roofline, time_use_once

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

    a, b = s2[0]
    (x,) = s3[0]
    n4 = int(np.prod(P.S4_SHAPE))
    cost = {
        "interleave": kernel_cost("interleave", [a, b], [want_c]),
        "colsum": kernel_cost("colsum", [x], [x], outputs_counted=x.numel() // x.shape[-1] * P.S3_WIN),
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

    def fresh(shape, lo, hi):
        return torch.empty(shape, device=device).uniform_(lo, hi, generator=gen)

    big = [(fresh(SUSTAINED_COPY_HW, 0.0, 1.0), fresh(SUSTAINED_COPY_HW, 0.0, 1.0))
           for _ in range(SUSTAINED_SETS + 1)]
    copy_ms = time_use_once(lambda a, b: P.interleave_cols_cuda(a, b, store="float2"), big, device)
    del big
    n_s, steps_s = SUSTAINED_CHAIN
    chains = [(fresh((n_s,), 0.5, 1.5), fresh((n_s,), 0.0, 1e-3)) for _ in range(SUSTAINED_SETS + 1)]
    chain_ms = time_use_once(lambda a, b: P.mul_add_chain_cuda(a, b, steps_s), chains, device)
    del chains
    sustained = {"copy_shape": list(SUSTAINED_COPY_HW), "copy_ms": copy_ms,
                 "copy_bytes_per_s": 4 * 4 * int(np.prod(SUSTAINED_COPY_HW)) / (copy_ms * 1e-3),
                 "chain": [n_s, steps_s], "chain_ms": chain_ms,
                 "f32_ops_per_s": 2 * steps_s * n_s / (chain_ms * 1e-3)}
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "launches": counts,
            "plain_ms_by_variant": plain_ms_by_variant,
            "library_ms_by_variant": library_ms_by_variant,
            "max_abs_err": {f"{k}/{v}": e for (k, v), e in errs.items()},
            "conv1d_max_abs_diff": conv_err, "rates_at_probe_shapes": rates, "sustained": sustained,
            "cost": {k: {"bytes": c.bytes, "ops": c.ops} for k, c in cost.items()},
            "bf16_chain_roofline": bf16}


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
                 {"oft_pyramid": 4, "oft_lk": 4, "oft_pyrup_warp_lk": 12})
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
    for kernel in ("pyrdown_kernel", "tile_copy"):
        for line in _lib.ptxas_info(kernel):
            log(f"  ptxas {line}")

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
    host = phase_host_path(device, frames, {"fast": (stream_results, sl["launches"]),
                                            "reference": (ref_results, ref["launches"])})
    log(f"[11 host path] {json.dumps(host)}")
    trk, track_counts, shift_counts = phase_tracking(device, frames, SIZE)
    log("[12 tracking] the sparse-tracking path, Horn-Schunck and the 'shift' warp pass")
    t13 = time.perf_counter()
    sfm, sfm_counts = phase_sfm(device)
    log(f"[13 sfm] structure from motion passes ({time.perf_counter() - t13:.1f} s)")
    del stream_results, ref_results
    per_kernel["pyramid"]["graph_capture"] = pyramid_graph_capture(device)
    log(f"  pyramid graph capture: {json.dumps(per_kernel['pyramid']['graph_capture'])}")

    # Each count comes from one run, its counters reset just before it: the
    # streaming VideoPipeline.push run (phase 4) drives K2-K3, K4 runs on the
    # controller path, coarse_to_fine with level_iters=2 (phase 5), K5's K3
    # mode and P1 on the mesh stream (phase 7), K5's K4 mode on the mesh
    # controller with level_iters=2 (phase 8), K1 at all four levels and S1
    # on the reference stream (phase 9; phase 3 times K1 at those four
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
            "track": track_counts, "shift_controller": shift_counts, "sfm": sfm_counts}
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
    sustained = {"bytes_per_s": prb["sustained"]["copy_bytes_per_s"],
                 "ops_per_s": {torch.float32: prb["sustained"]["f32_ops_per_s"]}}
    rows = []
    for name, (entries, run, source, replaces) in meta.items():
        r = per_kernel[name]
        # shares of the device time, where it was measured (not K5's)
        roof = stage_roofline(Cost(r["bytes"], r["ops"]), r["device_ms"], rates=sustained)
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": sum(runs[run][e] for e in entries), "run": RUNS[run],
               "launches_by_run": {k: sum(c[e] for e in entries) for k, c in runs.items()},
               "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
               "bound_ms": roof["bound_ms"], "bound_by": roof["bound_by"],
               "library_ms": r["library_ms"], "device_ms": r["device_ms"],
               "share_of_bound": roof.get("share_of_bound"),
               "sustained_ms": roof["sustained_ms"], "sustained_by": roof["sustained_by"],
               "share_of_sustained": roof.get("share_of_sustained")}
        for key in ("max_abs_err_unmasked", "device_ms_runs", "library_ms_runs", "sweep",
                    "graph_capture", "grids_per_call", "plain_ms_by_variant",
                    "library_ms_by_variant"):
            if key in r:
                row[key] = r[key]
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


if __name__ == "__main__":
    sys.exit(main())
