#!/usr/bin/env python3
"""Drive the PyTorch port's streaming 1080^2 flow path, unsharded and on a
2x2 tile mesh, once on an NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits non-zero):
  1. device: the card's name and its nvidia-smi name/power-limit line;
  2. build: compile the CUDA kernels from optical_flow_tpu_torch/kernels/csrc;
  3. each kernel against its plain PyTorch version at the shapes of the main
     path, float32, with its tolerance, timed with CUDA events in turns
     (plain, kernel, kernel, plain) after warm-up; K5 (the tile mode of K3
     and K4) on the 2x2 tile grid of the mesh path, also against the
     full-frame kernel's region (max |err| must be 0), and P1 (the mesh
     probe's copy kernel) on the probe's tiles;
  4. the slice: VideoPipeline(VideoConfig.fast()) on 12 synthetic 720x1280
     BGR frames, once through the kernels and once on the plain path, flows
     compared by quantiles and gesture votes within 1%, exact launch counts;
  5. K4 through the controller: corrected coarse_to_fine with level_iters=2
     on a 1080^2 textured pair with a known sub-pixel shift;
  6. where the time goes: the kernel path's device busy time, idle share
     and device time by kernel from one torch.profiler trace, written in
     full to chiprun_out/profile_slice.json;
  7. the mesh slice: VideoPipeline(VideoConfig.fast(), mesh=2x2 tile grid on
     the one card) on phase 4's frames, flows and votes equal to phase 4's
     kernel path bit for bit, exact launch counts;
  8. the mesh controller: sharded_coarse_to_fine with level_iters=2 on phase
     5's pair, 3 levels, bit-identical to the unsharded controller, exact
     launch counts.
Launch counters are reset just before the runs of phases 4, 5, 7 and 8 and
read just after each. Then one JSON line with the kernels, and as the last
line {"ok": true, "device": {...}}. It needs one CUDA device and no network.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
FRAMES = 12
FRAME_HW = (720, 1280)
SIZE = 1080
# main-path shapes per 1080^2 frame (4 levels: 1080, 540, 270, 135)
K1_SHAPES = [(135, 135)]
K2_SHAPES = [(1080, 1080), (540, 540), (270, 270)]
K3_SHAPES = [(270, 270), (540, 540), (1080, 1080)]
K4_SHAPES = [(1080, 1080)]
# the mesh path: a 2x2 tile grid; K5 runs K4 per tile at 1080^2 (level_iters=2)
# and K3 per tile at 1080^2 and 540^2 (270^2 has odd 135^2 tiles: full frame)
GRID = (2, 2)
K5_WARP_SHAPES = [(1080, 1080)]
K5_PYRUP_SHAPES = [(540, 540), (1080, 1080)]
P1_TILE = (8, 128)  # the mesh probe's tile (parallel/vma_compat.py)
CLAMP, C = 8.0, 4  # VideoConfig.fast(): warp_clamp=8 -> shift_sep max_disp 4
ATOL_LK = 2e-5  # well-conditioned pixels (tests/test_warp_lk_kernel.py:61-106)
ATOL_PYRDOWN = 2e-3  # vs 'poly' (tests/test_kernels.py:100-101)
SHIFT = (2.5, -1.5)  # (dx, dy) of the phase-5 pair, px
RUNS = {"stream": "VideoPipeline.push (phase 4)",
        "controller": "coarse_to_fine level_iters=2 (phase 5)",
        "mesh_stream": "VideoPipeline.push, 2x2 tile mesh (phase 7)",
        "mesh_controller": "sharded_coarse_to_fine level_iters=2, 2x2 tile mesh (phase 8)"}
ENTRIES = ("oft_lk", "oft_pyrdown", "oft_pyrup_warp_lk", "oft_warp_lk",
           "oft_pyrup_warp_lk_tile", "oft_warp_lk_tile", "oft_tile_copy")
PROFILE_WARMUP, PROFILE_FRAMES = 5, 40


def log(msg: str) -> None:
    print(msg, flush=True)


def check_counts(what, counts, want):
    """Raise unless the launch counts are exactly `want` (absent: 0)."""
    want = {name: want.get(name, 0) for name in ENTRIES}
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
    {name: {"max_abs_err", "ms", "plain_ms"}} summed over the shapes one
    1080^2 frame runs."""
    import torch

    from optical_flow_tpu_torch.kernels.lk_kernel import lucas_kanade_cuda, lucas_kanade_plain
    from optical_flow_tpu_torch.kernels.pyrdown_kernel import pyr_down_cuda, pyr_down_plain
    from optical_flow_tpu_torch.kernels.warp_lk_kernel import (
        pyrup_warp_lk_cuda, pyrup_warp_lk_plain, warp_lk_cuda, warp_lk_plain,
    )
    from optical_flow_tpu_torch.kernels.tile_copy_kernel import tile_copy_cuda, tile_copy_plain
    from optical_flow_tpu_torch.kernels.warp_lk_kernel import pyrup_coarse_halo
    from optical_flow_tpu_torch.ops.pyramid import pyr_up_cols_first
    from optical_flow_tpu_torch.ops.warp import symmetric_warp
    from optical_flow_tpu_torch.parallel.halo import exchange_halo, exchange_halo_pyrup
    from optical_flow_tpu_torch.parallel.mesh import split

    rng = np.random.RandomState(SEED)
    mesh = grid_mesh(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    def warped(a, b, wu, wv):
        return symmetric_warp(a, b, wu, wv, quantize=True, impl="shift_sep", max_disp=C)

    results = {}

    def record(name, shape, err, ms, plain_ms, tol, full_err=None):
        if not err <= tol:
            raise AssertionError(f"{name} at {shape}: max|err| {err:.3g} > {tol:g}")
        if full_err is not None and not full_err == 0.0:
            raise AssertionError(f"{name} at {shape}: max|err| {full_err:.3g} vs the full-frame "
                                 "kernel's region, want 0")
        r = results.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        vs_full = "" if full_err is None else f", vs full frame {full_err:.3g}"
        log(f"  {name} {shape[0]}x{shape[1]}: max|err| {err:.3g} (tol {tol:g}){vs_full}, "
            f"kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us")

    def tile_calls(ext, shape):
        """Each tile's (extended inputs, tile keywords, region of the frame)
        on the 2x2 grid; the extended tiles are what the sharded wrappers
        hand K5 (split + halo exchange)."""
        h, w = shape[0] // GRID[0], shape[1] // GRID[1]
        calls = []
        for idx in np.ndindex(ext[0].shape):
            r0, c0 = idx[1] * h, idx[2] * w
            calls.append(([e[idx] for e in ext], dict(halo=C + 2, origin=(r0, c0), global_hw=shape),
                          (slice(r0, r0 + h), slice(c0, c0 + w))))
        return calls

    def tile_errors(calls, kernel, plain, kw, full, mask):
        """K5 per tile: max masked |kernel - plain| on the same extended
        tile, and max |kernel - the full-frame kernel's region|."""
        err = full_err = 0.0
        for args, tile, reg in calls:
            (u1, v1), (u0, v0) = kernel(*args, **kw, **tile), plain(*args, **kw, **tile)
            torch.cuda.synchronize()
            err = max(err, masked_err(u1, u0, mask[reg]), masked_err(v1, v0, mask[reg]))
            full_err = max(full_err, float((u1 - full[0][reg]).abs().max()),
                           float((v1 - full[1][reg]).abs().max()))
        return err, full_err

    def each_tile(fn, calls, kw):
        return lambda: [fn(*args, **kw, **tile) for args, tile, _ in calls]

    for shape in K1_SHAPES:
        a, b = t(rng.rand(*shape)), t(rng.rand(*shape))
        (u1, v1), (u0, v0) = lucas_kanade_cuda(a, b), lucas_kanade_plain(a, b)
        torch.cuda.synchronize()
        m = well_conditioned(a, b)
        err = max(masked_err(u1, u0, m), masked_err(v1, v0, m))
        ms, pms = time_pair(lambda: lucas_kanade_plain(a, b), lambda: lucas_kanade_cuda(a, b), iters)
        record("lk", shape, err, ms, pms, ATOL_LK)
    for shape in K2_SHAPES:
        x = t(rng.rand(*shape) * 255.0)
        y1, y0 = pyr_down_cuda(x), pyr_down_plain(x)
        torch.cuda.synchronize()
        if y1.shape != y0.shape:
            raise AssertionError(f"pyrdown shape {tuple(y1.shape)} != {tuple(y0.shape)}")
        err = float((y1 - y0).abs().max())
        ms, pms = time_pair(lambda: pyr_down_plain(x), lambda: pyr_down_cuda(x), iters)
        record("pyrdown", shape, err, ms, pms, ATOL_PYRDOWN)
    for shape in K3_SHAPES:
        H, W = shape
        a, b = t(rng.rand(H, W)), t(rng.rand(H, W))
        uc, vc = (t(f) for f in smooth_flow(rng, (H // 2, W // 2), 2.0))
        kw = dict(max_disp=C, clamp=CLAMP)
        (u1, v1), (u0, v0) = pyrup_warp_lk_cuda(a, b, uc, vc, **kw), pyrup_warp_lk_plain(a, b, uc, vc, **kw)
        torch.cuda.synchronize()
        upu, upv = 2.0 * pyr_up_cols_first(uc), 2.0 * pyr_up_cols_first(vc)
        m = well_conditioned(*warped(a, b, -upu.clamp(-CLAMP, CLAMP), -upv.clamp(-CLAMP, CLAMP)))
        err = max(masked_err(u1, u0, m), masked_err(v1, v0, m))
        ms, pms = time_pair(lambda: pyrup_warp_lk_plain(a, b, uc, vc, **kw),
                            lambda: pyrup_warp_lk_cuda(a, b, uc, vc, **kw), iters)
        record("pyrup_warp_lk", shape, err, ms, pms, ATOL_LK)
    for shape in K4_SHAPES:
        a, b = t(rng.rand(*shape)), t(rng.rand(*shape))
        u, v = (t(f) for f in smooth_flow(rng, shape, 2.0))
        kw = dict(max_disp=C, clamp=CLAMP, negate=True)
        (u1, v1), (u0, v0) = warp_lk_cuda(a, b, u, v, **kw), warp_lk_plain(a, b, u, v, **kw)
        torch.cuda.synchronize()
        m = well_conditioned(*warped(a, b, -u.clamp(-CLAMP, CLAMP), -v.clamp(-CLAMP, CLAMP)))
        err = max(masked_err(u1, u0, m), masked_err(v1, v0, m))
        ms, pms = time_pair(lambda: warp_lk_plain(a, b, u, v, **kw),
                            lambda: warp_lk_cuda(a, b, u, v, **kw), iters)
        record("warp_lk", shape, err, ms, pms, ATOL_LK)
    for shape in K5_WARP_SHAPES:
        a, b = t(rng.rand(*shape)), t(rng.rand(*shape))
        u, v = (t(f) for f in smooth_flow(rng, shape, 2.0))
        kw = dict(max_disp=C, clamp=CLAMP, negate=True)
        full = warp_lk_cuda(a, b, u, v, **kw)
        m = well_conditioned(*warped(a, b, -u.clamp(-CLAMP, CLAMP), -v.clamp(-CLAMP, CLAMP)))
        calls = tile_calls([exchange_halo(split(x, mesh), C + 2, border="zero")
                            for x in (a, b, u, v)], shape)
        err, full_err = tile_errors(calls, warp_lk_cuda, warp_lk_plain, kw, full, m)
        ms, pms = time_pair(each_tile(warp_lk_plain, calls, kw), each_tile(warp_lk_cuda, calls, kw),
                            iters)
        record("warp_lk_tile", shape, err, ms, pms, ATOL_LK, full_err)
    for shape in K5_PYRUP_SHAPES:
        H, W = shape
        a, b = t(rng.rand(H, W)), t(rng.rand(H, W))
        uc, vc = (t(f) for f in smooth_flow(rng, (H // 2, W // 2), 2.0))
        kw = dict(max_disp=C, clamp=CLAMP)
        full = pyrup_warp_lk_cuda(a, b, uc, vc, **kw)
        upu, upv = 2.0 * pyr_up_cols_first(uc), 2.0 * pyr_up_cols_first(vc)
        m = well_conditioned(*warped(a, b, -upu.clamp(-CLAMP, CLAMP), -upv.clamp(-CLAMP, CLAMP)))
        ext = [exchange_halo(split(x, mesh), C + 2, border="zero") for x in (a, b)]
        ext += [exchange_halo_pyrup(split(x, mesh), pyrup_coarse_halo(C), 2) for x in (uc, vc)]
        calls = tile_calls(ext, shape)
        err, full_err = tile_errors(calls, pyrup_warp_lk_cuda, pyrup_warp_lk_plain, kw, full, m)
        ms, pms = time_pair(each_tile(pyrup_warp_lk_plain, calls, kw),
                            each_tile(pyrup_warp_lk_cuda, calls, kw), iters)
        record("pyrup_warp_lk_tile", shape, err, ms, pms, ATOL_LK, full_err)
    x = t(rng.rand(*P1_TILE))
    y1, y0 = tile_copy_cuda(x), tile_copy_plain(x)
    torch.cuda.synchronize()
    ms, pms = time_pair(lambda: tile_copy_plain(x), lambda: tile_copy_cuda(x), iters)
    record("tile_copy", P1_TILE, float((y1 - y0).abs().max()), ms, pms, 0.0)
    torch.cuda.synchronize()
    return results


def run_stream(config, frames, device, warmup=3, mesh=None):
    """Push every frame; return (results, steady-state ms per frame)."""
    import torch

    from optical_flow_tpu_torch.pipeline.video import VideoPipeline

    pipe = VideoPipeline(config, device=device, mesh=mesh)
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

    import torch

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
                 {"oft_pyrdown": 3 * (F - 1), "oft_lk": F - 2, "oft_pyrup_warp_lk": 3 * (F - 2)})
    if len(res_k) != F - 2 or len(res_p) != F - 2:
        raise AssertionError(f"expected {F - 2} results, got {len(res_k)} and {len(res_p)}")
    d, votes = [], []
    for rk, rp in zip(res_k, res_p):
        for x in (rk.u, rk.v):
            if tuple(x.shape) != (size, size) or not bool(torch.isfinite(x).all()):
                raise AssertionError("flow is not finite or has the wrong shape")
        inner = (slice(8, -8), slice(8, -8))
        d.append(torch.hypot(rk.u[inner] - rp.u[inner], rk.v[inner] - rp.v[inner]).flatten())
        a, b = int(rk.gesture.votes), int(rp.gesture.votes)
        votes.append((a, b))
        if abs(a - b) > max(1.0, 0.01 * max(a, b)):
            raise AssertionError(f"gesture votes differ beyond 1%: kernel {a}, plain {b}")
    d = torch.cat(d).double().cpu().numpy()
    med, q99 = float(np.median(d)), float(np.quantile(d, 0.99))
    if not (med < 1e-3 and q99 < 0.02):
        raise AssertionError(f"slice flow vs plain: median {med:.3g}, q99 {q99:.3g}")
    out = {
        "frames": F, "launches": counts, "flow_median": med, "flow_q99": q99,
        "votes": votes, "ms_per_frame_kernels": float(np.median(ms_k)),
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
                 {"oft_pyrdown": 6, "oft_lk": 1, "oft_pyrup_warp_lk": 3, "oft_warp_lk": 4})
    return {"launches": counts, "median_epe_px": median_epe("controller", u, v)}


def phase_mesh_slice(device, frames, size, stream_results):
    """Phase 4's frames through VideoPipeline(fast, mesh=2x2 tiles on the
    card). Per frame pair: K2 three times (the new diff's pyramid), K1 once
    (135^2, untileable), K3 full frame once (270^2: its 135^2 tiles are
    odd), K3 tiled at 540^2 and 1080^2 (one launch per tile); P1 once per
    tile at the mesh's first sharded call."""
    import torch

    from optical_flow_tpu_torch import kernels
    from optical_flow_tpu_torch.config import VideoConfig

    mesh = grid_mesh(device)
    tiles = GRID[0] * GRID[1]
    kernels.reset_launch_counts()
    res, ms = run_stream(VideoConfig.fast(size=(size, size)), frames, device, mesh=mesh)
    counts = kernels.launch_counts()
    F = len(frames)
    check_counts("mesh slice", counts,
                 {"oft_pyrdown": 3 * (F - 1), "oft_lk": F - 2, "oft_pyrup_warp_lk": F - 2,
                  "oft_pyrup_warp_lk_tile": 2 * tiles * (F - 2), "oft_tile_copy": tiles})
    if len(res) != len(stream_results):
        raise AssertionError(f"mesh slice gave {len(res)} results, phase 4 {len(stream_results)}")
    votes = []
    for rm, rk in zip(res, stream_results):
        if not (torch.equal(rm.u, rk.u) and torch.equal(rm.v, rk.v)):
            raise AssertionError("the mesh slice's flow differs from phase 4's kernel path")
        a, b = int(rm.gesture.votes), int(rk.gesture.votes)
        if a != b or bool(rm.gesture.detected) != bool(rk.gesture.detected):
            raise AssertionError(f"the mesh slice's votes {a} differ from phase 4's {b}")
        votes.append(a)
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
                 {"oft_pyrdown": 4, "oft_lk": tiles, "oft_pyrup_warp_lk_tile": 2 * tiles,
                  "oft_warp_lk_tile": 3 * tiles, "oft_tile_copy": tiles})
    if not (torch.equal(u, u0) and torch.equal(v, v0)):
        raise AssertionError("the mesh controller differs from the unsharded controller")
    return {"launches": counts, "median_epe_px": median_epe("mesh controller", u, v)}


def _busy_ms(intervals):
    """Length of the union of (start, end) intervals, in ms (input µs)."""
    busy, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


def phase_profile(device, size, warmup=PROFILE_WARMUP, n=PROFILE_FRAMES):
    """Where the time of the kernel path goes. One pipeline takes `warmup`
    frames, then `n` frames timed on the host clock (push + synchronize per
    frame, no tracer), then `n` more under torch.profiler (CUDA activity
    only), timed the same way. Device busy time is the union of the traced
    device events; the idle share is 1 - busy / wall of the traced frames.
    Writes the per-kernel totals to chiprun_out/profile_slice.json."""
    import pathlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from optical_flow_tpu_torch.config import VideoConfig
    from optical_flow_tpu_torch.pipeline.video import VideoPipeline

    frames = synthetic_frames(np.random.RandomState(SEED + 2), warmup + 2 * n, FRAME_HW)
    pipe = VideoPipeline(VideoConfig.fast(size=(size, size)), device=device)

    def push_timed(batch):
        ms = []
        for frame in batch:
            t0 = time.perf_counter()
            pipe.push(frame)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms

    push_timed(frames[:warmup])
    untraced = push_timed(frames[warmup : warmup + n])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced = push_timed(frames[warmup + n :])
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
        "frames": n,
        "untraced_ms_per_frame_median": float(np.median(untraced)),
        "untraced_ms_per_frame_mean": float(np.mean(untraced)),
        "traced_ms_per_frame_median": float(np.median(traced)),
        "traced_wall_ms": wall,
        "device_busy_ms": busy,
        "device_busy_ms_per_frame": busy / n,
        "device_events_per_frame": len(events) / n,
        "idle_share": 1.0 - busy / wall,
        "top": [{"name": k[:60], "calls_per_frame": v["calls"] / n, "ms_per_frame": v["ms"] / n}
                for k, v in top[:8]],
    }
    out = pathlib.Path(__file__).resolve().parent / "chiprun_out" / "profile_slice.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"summary": summary, "untraced_ms": untraced, "traced_ms": traced,
                               "by_name": dict(top)}, indent=1))
    return summary


# ------------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this check needs a GPU")
    from optical_flow_tpu_torch import kernels
    from optical_flow_tpu_torch.kernels import _lib

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

    per_kernel = phase_kernels(device)
    log("[3 kernels] all kernels agree with their plain versions")

    rng = np.random.RandomState(SEED)
    frames = synthetic_frames(rng, FRAMES, FRAME_HW)
    sl, stream_results = phase_slice(device, frames, SIZE)
    log(f"[4 slice] {json.dumps(sl)}")
    ctl = phase_controller(device, SIZE)
    log(f"[5 controller] {json.dumps(ctl)}")
    log(f"[6 profile] {json.dumps(phase_profile(device, SIZE))}")
    msl = phase_mesh_slice(device, frames, SIZE, stream_results)
    log(f"[7 mesh slice] {json.dumps(msl)}")
    del stream_results
    mctl = phase_mesh_controller(device, SIZE)
    log(f"[8 mesh controller] {json.dumps(mctl)}")

    # Each count comes from one run, its counters reset just before it: the
    # streaming VideoPipeline.push run (phase 4) drives K1-K3, K4 runs on the
    # controller path, coarse_to_fine with level_iters=2 (phase 5), K5's K3
    # mode and P1 on the mesh stream (phase 7) and K5's K4 mode on the mesh
    # controller with level_iters=2 (phase 8).
    meta = {
        "lk": ("oft_lk", "stream", "optical_flow_tpu_torch/kernels/csrc/lk.cu",
               "optical_flow_tpu/kernels/lk_kernel.py:173"),
        "pyrdown": ("oft_pyrdown", "stream", "optical_flow_tpu_torch/kernels/csrc/pyrdown.cu",
                    "optical_flow_tpu/kernels/pyrdown_kernel.py:146"),
        "pyrup_warp_lk": ("oft_pyrup_warp_lk", "stream",
                          "optical_flow_tpu_torch/kernels/csrc/warp_lk.cu",
                          "optical_flow_tpu/kernels/warp_lk_kernel.py:667"),
        "warp_lk": ("oft_warp_lk", "controller", "optical_flow_tpu_torch/kernels/csrc/warp_lk.cu",
                    "optical_flow_tpu/kernels/warp_lk_kernel.py:370"),
        "pyrup_warp_lk_tile": ("oft_pyrup_warp_lk_tile", "mesh_stream",
                               "optical_flow_tpu_torch/kernels/csrc/warp_lk.cu",
                               "optical_flow_tpu/kernels/warp_lk_kernel.py:667"),
        "warp_lk_tile": ("oft_warp_lk_tile", "mesh_controller",
                         "optical_flow_tpu_torch/kernels/csrc/warp_lk.cu",
                         "optical_flow_tpu/kernels/warp_lk_kernel.py:370"),
        "tile_copy": ("oft_tile_copy", "mesh_stream",
                      "optical_flow_tpu_torch/kernels/csrc/tile_copy.cu",
                      "optical_flow_tpu/parallel/vma_compat.py:44"),
    }
    runs = {"stream": sl["launches"], "controller": ctl["launches"],
            "mesh_stream": msl["launches"], "mesh_controller": mctl["launches"]}
    missing = [name for name, (entry, run, _, _) in meta.items() if runs[run][entry] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on their path: {missing}")
    rows = []
    for name, (entry, run, source, replaces) in meta.items():
        r = per_kernel[name]
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": runs[run][entry], "run": RUNS[run],
                     "launches_by_run": {k: c[entry] for k, c in runs.items()},
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
