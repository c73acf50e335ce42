"""The port's streaming flow slice against the JAX package, end to end at
1/9 of the 1080^2 level structure (120^2: levels 120, 60, 30, 15).

Both sides take identical numpy inputs made from a seed. On the CPU the
production warp is chosen explicitly (``warp_impl='shift_sep'`` on both
sides: ``'auto'`` resolves to ``'gather'`` off the accelerator), and the
port routes through its kernel wrappers (``impl='cuda'``), which run their
plain versions on CPU tensors. Flows are compared by quantiles of the
per-pixel difference (median < 1e-3 px, q99 < 0.02 px,
tests/test_warp_lk_kernel.py:224-231): near-singular pixels may flip
under float32 roundoff.
"""

import dataclasses
from functools import lru_cache

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from optical_flow_tpu import config as j_config
from optical_flow_tpu.flow.coarse_to_fine import coarse_to_fine as j_coarse_to_fine
from optical_flow_tpu.flow.coarse_to_fine import coarse_to_fine_pyramids as j_c2f_pyramids
from optical_flow_tpu.ops.pyramid import gaussian_pyramid as j_gaussian_pyramid
from optical_flow_tpu.pipeline import preprocess as j_pre
from optical_flow_tpu.pipeline.gesture import detect_gesture as j_detect_gesture
from optical_flow_tpu.pipeline.video import VideoPipeline as JVideoPipeline
from optical_flow_tpu_torch import config as t_config
from optical_flow_tpu_torch.convert import pipeline_state_from_jax
from optical_flow_tpu_torch.flow.coarse_to_fine import coarse_to_fine as t_coarse_to_fine
from optical_flow_tpu_torch.flow.coarse_to_fine import coarse_to_fine_pyramids as t_c2f_pyramids
from optical_flow_tpu_torch.ops.pyramid import gaussian_pyramid as t_gaussian_pyramid
from optical_flow_tpu_torch.pipeline import preprocess as t_pre
from optical_flow_tpu_torch.pipeline.gesture import detect_gesture as t_detect_gesture
from optical_flow_tpu_torch.pipeline.video import VideoPipeline as TVideoPipeline

SIZE = 120
SHIFT = (2.5, -1.5)  # (dx, dy), px


def _np(x):
    return np.array(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _assert_flow_close(ju, jv, tu, tv, inner=8):
    s = (Ellipsis, slice(inner, -inner), slice(inner, -inner))
    d = np.hypot(_np(ju)[s] - _np(tu)[s], _np(jv)[s] - _np(tv)[s])
    assert np.median(d) < 1e-3, np.median(d)
    assert np.quantile(d, 0.99) < 0.02, np.quantile(d, 0.99)


def _texture_pair(seed=42):
    """A smooth random texture and its copy shifted by SHIFT (bilinear)."""
    rng = np.random.RandomState(seed)
    pad, n = 16, SIZE + 32
    f = np.fft.fftfreq(n)
    g = np.exp(-2.0 * (np.pi * 3.0) ** 2 * (f[:, None] ** 2 + f[None, :] ** 2))
    big = np.real(np.fft.ifft2(np.fft.fft2(rng.rand(n, n)) * g))
    ys, xs = np.mgrid[0:SIZE, 0:SIZE]

    def sample(oy, ox):
        y, x = ys + pad + oy, xs + pad + ox
        y0, x0 = np.floor(y).astype(int), np.floor(x).astype(int)
        fy, fx = y - y0, x - x0
        return (big[y0, x0] * (1 - fy) * (1 - fx) + big[y0, x0 + 1] * (1 - fy) * fx
                + big[y0 + 1, x0] * fy * (1 - fx) + big[y0 + 1, x0 + 1] * fy * fx)

    dx, dy = SHIFT
    return sample(0.0, 0.0).astype(np.float32), sample(-dy, -dx).astype(np.float32)


@lru_cache(maxsize=None)
def _jax_flow(level_iters):
    img1, img2 = _texture_pair()
    cfg = j_config.FlowConfig(impl="jnp", mode="corrected", warp_clamp=8.0,
                              warp_impl="shift_sep", level_iters=level_iters)
    u, v = jax.jit(lambda a, b: j_coarse_to_fine(a, b, config=cfg))(
        jnp.asarray(img1), jnp.asarray(img2))
    return _np(u), _np(v)


@pytest.mark.parametrize("level_iters", [1, 2])
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_coarse_to_fine_corrected_matches_jax(impl, level_iters):
    img1, img2 = _texture_pair()
    cfg = t_config.FlowConfig(impl=impl, mode="corrected", warp_clamp=8.0,
                              warp_impl="shift_sep", level_iters=level_iters, pyr_impl="auto")
    u, v = t_coarse_to_fine(_t(img1), _t(img2), config=cfg)
    ju, jv = _jax_flow(level_iters)
    _assert_flow_close(ju, jv, u, v)
    inner = (slice(8, -8), slice(8, -8))
    epe = np.hypot(u.numpy()[inner] - SHIFT[0], v.numpy()[inner] - SHIFT[1])
    assert np.median(epe) < 0.2, np.median(epe)


# The controller configurations beside the streaming slice's: (mode,
# warp_impl, warp_clamp, quantize_warp, levels, level_iters). Both packages'
# plain routes (JAX 'jnp', the port 'torch'), eager, on a 64x48 pair.
CONTROLLER_CONFIGS = {
    "shift_corrected": ("corrected", "shift", 6.0, True, None, 1),
    "shift_level_iters2": ("corrected", "shift", 4.0, True, 3, 2),
    "gather_corrected_unclamped": ("corrected", "gather", None, True, None, 1),
    "gather_corrected_clamped": ("corrected", "gather", 8.0, True, None, 2),
    "gather_unquantized": ("reference", "gather", None, False, None, 1),
    "shift_sep_unquantized": ("corrected", "shift_sep", 8.0, False, None, 1),
    "explicit_levels": ("reference", "gather", None, True, 3, 1),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", CONTROLLER_CONFIGS)
def test_controller_configurations_match_jax(name, dtype):
    """float64 (JAX x64): within 1e-9. float32: the slice's bar (median <
    1e-3 px, q99 < 0.02 px) on the interior. Every case read max |d| 0 in
    both dtypes when the test was written."""
    mode, warp_impl, clamp, quantize, levels, level_iters = CONTROLLER_CONFIGS[name]
    rng = np.random.RandomState(12)
    a = _smooth(rng, 48, 64, 2.0).astype(dtype)
    b = np.roll(a, (1, 2), (0, 1)) + (0.02 * rng.rand(48, 64)).astype(dtype)
    kw = dict(mode=mode, warp_impl=warp_impl, warp_clamp=clamp, quantize_warp=quantize,
              levels=levels, level_iters=level_iters)
    ju, jv = j_coarse_to_fine(jnp.asarray(a), jnp.asarray(b),
                              config=j_config.FlowConfig(impl="jnp", **kw))
    u, v = t_coarse_to_fine(torch.from_numpy(a), torch.from_numpy(b),
                            config=t_config.FlowConfig(impl="torch", **kw))
    assert u.dtype == getattr(torch, np.dtype(dtype).name)
    if dtype == np.float64:
        assert np.abs(np.asarray(ju) - u.numpy()).max() <= 1e-9
        assert np.abs(np.asarray(jv) - v.numpy()).max() <= 1e-9
    else:
        _assert_flow_close(ju, jv, u, v)


def test_controller_shift_solves_on_k1(monkeypatch):
    """With warp_impl='shift' the controller warps by symmetric_warp and
    solves with lucas_kanade at each level (K1 on the card), never through
    the fused K3/K4 routes, which fuse only the shift_sep warp."""
    import importlib

    from optical_flow_tpu_torch.kernels import warp_lk_kernel

    c2f = importlib.import_module("optical_flow_tpu_torch.flow.coarse_to_fine")

    def refuse(*args, **kw):
        raise AssertionError("a fused warp+LK route was taken")

    monkeypatch.setattr(warp_lk_kernel, "warp_lk_cuda", refuse)
    monkeypatch.setattr(warp_lk_kernel, "pyrup_warp_lk_cuda", refuse)
    solves = []
    lk = c2f.lucas_kanade
    monkeypatch.setattr(c2f, "lucas_kanade", lambda a, b, **kw: solves.append(a.shape) or lk(a, b, **kw))
    img1, img2 = _texture_pair()
    cfg = t_config.FlowConfig(impl="cuda", mode="corrected", warp_clamp=8.0, warp_impl="shift",
                              level_iters=2)
    u, v = t_coarse_to_fine(_t(img1), _t(img2), 4, config=cfg)
    assert len(solves) == 4 * 2  # every level, twice
    inner = (slice(8, -8), slice(8, -8))
    epe = np.hypot(u.numpy()[inner] - SHIFT[0], v.numpy()[inner] - SHIFT[1])
    assert np.median(epe) < 0.2, np.median(epe)


def _smooth(rng, h, w, sigma):
    fy, fx = np.fft.fftfreq(h)[:, None], np.fft.fftfreq(w)[None, :]
    g = np.exp(-2.0 * (np.pi * sigma) ** 2 * (fx * fx + fy * fy))
    t = np.real(np.fft.ifft2(np.fft.fft2(rng.rand(h, w)) * g))
    return (t - t.min()) / (t.max() - t.min())


def _frames(n=6, seed=3, hw=(72, 128)):
    """BGR uint8 frames: a textured background and a textured patch that
    moves (+3, +2) px per frame."""
    rng = np.random.RandomState(seed)
    H, W = hw
    bg, patch = _smooth(rng, H, W, 2.0), _smooth(rng, H // 3, W // 4, 1.5)
    out = np.empty((n, H, W, 3), np.uint8)
    for t in range(n):
        g = 0.6 * bg
        g[H // 4 + 2 * t : H // 4 + 2 * t + H // 3, W // 4 + 3 * t : W // 4 + 3 * t + W // 4] = (
            0.3 + 0.7 * patch)
        out[t] = np.clip(g[..., None] * np.array([0.9, 1.0, 0.8]) * 255.0, 0, 255)
    return out


def _configs():
    # At 120^2 the default 20 px gesture threshold keeps only a few dozen
    # near-singular outlier pixels, which roundoff flips; 2 px counts the
    # moving patch itself (about 2300 votes), a stable comparison.
    jf = j_config.VideoConfig.fast(size=(SIZE, SIZE))
    jf = dataclasses.replace(jf, flow=dataclasses.replace(jf.flow, warp_impl="shift_sep"),
                             gesture=j_config.GestureConfig(mag_thresh=2.0))
    tf = t_config.VideoConfig.fast(size=(SIZE, SIZE))
    tf = dataclasses.replace(
        tf, flow=dataclasses.replace(tf.flow, impl="cuda", pyr_impl="cuda", warp_impl="shift_sep"),
        gesture=t_config.GestureConfig(mag_thresh=2.0),
    )
    return jf, tf


def test_video_stages_match_jax():
    """Each stage of VideoPipeline(fast) fed identical inputs on both sides."""
    jf, tf = _configs()
    frames = _frames(3)
    # preprocess: gray first, banded resize+blur matmuls (float32 matmul
    # accumulation order differs between XLA and PyTorch)
    jg = [_np(j_pre.preprocess_frame(jnp.asarray(f), jf.preprocess)) for f in frames]
    for f, g in zip(frames, jg):
        np.testing.assert_allclose(t_pre.preprocess_frame(torch.from_numpy(f), tf.preprocess).numpy(),
                                   g, rtol=1e-5, atol=2e-4)
    # diff features on the same grays: identical elementwise float32 ops
    jd = [_np(j_pre.diff_features(jnp.asarray(jg[k + 1]), jnp.asarray(jg[k]), jf.preprocess))
          for k in range(2)]
    for k in range(2):
        td = t_pre.diff_features(_t(jg[k + 1]), _t(jg[k]), tf.preprocess)
        np.testing.assert_array_equal(td.numpy(), jd[k])
    # pyramids of the same diffs (K2 wrapper on CPU = poly): bit-identical
    jp = [[_np(x) for x in j_gaussian_pyramid(jnp.asarray(d), 4)] for d in jd]
    for d, levels in zip(jd, jp):
        for a, b in zip(levels, t_gaussian_pyramid(_t(d), 4, impl="cuda")):
            np.testing.assert_array_equal(b.numpy(), a)
    # flow from the same pyramids
    ju, jv, _, _ = jax.jit(lambda p, q: j_c2f_pyramids(p, q, config=jf.flow))(
        [jnp.asarray(x) for x in jp[0]], [jnp.asarray(x) for x in jp[1]])
    tu, tv, _, _ = t_c2f_pyramids([_t(x) for x in jp[0]], [_t(x) for x in jp[1]], config=tf.flow)
    _assert_flow_close(ju, jv, tu, tv)
    # gesture on the same flow
    jr = j_detect_gesture(jnp.asarray(_np(ju)), jnp.asarray(_np(jv)), jf.gesture)
    tr = t_detect_gesture(_t(ju), _t(jv), tf.gesture)
    assert int(tr.votes) == int(jr.votes) and bool(tr.detected) == bool(jr.detected)
    np.testing.assert_allclose([float(tr.cx), float(tr.cy)], [float(jr.cx), float(jr.cy)], rtol=1e-5)
    np.testing.assert_allclose(tr.magnitude.numpy(), _np(jr.magnitude), rtol=1e-5, atol=1e-6)


def _global_low_precision(style):
    """Set reduced float32 matmul precision globally, the way a caller
    might; returns the function that undoes it."""
    if style == "legacy":
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("medium")
        return lambda: torch.set_float32_matmul_precision(prev)
    backends = ((torch.backends.cuda.matmul, "tf32"), (torch.backends.mkldnn.matmul, "bf16"))
    prev = [b.fp32_precision for b, _ in backends]
    for b, p in backends:
        b.fp32_precision = p
    return lambda: [setattr(b, "fp32_precision", p) for (b, _), p in zip(backends, prev)]


def _check_resize_blur_ignores_global_precision(device, style):
    frame = torch.from_numpy(_frames(1)[0]).to(device)
    cfg = t_config.PreprocessConfig(size=(SIZE, SIZE), faithful_uint8=False)
    want = t_pre.preprocess_frame(frame, cfg)
    restore = _global_low_precision(style)
    try:
        state = (torch.backends.cuda.matmul.fp32_precision, torch.backends.mkldnn.matmul.fp32_precision)
        got = t_pre.preprocess_frame(frame, cfg)
        assert (torch.backends.cuda.matmul.fp32_precision,
                torch.backends.mkldnn.matmul.fp32_precision) == state
    finally:
        restore()
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("style", ["legacy", "per_backend"])
def test_resize_blur_ignores_global_precision(style):
    """ResizeBlur runs its matmuls at full float32 under a caller's global
    TF32/bf16 setting and leaves that setting as it found it."""
    _check_resize_blur_ignores_global_precision(torch.device("cpu"), style)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("style", ["legacy", "per_backend"])
def test_resize_blur_ignores_global_precision_on_card(cuda_device, style):
    _check_resize_blur_ignores_global_precision(cuda_device, style)


def _assert_results_close(jres, tres):
    assert len(jres) == len(tres)
    for jr, tr in zip(jres, tres):
        _assert_flow_close(jr.u, jr.v, tr.u, tr.v)
        a, b = int(jr.gesture.votes), int(tr.gesture.votes)
        assert abs(a - b) <= max(1, 0.01 * max(a, b)), (a, b)


def test_video_pipeline_end_to_end_matches_jax():
    jf, tf = _configs()
    frames = _frames()
    jres = list(JVideoPipeline(jf).run(frames, prefetch=0))
    tpipe = TVideoPipeline(tf, device="cpu")
    tres = list(tpipe.run(frames))
    assert len(tres) == len(frames) - 2
    _assert_results_close(jres, tres)
    # batched mode: the same pairs as streaming
    batched = tpipe.run_batched(torch.from_numpy(frames))
    for k, r in enumerate(tres):
        np.testing.assert_array_equal(batched.u[k].numpy(), r.u.numpy())
        assert int(batched.gesture.votes[k]) == int(r.gesture.votes)


def test_state_carried_over_from_jax():
    """JAX runs k frames; its state() goes through convert into the port's
    restore; the same next frames then give the same flows on both sides."""
    jf, tf = _configs()
    frames = _frames()
    jpipe = JVideoPipeline(jf)
    for f in frames[:3]:
        jpipe.push(f)
    tpipe = TVideoPipeline(tf, device="cpu")
    tpipe.restore(pipeline_state_from_jax(jpipe.state()))
    assert tpipe.state()["frame_idx"] == 3
    jres = [jpipe.push(f) for f in frames[3:]]
    tres = [tpipe.push(f) for f in frames[3:]]
    assert all(r is not None for r in tres)
    _assert_results_close(jres, tres)


def test_faithful_prev_diff_reference_mode_matches_jax():
    """The non-reuse streaming path: reference-mode flow with the gather
    warp, and the warped diff kept as the next prevDiff (float preprocess)."""
    jc = j_config.VideoConfig(
        preprocess=j_config.PreprocessConfig(size=(48, 48), faithful_uint8=False),
        gesture=j_config.GestureConfig(mag_thresh=2.0),
    )
    tc = t_config.VideoConfig(
        preprocess=t_config.PreprocessConfig(size=(48, 48), faithful_uint8=False),
        gesture=t_config.GestureConfig(mag_thresh=2.0),
    )
    frames = _frames(5)
    jres = list(JVideoPipeline(jc).run(frames, prefetch=0))
    tres = list(TVideoPipeline(tc, device="cpu").run(frames))
    _assert_results_close(jres, tres)
