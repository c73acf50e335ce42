"""F1, the frame's feature map in one kernel (``kernels/features_kernel.py``,
``csrc/features.cu``), and the pipeline's route to it.

On the CPU the wrapper runs its plain version, ``diff_features``, and
``VideoPipeline._diff`` sends the planes to the wrapper exactly where the
kernel route is taken (``flow.impl`` and the device) and F1 takes them
(float32 or uint8, ``morph_iterations`` at most 4). The tests marked
``cuda`` hold the kernel against the plain chain on the card bit for bit
(max |err| 0): frame sizes of the main path and odd ones down to 2x2,
batches of 1 and 16, both dtypes with and without the uint8 saturation,
every radius, diffs on the threshold and on rounding ties; and the fast
stream, the chunked run and a 320-frame faithful stream through the
kernels against ``flow.impl='torch'``. This file imports no JAX, so the card
runs it as it is.
"""

import dataclasses

import numpy as np
import pytest
import torch

from optical_flow_tpu_torch import config as t_config
from optical_flow_tpu_torch import kernels
from optical_flow_tpu_torch.kernels import features_kernel
from optical_flow_tpu_torch.kernels.features_kernel import diff_features_cuda, kernel_takes
from optical_flow_tpu_torch.pipeline.preprocess import diff_features
from optical_flow_tpu_torch.pipeline.video import VideoPipeline

# (dtype, faithful_uint8): the fast path's float planes, the faithful
# path's saturating uint8 planes, and uint8 planes diffed in float32
_KINDS = [(torch.float32, False), (torch.uint8, True), (torch.uint8, False)]
_KIND_IDS = ["float32", "uint8-saturated", "uint8-float-diff"]


def _planes(rng, shape, dtype, device="cpu"):
    if dtype == torch.uint8:
        arrays = [rng.randint(0, 256, shape).astype(np.uint8) for _ in range(2)]
    else:
        arrays = [(rng.rand(*shape) * 255).astype(np.float32) for _ in range(2)]
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def _config(faithful, r):
    return t_config.PreprocessConfig(faithful_uint8=faithful, morph_iterations=r)


def _tie_planes(rng, shape, device="cpu"):
    """uint8 planes whose float32 diff lies on x.5 (0.3f * prev rounds to an
    exact half) and around the threshold of 10, and float32 planes whose diff
    lands exactly on it."""
    lr = np.float32(0.3)
    values = np.arange(256, dtype=np.float32)
    prod = (lr * values).astype(np.float32)
    ties = values[(prod - np.floor(prod)) == 0.5].astype(np.uint8)
    assert len(ties) > 8
    prev8 = rng.choice(ties, shape).astype(np.uint8)
    cur8 = rng.randint(5, 20, shape).astype(np.uint8)
    cur32 = rng.choice(np.float32([0.0, 9.0, 9.5, 10.0, 10.5, 11.0, 255.0]), shape)
    prev32 = np.zeros(shape, np.float32)
    return [tuple(torch.from_numpy(a).to(device) for a in pair)
            for pair in ((cur8, prev8), (cur32, prev32))]


# ---------------------------------------------------------------- on the CPU


@pytest.mark.parametrize("r", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("dtype, faithful", _KINDS, ids=_KIND_IDS)
def test_features_wrapper_on_cpu_is_the_plain_chain(dtype, faithful, r):
    rng = np.random.RandomState(10 + r)
    cfg = _config(faithful, r)
    for shape in [(17, 33), (2, 9, 14)]:
        cur, prev = _planes(rng, shape, dtype)
        before = kernels.launch_counts()
        got = diff_features_cuda(cur, prev, cfg)
        assert kernels.launch_counts() == before
        assert got.dtype == torch.float32 and torch.equal(got, diff_features(cur, prev, cfg))
    with pytest.raises(ValueError):
        diff_features_cuda(cur, prev[..., :-1], cfg)


def test_kernel_takes_float32_or_uint8_pairs_up_to_radius_4():
    f, u = torch.zeros(4, 4), torch.zeros(4, 4, dtype=torch.uint8)
    cfg = t_config.PreprocessConfig()
    assert kernel_takes(f, f, cfg) and kernel_takes(u, u, cfg)
    assert not kernel_takes(f, u, cfg) and not kernel_takes(u, f, cfg)
    assert not kernel_takes(f.double(), f.double(), cfg)
    assert not kernel_takes(f.half(), f.half(), cfg)
    assert kernel_takes(f, f, _config(False, 4)) and not kernel_takes(f, f, _config(False, 5))


def _frames(n, hw=(48, 64), seed=3):
    """BGR uint8 frames: a textured patch moving 2 px a frame."""
    rng = np.random.RandomState(seed)
    H, W = hw
    bg = rng.rand(H, W) * 0.5
    patch = rng.rand(H // 3, W // 4)
    out = np.empty((n, H, W, 3), np.uint8)
    for t in range(n):
        g = bg.copy()
        g[8 + t:8 + t + H // 3, 10 + 2 * t:10 + 2 * t + W // 4] = patch
        out[t] = np.clip(g[..., None] * np.array([0.9, 1.0, 0.8]) * 255.0, 0, 255)
    return out


# (preset, flow impl, morph_iterations, F1 taken): the kernel route is
# flow.impl 'cuda' on the CPU (its wrapper runs the plain chain there);
# 'torch' and 'auto' on the CPU keep the plain route, and so does a radius
# F1 does not take
_ROUTES = [
    ("fast", "cuda", 2, True), ("faithful", "cuda", 2, True), ("fast", "cuda", 4, True),
    ("fast", "cuda", 5, False), ("fast", "torch", 2, False), ("faithful", "auto", 2, False),
]


@pytest.mark.parametrize("preset, impl, r, taken", _ROUTES,
                         ids=["fast-cuda", "faithful-cuda", "fast-cuda-r4", "fast-cuda-r5",
                              "fast-torch", "faithful-auto-on-cpu"])
def test_pipeline_routes_diff_features_to_f1(monkeypatch, preset, impl, r, taken):
    base = t_config.VideoConfig.fast(size=(32, 32)) if preset == "fast" else t_config.VideoConfig(
        preprocess=t_config.PreprocessConfig(size=(32, 32)))
    cfg = dataclasses.replace(
        base, preprocess=dataclasses.replace(base.preprocess, morph_iterations=r),
        flow=dataclasses.replace(base.flow, impl=impl))
    seen = []
    real = features_kernel.diff_features_cuda

    def counted(cur, prev, config):
        seen.append((tuple(cur.shape), cur.dtype))
        return real(cur, prev, config)

    monkeypatch.setattr(features_kernel, "diff_features_cuda", counted)
    frames = _frames(5)
    pipe = VideoPipeline(cfg, device="cpu")
    got = [pipe.push(f) for f in frames]
    assert len(seen) == (len(frames) - 1 if taken else 0), seen
    if taken:
        gray = torch.float32 if preset == "fast" else torch.uint8
        assert seen == [((32, 32), gray)] * (len(frames) - 1)
    plain = VideoPipeline(dataclasses.replace(cfg, flow=dataclasses.replace(cfg.flow, impl="torch")),
                          device="cpu")
    want = [plain.push(f) for f in frames]
    for g, w in zip(got[2:], want[2:]):
        assert torch.equal(g.u, w.u) and torch.equal(g.v, w.v)
    if preset == "fast":  # one call for the chunk of 3, one a frame of the tail of 2
        seen.clear()
        list(VideoPipeline(cfg, device="cpu").run_chunked(frames, chunk_size=3, prefetch=0))
        assert len(seen) == (3 if taken else 0), seen


# ---------------------------------------------------- on the card (marked)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _counted_equal(cur, prev, cfg):
    before = kernels.launch_counts()["oft_diff_features"]
    got = diff_features_cuda(cur, prev, cfg)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["oft_diff_features"] == before + 1
    want = diff_features(cur, prev, cfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got - want).abs().max()) == 0.0 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, faithful", _KINDS, ids=_KIND_IDS)
def test_features_kernel_on_card_equals_plain(cuda_device, dtype, faithful):
    """1080^2, 540x960 and odd planes down to 2x2, batch 1 and 16, every
    radius 0-4."""
    rng = np.random.RandomState(20)
    for hw in [(1080, 1080), (540, 960), (17, 33), (3, 7), (2, 2)]:
        for batch in ((), (16,)):
            cur, prev = _planes(rng, batch + hw, dtype, cuda_device)
            for r in range(5):
                _counted_equal(cur, prev, _config(faithful, r))


@pytest.mark.cuda
def test_features_kernel_on_card_ties_and_threshold(cuda_device):
    """Diffs on x.5 (round half to even on the saturating path) and on the
    threshold itself (kept only above it), in both dtypes."""
    rng = np.random.RandomState(21)
    for shape in [(1080, 1080), (16, 67, 129), (3, 7)]:
        (cur8, prev8), (cur32, prev32) = _tie_planes(rng, shape, cuda_device)
        for r in (0, 2):
            for faithful in (True, False):
                _counted_equal(cur8, prev8, _config(faithful, r))
            _counted_equal(cur32, prev32, _config(False, r))


@pytest.mark.cuda
def test_features_kernel_on_card_refuses_what_it_does_not_take(cuda_device):
    rng = np.random.RandomState(22)
    cur, prev = _planes(rng, (64, 128), torch.float32, cuda_device)
    cfg = t_config.PreprocessConfig()
    before = kernels.launch_counts()
    with pytest.raises(TypeError):
        diff_features_cuda(cur, prev.to(torch.uint8), cfg)
    with pytest.raises(TypeError):
        diff_features_cuda(cur.double(), prev.double(), cfg)
    with pytest.raises(ValueError):  # not contiguous
        diff_features_cuda(cur.t().contiguous().t(), prev, cfg)
    with pytest.raises(ValueError):
        diff_features_cuda(cur, prev, _config(False, 5))
    assert kernels.launch_counts() == before


def _stream_frames(n=16, hw=(720, 1280), seed=7):
    """BGR uint8 frames: a smooth texture and a textured patch that moves
    on a circle of 60 px, ``n`` positions a turn."""
    rng = np.random.RandomState(seed)
    H, W = hw

    def smooth(h, w, sigma):
        fy, fx = np.fft.fftfreq(h)[:, None], np.fft.fftfreq(w)[None, :]
        g = np.exp(-2.0 * (np.pi * sigma) ** 2 * (fx * fx + fy * fy))
        t = np.real(np.fft.ifft2(np.fft.fft2(rng.rand(h, w)) * g))
        return (t - t.min()) / (t.max() - t.min())

    bg, patch = smooth(H, W, 4.0), smooth(H // 4, W // 6, 2.0)
    out = np.empty((n, H, W, 3), np.uint8)
    for t in range(n):
        a = 2 * np.pi * t / n
        r0 = int(H // 2 - H // 8 + 60 * np.sin(a))
        c0 = int(W // 2 - W // 12 + 60 * np.cos(a))
        g = 0.6 * bg
        g[r0:r0 + H // 4, c0:c0 + W // 6] = 0.3 + 0.7 * patch
        out[t] = np.clip(g[..., None] * np.array([0.9, 1.0, 0.8]) * 255.0, 0, 255)
    return out


def _flat(results):
    """Chunked results (a leading batch axis, or one frame for the tail) as
    one list of per-frame (u, v, votes, cx, cy, detected)."""
    out = []
    for r in results:
        fields = (r.u, r.v, r.gesture.votes, r.gesture.cx, r.gesture.cy, r.gesture.detected)
        if r.u.ndim == 2:
            out.append(fields)
        else:
            out += [tuple(x[k] for x in fields) for k in range(r.u.shape[0])]
    return out


def _assert_same(got, want):
    assert len(got) == len(want) > 0
    for t, (a, b) in enumerate(zip(got, want)):
        for name, x, y in zip(("u", "v", "votes", "cx", "cy", "detected"), a, b):
            assert torch.equal(x, y), (t, name)


def _plain(cfg):
    return dataclasses.replace(cfg, flow=dataclasses.replace(cfg.flow, impl="torch"))


@pytest.mark.cuda
def test_fast_stream_and_chunks_through_f1_equal_plain(cuda_device):
    """VideoConfig.fast() at 1080^2: a 64-frame push stream (one F1 launch a
    frame after the first) and run_chunked(..., 16) (one a chunk) against
    flow.impl='torch', bit for bit."""
    frames = _stream_frames()
    stream = [frames[t % len(frames)] for t in range(64)]
    cfg = t_config.VideoConfig.fast()
    kernels.reset_launch_counts()
    pk = VideoPipeline(cfg, device=cuda_device)
    got = [pk.push(f) for f in stream]
    torch.cuda.synchronize()
    assert kernels.launch_counts()["oft_diff_features"] == len(stream) - 1
    pp = VideoPipeline(_plain(cfg), device=cuda_device)
    want = [pp.push(f) for f in stream]
    assert [g is None for g in got] == [w is None for w in want]
    _assert_same(_flat([g for g in got if g is not None]),
                 _flat([w for w in want if w is not None]))
    kernels.reset_launch_counts()
    chunked = _flat(VideoPipeline(cfg, device=cuda_device).run_chunked(stream, 16))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["oft_diff_features"] == len(stream) // 16
    _assert_same(chunked, _flat(VideoPipeline(_plain(cfg), device=cuda_device)
                                .run_chunked(stream, 16)))


@pytest.mark.cuda
def test_faithful_stream_through_f1_equals_plain(cuda_device):
    """VideoConfig() at 1080^2 over 320 frames with a reset at 300: the uint8
    planes through F1 (with W1, K1 and S1) against flow.impl='torch', every
    flow, vote count, centroid and flag equal bit for bit, the warped diff
    fed back all the way."""
    frames = _stream_frames()
    cfg = t_config.VideoConfig()
    pk, pp = VideoPipeline(cfg, device=cuda_device), VideoPipeline(_plain(cfg), device=cuda_device)
    kernels.reset_launch_counts()
    got, want = [], []
    for t in range(320):
        if t == 300:
            pk.reset()
            pp.reset()
        rk, rp = pk.push(frames[t % len(frames)]), pp.push(frames[t % len(frames)])
        assert (rk is None) == (rp is None)
        if rk is not None:
            got.append(rk)
            want.append(rp)
    assert len(got) == 320 - 4
    assert kernels.launch_counts()["oft_diff_features"] == 320 - 2
    _assert_same(_flat(got), _flat(want))
