"""W1, reference mode's symmetric gather warp (``kernels/remap_kernel.py``,
``csrc/remap.cu``), and the controller's route to it.

On the CPU the wrapper runs its plain version, ``symmetric_warp`` with
``impl='gather'``, and the controller sends the 'gather' warp to the
wrapper exactly where the kernel route is taken. The tests marked ``cuda``
hold the kernel against the plain version on the card bit for bit (max
|err| 0): the reference path's level shapes, batches, flows that carry taps
off every border, map coordinates on exact ties of the 5-bit fixed point,
the unquantized form, uint8 frames, and every vector width of the
launcher; and a 320-frame faithful stream through the kernels against the
plain path. This file imports no JAX, so the card runs it as it is.
"""

import dataclasses

import numpy as np
import pytest
import torch

from optical_flow_tpu_torch import config as t_config
from optical_flow_tpu_torch import kernels
from optical_flow_tpu_torch.flow.coarse_to_fine import coarse_to_fine_with_images
from optical_flow_tpu_torch.kernels import remap_kernel
from optical_flow_tpu_torch.kernels.remap_kernel import symmetric_remap_cuda
from optical_flow_tpu_torch.ops.warp import symmetric_warp


def _frames_and_flow(rng, shape, reach, dtype=torch.float32, device="cpu"):
    """Frames of ``shape`` and a flow of up to +-reach px: a smooth part and
    per-pixel noise, so the taps leave the frame at every border."""
    H, W = shape[-2:]
    lead = shape[:-2]
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    flows = []
    for k in range(2):
        smooth = np.sin(2 * np.pi * (xx + 0.5 * k)) * np.cos(2 * np.pi * (yy - 0.25 * k))
        f = 0.7 * smooth + 0.3 * rng.uniform(-1, 1, lead + (H, W))
        flows.append(torch.from_numpy((reach * f).astype(np.float32)).to(device))
    if dtype == torch.uint8:
        imgs = [torch.from_numpy(rng.randint(0, 256, shape).astype(np.uint8)).to(device)
                for _ in range(2)]
    else:
        imgs = [torch.from_numpy((rng.rand(*shape) * 255).astype(np.float32)).to(device)
                for _ in range(2)]
    return (*imgs, *flows)


def _ties(rng, shape, device="cpu"):
    """A flow whose every map coordinate x +- u/2, y +- v/2 lies exactly on a
    tie of the fixed point (an odd multiple of 1/64): u = (m + 0.5) / 16."""
    return tuple(
        torch.from_numpy(((rng.randint(-320, 320, shape) + 0.5) / 16).astype(np.float32)).to(device)
        for _ in range(2)
    )


# ---------------------------------------------------------------- on the CPU


@pytest.mark.parametrize("quantize", [True, False], ids=["quantized", "floor"])
@pytest.mark.parametrize(
    "shape, dtype",
    [((17, 23), torch.float32), ((2, 31, 40), torch.float32), ((1, 1), torch.float32),
     ((3, 5, 2), torch.float32), ((24, 36), torch.uint8)],
    ids=["17x23", "2x31x40", "1x1", "3x5x2", "uint8"],
)
def test_remap_wrapper_on_cpu_is_the_plain_warp(shape, dtype, quantize):
    rng = np.random.RandomState(1)
    img1, img2, u, v = _frames_and_flow(rng, shape, 40.0, dtype)
    before = kernels.launch_counts()
    got = symmetric_remap_cuda(img1, img2, u, v, quantize=quantize)
    assert kernels.launch_counts() == before
    want = symmetric_warp(img1, img2, u, v, quantize=quantize, impl="gather")
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    with pytest.raises(ValueError):
        symmetric_remap_cuda(img1, img2, u, v[..., :-1])


# (FlowConfig keywords, levels, W1 calls): the 'gather' warp goes to W1
# wherever the kernel route is taken (impl 'cuda' runs the wrapper's plain
# version on CPU tensors), once a level below the coarsest and once more a
# level for each extra pass; the shift forms and the plain route never call it
_ROUTES = [
    (dict(impl="cuda"), 4, 3),
    (dict(impl="torch"), 4, 0),
    (dict(impl="auto"), 4, 0),
    (dict(impl="cuda", mode="corrected", warp_clamp=8.0, warp_impl="gather", level_iters=2), 3, 5),
    (dict(impl="cuda", mode="corrected", warp_clamp=8.0, warp_impl="shift"), 3, 0),
    (dict(impl="cuda", mode="corrected", warp_clamp=8.0, warp_impl="shift_sep"), 3, 0),
]


@pytest.mark.parametrize("kw, levels, calls", _ROUTES,
                         ids=["cuda", "torch", "auto-on-cpu", "gather-iters2", "shift", "shift_sep"])
def test_controller_routes_the_gather_warp_to_w1(monkeypatch, kw, levels, calls):
    rng = np.random.RandomState(2)
    a, b, _, _ = _frames_and_flow(rng, (32, 48), 1.0)
    seen = []
    real = remap_kernel.symmetric_remap_cuda

    def counted(*args, **kwargs):
        seen.append(tuple(args[0].shape))
        return real(*args, **kwargs)

    monkeypatch.setattr(remap_kernel, "symmetric_remap_cuda", counted)
    cfg = t_config.FlowConfig(**kw)
    got = coarse_to_fine_with_images(a, b, levels, config=cfg)
    assert len(seen) == calls, seen
    want = coarse_to_fine_with_images(a, b, levels, config=dataclasses.replace(cfg, impl="torch"))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------- on the card (marked)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _counted_equal(img1, img2, u, v, quantize=True):
    before = kernels.launch_counts()["oft_remap"]
    got = symmetric_remap_cuda(img1, img2, u, v, quantize=quantize)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["oft_remap"] == before + 1
    want = symmetric_warp(img1, img2, u, v, quantize=quantize, impl="gather")
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert float((g - w).abs().max()) == 0.0 and torch.equal(g, w)


@pytest.mark.cuda
def test_remap_kernel_on_card_equals_plain(cuda_device):
    """The reference path's levels, batch 1 and 4, flows of up to +-40 px
    (taps off every border, negative map coordinates), both forms."""
    rng = np.random.RandomState(3)
    for shape in [(270, 270), (540, 540), (1080, 1080), (4, 270, 270), (4, 540, 540),
                  (4, 1080, 1080)]:
        for quantize in (True, False):
            _counted_equal(*_frames_and_flow(rng, shape, 40.0, device=cuda_device),
                           quantize=quantize)


@pytest.mark.cuda
def test_remap_kernel_on_card_rounds_ties_to_even(cuda_device):
    """Every map coordinate on an exact tie of map * 32 (x.5 / 32): the
    kernel rounds half to even, as torch.round does."""
    rng = np.random.RandomState(4)
    for shape in [(270, 270), (2, 540, 540), (1080, 1080)]:
        img1, img2, _, _ = _frames_and_flow(rng, shape, 1.0, device=cuda_device)
        u, v = _ties(rng, shape, cuda_device)
        _counted_equal(img1, img2, u, v)


@pytest.mark.cuda
def test_remap_kernel_on_card_widths_and_dtypes(cuda_device):
    """Each vector width of the launcher (4, 2 and 1 outputs a thread:
    widths by 4, by 2 and odd, and a flow 4 bytes past a 16-byte boundary),
    tiny planes and uint8 frames; inputs the kernel does not take raise."""
    rng = np.random.RandomState(5)
    for shape in [(2, 61, 37), (37, 59), (135, 270), (3, 7, 6), (1, 1), (1, 9), (9, 1)]:
        _counted_equal(*_frames_and_flow(rng, shape, 12.0, device=cuda_device))
    img1, img2, u, v = _frames_and_flow(rng, (64, 128), 12.0, device=cuda_device)
    uo = torch.empty(64 * 128 + 1, device=cuda_device)[1:].view(64, 128).copy_(u)
    assert uo.is_contiguous() and uo.data_ptr() % 16 == 4
    _counted_equal(img1, img2, uo, v)
    for quantize in (True, False):
        _counted_equal(*_frames_and_flow(rng, (2, 540, 540), 40.0, torch.uint8, cuda_device),
                       quantize=quantize)
    before = kernels.launch_counts()
    with pytest.raises(TypeError):
        symmetric_remap_cuda(img1, img2.to(torch.uint8), u, v)
    with pytest.raises(TypeError):
        symmetric_remap_cuda(img1, img2, u.double(), v)
    with pytest.raises(ValueError):  # not contiguous
        symmetric_remap_cuda(img1, img2, u.t().contiguous().t(), v)
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


@pytest.mark.cuda
def test_faithful_stream_through_w1_equals_plain(cuda_device):
    """VideoPipeline(VideoConfig()) at 1080^2 through the kernels (W1 three
    times a frame, K1, S1) against flow.impl='torch' over 320 frames with a
    reset at 300: every flow, vote count, centroid and flag equal bit for
    bit, the warped diff fed back all the way."""
    from optical_flow_tpu_torch.pipeline.video import VideoPipeline

    frames = _stream_frames()
    cfg = t_config.VideoConfig()
    plain = dataclasses.replace(cfg, flow=dataclasses.replace(cfg.flow, impl="torch"))
    pk, pp = VideoPipeline(cfg, device=cuda_device), VideoPipeline(plain, device=cuda_device)
    kernels.reset_launch_counts()
    results = 0
    for t in range(320):
        if t == 300:
            pk.reset()
            pp.reset()
        frame = frames[t % len(frames)]
        rk, rp = pk.push(frame), pp.push(frame)
        assert (rk is None) == (rp is None)
        if rk is None:
            continue
        results += 1
        assert torch.equal(rk.u, rp.u) and torch.equal(rk.v, rp.v), t
        for name in ("votes", "cx", "cy", "detected"):
            assert torch.equal(getattr(rk.gesture, name), getattr(rp.gesture, name)), (t, name)
    assert results == 320 - 4
    assert kernels.launch_counts()["oft_remap"] == 3 * results
