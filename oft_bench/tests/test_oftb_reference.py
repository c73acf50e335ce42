"""The frozen plain reference (``oft_bench/reference/``) against the
port's plain CPU path: stage by stage and the pipeline over a stream,
the fast preset at 96^2 (its kernel route, whose wrappers run their plain
versions on a CPU tensor) and the reference-parity uint8 chain at 48^2.
The reference is a copy of those plain versions, op for op, so the
results are equal bit for bit."""

import numpy as np
import pytest
import torch

from conftest import small_config
from oft_bench import frames
from oft_bench.harness import video_config
from oft_bench.reference import plain
from oft_bench.reference.stream import StreamReference, results_at
from optical_flow_tpu_torch.flow.lk import lucas_kanade_torch
from optical_flow_tpu_torch.kernels.warp_lk_kernel import pyrup_warp_lk_plain, warp_lk_plain
from optical_flow_tpu_torch.ops import pyramid as t_pyr
from optical_flow_tpu_torch.ops.warp import symmetric_warp
from optical_flow_tpu_torch.pipeline import gesture as t_gesture
from optical_flow_tpu_torch.pipeline import preprocess as t_pre
from optical_flow_tpu_torch.pipeline.video import VideoPipeline


def _planes(seed, shape, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(shape, generator=g) * scale).to(torch.float32)


def _eq(a, b):
    assert torch.equal(a, b), (a - b).abs().max()


@pytest.mark.parametrize("name", ["fast_1080", "faithful_1080"])
def test_preprocess_heads_and_diff_features_equal_the_port(name):
    cfg = small_config(name)
    pre = cfg["video"]["preprocess"]
    port_cfg = video_config(cfg["video"]).preprocess
    ring = frames.ring(3, tuple(cfg["frame_hw"]), n=3)
    ref = StreamReference(cfg["video"], "cpu")
    g = [ref.preprocess(torch.from_numpy(f)) for f in ring[:2]]
    want = [t_pre.preprocess_frame(torch.from_numpy(f), port_cfg) for f in ring[:2]]
    for a, b in zip(g, want):
        _eq(a, b)
    _eq(plain.diff_features(g[1], g[0], pre), t_pre.diff_features(want[1], want[0], port_cfg))


def test_pyramid_lk_warps_and_fused_steps_equal_the_port():
    a, b = _planes(1, (2, 48, 48), 255), _planes(2, (2, 48, 48), 255)
    pa, pt = plain.gaussian_pyramid(a, 4), t_pyr.gaussian_pyramid(a, 4)
    for x, y in zip(pa, pt):
        _eq(x, y)
    c = _planes(3, (2, 24, 24), 4) - 2
    _eq(plain.pyr_up(c), t_pyr.pyr_up(c))
    _eq(plain.pyr_up_cols_first(c), t_pyr.pyr_up_cols_first(c))
    for x, y in zip(plain.lucas_kanade(a, b), lucas_kanade_torch(a, b)):
        _eq(x, y)
    u, v = _planes(4, (2, 48, 48), 12) - 6, _planes(5, (2, 48, 48), 12) - 6
    for impl, C in (("gather", 0), ("shift_sep", 4)):
        for x, y in zip(plain.symmetric_warp(a, b, u, v, impl, C),
                        symmetric_warp(a, b, u, v, impl=impl, max_disp=C)):
            _eq(x, y)
    for x, y in zip(plain.warp_lk(a, b, u, v, 4, 8.0),
                    warp_lk_plain(a, b, u, v, max_disp=4, clamp=8.0)):
        _eq(x, y)
    uc, vc = u[..., ::2, ::2].contiguous(), v[..., ::2, ::2].contiguous()
    for x, y in zip(plain.pyrup_warp_lk(a, b, uc, vc, 4, 8.0),
                    pyrup_warp_lk_plain(a, b, uc, vc, max_disp=4, clamp=8.0)):
        _eq(x, y)
    g = plain.detect_gesture(u, v, {"mag_thresh": 2.0, "min_votes": 5, "circle_radius": 35,
                                    "norm_alpha": 255.0})
    tg = t_gesture.detect_gesture(u, v, t_gesture.GestureConfig(mag_thresh=2.0, min_votes=5))
    for x, y in zip(g, tg):
        _eq(x, y)


@pytest.mark.parametrize("name", ["fast_1080", "faithful_1080"])
def test_stream_equals_the_port_pipeline_bit_for_bit(name):
    """Ten frames through the port's ``push`` on the CPU and the
    reference's replay: every result equal, the faithful chain's warped
    diff fed back on both sides; ``results_at`` (the check's replay) gives
    the same results as the stream."""
    cfg = small_config(name)
    ring = frames.ring(5, tuple(cfg["frame_hw"]), n=10)
    pipe = VideoPipeline(video_config(cfg["video"]), device="cpu")
    ref = StreamReference(cfg["video"], "cpu")
    got = {}
    for i, f in enumerate(ring):
        p, r = pipe.push(f), ref.push(f)
        assert (p is None) == (r is None)
        if p is None:
            continue
        _eq(p.u, r[0])
        _eq(p.v, r[1])
        for x, y in zip(p.gesture, r[2]):
            _eq(x, y)
        got[i] = p
    assert len(got) == 8
    for j, r in results_at(cfg["video"], lambda i: ring[i], [3, 9, 6], "cpu"):
        _eq(got[j].u, r[0])
        _eq(got[j].v, r[1])


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -12,
                      float("inf"), -3.0])
    got = plain.round_tf32(x)
    want = torch.tensor([1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, 1.0, float("inf"), -3.0])
    assert torch.equal(got, want)
    y = plain.round_tf32(torch.randn(1000))
    bits = y.view(torch.int32) & 0x1FFF
    assert int(bits.abs().max()) == 0
    assert np.isclose(float((y - plain.round_tf32(y)).abs().max()), 0.0)
