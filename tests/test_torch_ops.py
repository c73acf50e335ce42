"""The PyTorch port's dense ops against the JAX package's, on identical
inputs made with numpy from a seed.

float64 (JAX runs with x64 here): bit-identical, since both sides do the
same IEEE operations in the same order. float32: bit-identical as well for
the elementwise ops; the bound where it is not is stated per test.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from optical_flow_tpu.ops import gradients as j_grad
from optical_flow_tpu.ops import pad as j_pad
from optical_flow_tpu.ops import pyramid as j_pyr
from optical_flow_tpu.ops import solve as j_solve
from optical_flow_tpu.ops import warp as j_warp
from optical_flow_tpu.ops import window as j_window
from optical_flow_tpu_torch.ops import gradients as t_grad
from optical_flow_tpu_torch.ops import pad as t_pad
from optical_flow_tpu_torch.ops import pyramid as t_pyr
from optical_flow_tpu_torch.ops import solve as t_solve
from optical_flow_tpu_torch.ops import warp as t_warp
from optical_flow_tpu_torch.ops import window as t_window


def _same(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.numpy())


def _pair(rng, shape, dtype):
    a = rng.rand(*shape).astype(dtype)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize(
    "shape,pads",
    [((5, 7), (2, 2, 2, 2)), ((2, 3, 4), (1, 0, 1, 0)), ((2, 2), (2, 2, 2, 2)), ((3, 5), (4, 4, 4, 4)),
     ((4, 3), (7, 9, 11, 6))],
)
def test_pad_last2(shape, pads, dtype):
    rng = np.random.RandomState(0)
    j, t = _pair(rng, shape, dtype)
    _same(j_pad.pad_last2(j, *pads, mode="reflect"), t_pad.pad_last2(t, *pads, mode="reflect"))
    _same(j_pad.pad_last2(j, *pads, mode="constant"), t_pad.pad_last2(t, *pads, mode="constant"))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gradients_window_solve(dtype):
    rng = np.random.RandomState(1)
    j1, t1 = _pair(rng, (2, 9, 11), dtype)
    j2, t2 = _pair(rng, (2, 9, 11), dtype)
    jg = j_grad.spatio_temporal_gradients(j1, j2)
    tg = t_grad.spatio_temporal_gradients(t1, t2)
    for a, b in zip(jg, tg):
        _same(a, b)
    js = j_window.sum3x3_interior(jg[0] * jg[2])
    ts = t_window.sum3x3_interior(tg[0] * tg[2])
    _same(js, ts)
    assert not ts[..., 0, :].any() and not ts[..., :, -1].any()  # exact-zero ring
    # det == 0 -> 0 (cv::divide), including the ring
    _same(j_solve.solve_lk_2x2(js, js, js, jg[1], jg[2])[0],
          t_solve.solve_lk_2x2(ts, ts, ts, tg[1], tg[2])[0])


def test_window_degenerate_and_safe_divide():
    x = np.arange(10.0).reshape(2, 5)
    _same(j_window.sum3x3_interior(jnp.asarray(x)), t_window.sum3x3_interior(torch.from_numpy(x)))
    num = np.array([1.0, -2.0, 0.0, 3.0])
    den = np.array([0.0, 4.0, 0.0, -0.5])
    _same(j_solve.safe_divide(jnp.asarray(num), jnp.asarray(den)),
          t_solve.safe_divide(torch.from_numpy(num), torch.from_numpy(den)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", [(64, 96), (41, 130), (2, 3, 7), (2, 2), (1, 5)])
def test_pyr_down_poly(shape, dtype):
    rng = np.random.RandomState(2)
    j, t = _pair(rng, shape, dtype)
    _same(j_pyr.pyr_down(j), t_pyr.pyr_down(t))
    _same(j_pyr.pyr_down(j), t_pyr.pyr_down(t, impl="auto"))  # CPU tensor: 'poly'


def test_pyr_down_promotes_integers():
    x = (np.random.RandomState(3).rand(9, 12) * 255).astype(np.uint8)
    got = t_pyr.pyr_down(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _same(j_pyr.pyr_down(jnp.asarray(x)), got)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", [(5, 7), (1, 3), (2, 4, 6)])
def test_pyr_up_both_orders(shape, dtype):
    rng = np.random.RandomState(4)
    j, t = _pair(rng, shape, dtype)
    _same(j_pyr.pyr_up(j), t_pyr.pyr_up(t))
    _same(j_pyr.pyr_up_cols_first(j), t_pyr.pyr_up_cols_first(t))


def test_gaussian_pyramid_and_levels():
    rng = np.random.RandomState(5)
    j, t = _pair(rng, (120, 120), np.float32)
    for a, b in zip(j_pyr.gaussian_pyramid(j, 4), t_pyr.gaussian_pyramid(t, 4)):
        _same(a, b)
    for shape in [(1080, 1080), (640, 448), (120, 120), (7, 8)]:
        assert t_pyr.max_pyramid_levels(shape) == j_pyr.max_pyramid_levels(shape)
    with pytest.raises(ValueError):
        t_pyr.max_pyramid_levels((0, 4))
    with pytest.raises(ValueError):
        t_pyr.pyr_down(t, impl="mxu")


def test_quantize_disp_rounds_half_to_even():
    # exact halves of the 1/32 grid: round-half-to-even (not away from 0)
    d = np.array([k / 64.0 for k in range(-300, 301, 7)] + [1 / 64, 3 / 64, -1 / 64, 9.9, -9.9],
                 np.float32)
    for C in (4, 5):
        _same(j_warp.quantize_disp(jnp.asarray(d), C), t_warp.quantize_disp(torch.from_numpy(d), C))
        _same(j_warp.quantize_disp(jnp.asarray(d), C, quantize=False),
              t_warp.quantize_disp(torch.from_numpy(d), C, quantize=False))


def _flow(rng, shape, scale, dtype):
    u = (rng.randn(*shape) * scale).astype(dtype)
    v = (rng.randn(*shape) * scale).astype(dtype)
    return (jnp.asarray(u), jnp.asarray(v)), (torch.from_numpy(u), torch.from_numpy(v))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize(
    "impl,max_disp,quantize",
    [("shift_sep", 4, True), ("shift_sep", 2, False), ("gather", 0, True), ("gather", 0, False),
     ("shift", 5, True), ("shift", 3, False)],
)
def test_symmetric_warp(impl, max_disp, quantize, dtype):
    rng = np.random.RandomState(6)
    j1, t1 = _pair(rng, (2, 17, 23), dtype)
    j2, t2 = _pair(rng, (2, 17, 23), dtype)
    (ju, jv), (tu, tv) = _flow(rng, (17, 23), 3.0, np.float32)
    kw = dict(quantize=quantize, impl=impl, max_disp=max_disp)
    for a, b in zip(j_warp.symmetric_warp(j1, j2, ju, jv, **kw),
                    t_warp.symmetric_warp(t1, t2, tu, tv, **kw)):
        _same(a, b)


def test_warp_integer_promotion_and_errors():
    rng = np.random.RandomState(7)
    img = (rng.rand(12, 14) * 255).astype(np.uint8)
    (ju, jv), (tu, tv) = _flow(rng, (12, 14), 2.0, np.float32)
    for impl, md in (("shift_sep", 3), ("gather", 0), ("shift", 4)):
        got = t_warp.symmetric_warp(torch.from_numpy(img), torch.from_numpy(img), tu, tv,
                                    impl=impl, max_disp=md)
        assert got[0].dtype == torch.float32
        _same(j_warp.symmetric_warp(jnp.asarray(img), jnp.asarray(img), ju, jv, impl=impl,
                                    max_disp=md)[0], got[0])
    # remap_bilinear on an integer source rounds and saturates back, like cv2
    xs = np.tile(np.arange(14, dtype=np.float32), (12, 1)) + 0.37
    ys = np.tile(np.arange(12, dtype=np.float32)[:, None], (1, 14)) - 0.21
    _same(j_warp.remap_bilinear(jnp.asarray(img), jnp.asarray(xs), jnp.asarray(ys)),
          t_warp.remap_bilinear(torch.from_numpy(img), torch.from_numpy(xs), torch.from_numpy(ys)))
    t = torch.from_numpy(img.astype(np.float32))
    with pytest.raises(ValueError):
        t_warp.symmetric_warp(t, t, tu, tv, impl="shift_sep", max_disp=0)
    # the exact shift warp is ported; the round-5 rule stands: no reach, no warp
    with pytest.raises(ValueError):
        t_warp.symmetric_warp(t, t, tu, tv, impl="shift", max_disp=0)
    with pytest.raises(ValueError):
        t_warp.symmetric_warp(t, t, tu, tv, impl="nearest", max_disp=3)


# ------------------------------------------------------- the exact 'shift' warp
# float64 (JAX x64) and float32: bit for bit; both sides do the same IEEE
# operations in the same order (the bar of the f64 oracle paths is <= 1e-9).


def _maps(rng, shape, reach):
    """Absolute sample coordinates identity + d, |d| up to `reach` px (some
    beyond it, to exercise the clamp), float32 like the reference's maps."""
    H, W = shape
    xs = np.arange(W, dtype=np.float32)[None, :] + (rng.randn(H, W) * reach / 2).astype(np.float32)
    ys = np.arange(H, dtype=np.float32)[:, None] + (rng.randn(H, W) * reach / 2).astype(np.float32)
    return xs, ys


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("quantize", [True, False])
def test_shift_disp_fields(quantize, dtype):
    rng = np.random.RandomState(8)
    mx, my = _maps(rng, (13, 19), 4.0)
    # global coordinates of a tile at (40, 64): what the tiled warp passes
    xs = np.arange(64, 64 + 19, dtype=np.float32)[None, :]
    ys = np.arange(40, 40 + 13, dtype=np.float32)[:, None]
    j = j_warp.shift_disp_fields(jnp.asarray(mx + 64), jnp.asarray(my + 40), jnp.asarray(xs),
                                 jnp.asarray(ys), 3, quantize=quantize, dtype=dtype)
    t = t_warp.shift_disp_fields(torch.from_numpy(mx + 64), torch.from_numpy(my + 40),
                                 torch.from_numpy(xs), torch.from_numpy(ys), 3, quantize=quantize,
                                 dtype=getattr(torch, np.dtype(dtype).name))
    for a, b in zip(j, t):
        _same(a, b)
    assert float(t[0].abs().max()) <= 3.0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("C", [1, 4])
def test_shift_warp_sum(C, dtype):
    rng = np.random.RandomState(9)
    jp, tp = _pair(rng, (2, 11 + 2 * C + 2, 14 + 2 * C + 2), dtype)
    dx = np.clip(rng.randn(11, 14) * C, -C, C).astype(dtype)
    dy = np.clip(rng.randn(11, 14) * C, -C, C).astype(dtype)
    _same(j_warp.shift_warp_sum(jp, jnp.asarray(dx), jnp.asarray(dy), C),
          t_warp.shift_warp_sum(tp, torch.from_numpy(dx), torch.from_numpy(dy), C))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("separable", [False, True])
@pytest.mark.parametrize("quantize", [True, False])
def test_remap_bilinear_shift(quantize, separable, dtype):
    rng = np.random.RandomState(10)
    j, t = _pair(rng, (2, 15, 21), dtype)
    mx, my = _maps(rng, (15, 21), 4.0)
    kw = dict(quantize=quantize, separable=separable)
    _same(j_warp.remap_bilinear_shift(j, jnp.asarray(mx), jnp.asarray(my), 4, **kw),
          t_warp.remap_bilinear_shift(t, torch.from_numpy(mx), torch.from_numpy(my), 4, **kw))


def test_shift_warp_equals_gather_within_reach():
    """Inside its reach the exact shift warp takes the gather warp's taps
    and weights in another sum order: within 1e-5 on unit-range images
    (tests/test_ops.py:210-238)."""
    rng = np.random.RandomState(11)
    a, b = (torch.from_numpy(rng.rand(2, 24, 30).astype(np.float32)) for _ in range(2))
    u, v = (torch.from_numpy(np.clip(rng.randn(24, 30) * 3, -8, 8).astype(np.float32))
            for _ in range(2))
    for q in (True, False):
        g = t_warp.symmetric_warp(a, b, u, v, impl="gather", quantize=q)
        s = t_warp.symmetric_warp(a, b, u, v, impl="shift", max_disp=5, quantize=q)
        for x, y in zip(g, s):
            assert float((x - y).abs().max()) <= 1e-5
