"""The port's kernel modules against the JAX package's, one module per
kernel. On the CPU each wrapper (``*_cuda``) runs its plain PyTorch version;
that is held against the JAX Pallas kernel in interpret mode and against
the JAX jnp composition, at the JAX suite's own tolerances:

  K1 lk             atol 1e-5 vs interpret (tests/test_kernels.py:35-57)
  K2 pyr_down       atol 2e-3 vs the Pallas kernel (MXU column numerics)
                    and vs 'poly' (tests/test_kernels.py:100-101)
  K3 pyrup_warp_lk  median < 3e-4, q95 < 0.05 (tests/test_pyrup_warp_lk.py:48-68)
  K4 warp_lk        atol 2e-5 on well-conditioned pixels
                    (tests/test_warp_lk_kernel.py:61-106)

The tests marked ``cuda`` hold each kernel against its plain version on a
card (K2 and P1 bit for bit); they skip where there is none (run them with
``python -m pytest -m cuda tests/test_torch_*.py`` on a GPU host).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from optical_flow_tpu.flow.lk import lucas_kanade_jnp
from optical_flow_tpu.ops.pyramid import pyr_down as j_pyr_down
from optical_flow_tpu.ops.pyramid import pyr_up_cols_first as j_pyr_up_cf
from optical_flow_tpu.ops.warp import symmetric_warp as j_symmetric_warp
from optical_flow_tpu_torch.kernels import launch_counts
from optical_flow_tpu_torch.kernels.lk_kernel import lucas_kanade_cuda, lucas_kanade_plain
from optical_flow_tpu_torch.kernels.pyrdown_kernel import (
    gaussian_pyramid_cuda,
    pyr_down_cuda,
    pyr_down_plain,
)
from optical_flow_tpu_torch.kernels.tile_copy_kernel import tile_copy_cuda, tile_copy_plain
from optical_flow_tpu_torch.kernels.warp_lk_kernel import (
    pyrup_warp_lk_cuda,
    pyrup_warp_lk_plain,
    warp_lk_cuda,
    warp_lk_plain,
)


def _interpret(fn, *args, **kw):
    """A JAX Pallas kernel in interpret mode; skip where this jax lacks it."""
    from jax.experimental.pallas import tpu as pltpu

    try:
        with pltpu.force_tpu_interpret_mode():
            return fn(*args, **kw)
    except NotImplementedError as e:
        pytest.skip(f"pallas interpret unsupported here: {e}")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _np(x):
    return np.array(x, np.float32)


def _flow(rng, shape, scale):
    """Smooth flow as tests/test_warp_lk_kernel.py:52-58 makes it."""
    H, W = shape[-2:]
    coarse = rng.randn(*shape[:-2], max(H // 8, 1), max(W // 8, 1), 2)
    f = jax.image.resize(jnp.asarray(coarse, jnp.float32), shape + (2,), "linear")
    f = f * scale + jnp.asarray(rng.randn(2) * scale, jnp.float32)
    return _np(f[..., 0]), _np(f[..., 1])


def _well_conditioned(w1, w2):
    """tests/test_warp_lk_kernel.py:61-81 on the planes the solve sees."""
    from optical_flow_tpu.ops.gradients import spatio_temporal_gradients
    from optical_flow_tpu.ops.window import sum3x3_interior

    fx, fy, _ = spatio_temporal_gradients(w1, w2)
    s = sum3x3_interior(jnp.stack([fx * fx, fy * fy, fx * fy], axis=0))
    det = s[0] * s[1] - s[2] * s[2]
    return np.asarray(jnp.abs(det) > 1e-6 * jnp.maximum(jnp.max(jnp.abs(det)), 1.0))


def _close_where(ok, a, b, atol, rtol=1e-7):
    z = np.zeros((), np.float32)
    np.testing.assert_allclose(np.where(ok, _np(a), z), np.where(ok, _np(b), z), atol=atol,
                               rtol=rtol)


# ---------------------------------------------------------------- K1: lk


# Shapes that leave partial warps and strips of the CUDA kernel (29 or 60
# columns a warp, strips of 2 or 4 rows, 4 strips a block), and the smallest
# planes.
_K1_RAGGED = [(2, 135, 271), (3, 3), (3, 7), (2, 7, 57), (9, 60), (15, 31), (17, 87), (28, 29),
              (31, 59), (33, 30)]


@pytest.mark.parametrize(
    "shape",
    [pytest.param(s, id=f"shape{i}") for i, s in enumerate([(64, 128), (37, 53), (96, 200), (3, 40, 64)])]
    + [pytest.param(s, id="x".join(map(str, s))) for s in _K1_RAGGED],
)
def test_lk_plain_matches_jax(shape):
    from optical_flow_tpu.kernels.lk_kernel import lucas_kanade_pallas

    rng = np.random.RandomState(5)
    a = rng.rand(*shape).astype(np.float32)
    b = rng.rand(*shape).astype(np.float32)
    u, v = lucas_kanade_cuda(_t(a), _t(b))  # CPU tensors: the plain version
    u0, v0 = lucas_kanade_jnp(jnp.asarray(a), jnp.asarray(b))
    ok = _well_conditioned(jnp.asarray(a), jnp.asarray(b))
    _close_where(ok, u, u0, 2e-5)
    _close_where(ok, v, v0, 2e-5)
    u1, v1 = _interpret(lucas_kanade_pallas, jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(_np(u), _np(u1), atol=1e-5)
    np.testing.assert_allclose(_np(v), _np(v1), atol=1e-5)


def test_lk_degenerate_level_is_zero():
    a = torch.ones(2, 2)
    u, v = lucas_kanade_cuda(a, a)
    assert not u.any() and not v.any()
    with pytest.raises(ValueError):
        lucas_kanade_cuda(torch.ones(4, 4), torch.ones(4, 5))


# ------------------------------------------------------------ K2: pyr_down


@pytest.mark.parametrize("shape", [(64, 96), (2, 256, 256), (1, 135, 271), (41, 130)])
def test_pyrdown_plain_matches_jax(shape):
    from optical_flow_tpu.kernels.pyrdown_kernel import pyr_down_pallas

    rng = np.random.RandomState(9)
    x = (rng.rand(*shape) * 255).astype(np.float32)
    got = _np(pyr_down_cuda(_t(x)))
    poly = _np(j_pyr_down(jnp.asarray(x)))
    assert got.shape == poly.shape
    np.testing.assert_allclose(got, poly, atol=2e-3)
    np.testing.assert_allclose(got, _np(_interpret(pyr_down_pallas, jnp.asarray(x))), atol=2e-3)


# ------------------------------------------------------- K3: pyrup_warp_lk

CLAMP, C = 8.0, 4  # the production operating point (warp_clamp=8 -> max_disp 4)


def _j_pyrup_unfused(img1, img2, uc, vc, max_disp=C, clamp=CLAMP):
    upu = 2.0 * j_pyr_up_cf(uc)
    upv = 2.0 * j_pyr_up_cf(vc)
    wu, wv = -jnp.clip(upu, -clamp, clamp), -jnp.clip(upv, -clamp, clamp)
    w1, w2 = j_symmetric_warp(img1, img2, wu, wv, quantize=True, impl="shift_sep",
                              max_disp=max_disp)
    du, dv = lucas_kanade_jnp(w1, w2)
    return du + upu, dv + upv


def _quantiles_ok(a, b, atol=3e-4):
    d = np.abs(_np(a) - _np(b))
    assert np.median(d) < atol, np.median(d)
    assert np.quantile(d, 0.95) < 0.05, np.quantile(d, 0.95)


# Geometries that leave partial blocks of the CUDA kernel's tiles (29 columns,
# 32 or 64 rows), at tap reaches C = 1 and 8 (clamp 2C, the coarse flow scaled
# by 1.5 C so that the quantized half-flow reaches +-C).
_K3_RAGGED = [(2, 270, 270), (2, 134, 198), (52, 38)]


@pytest.mark.parametrize(
    "shape,max_disp,scale",
    [pytest.param(s, C, 2.0, id=f"shape{i}")
     for i, s in enumerate([(64, 96), (48, 40), (2, 32, 130), (52, 38)])]
    + [pytest.param(s, md, 1.5 * md, id=f"{'x'.join(map(str, s))}-C{md}")
       for md in (1, 8) for s in _K3_RAGGED],
)
def test_pyrup_warp_lk_plain_matches_jax(shape, max_disp, scale):
    from optical_flow_tpu.kernels.warp_lk_kernel import pyrup_warp_lk_pallas

    H, W = shape[-2:]
    clamp = 2.0 * max_disp
    rng = np.random.RandomState(0)
    img1 = rng.rand(*shape).astype(np.float32)
    img2 = rng.rand(*shape).astype(np.float32)
    cshape = shape[:-2] + (H // 2, W // 2)
    uc = (rng.randn(*cshape) * scale).astype(np.float32)
    vc = (rng.randn(*cshape) * scale).astype(np.float32)
    u, v = pyrup_warp_lk_cuda(_t(img1), _t(img2), _t(uc), _t(vc), max_disp=max_disp, clamp=clamp)
    j = [jnp.asarray(x) for x in (img1, img2, uc, vc)]
    u0, v0 = _j_pyrup_unfused(*j, max_disp=max_disp, clamp=clamp)
    _quantiles_ok(u, u0)
    _quantiles_ok(v, v0)
    u1, v1 = _interpret(pyrup_warp_lk_pallas, *j, max_disp=max_disp, clamp=clamp)
    _quantiles_ok(u, u1)
    _quantiles_ok(v, v1)


def test_pyrup_warp_lk_zero_coarse_flow_is_plain_lk():
    rng = np.random.RandomState(5)
    img1, img2 = _t(rng.rand(64, 72)), _t(rng.rand(64, 72))
    z = torch.zeros(32, 36)
    u, v = pyrup_warp_lk_cuda(img1, img2, z, z, max_disp=C, clamp=CLAMP)
    u0, v0 = lucas_kanade_jnp(jnp.asarray(img1.numpy()), jnp.asarray(img2.numpy()))
    np.testing.assert_allclose(_np(u), _np(u0), atol=2e-5)
    np.testing.assert_allclose(_np(v), _np(v0), atol=2e-5)
    with pytest.raises(ValueError):  # coarse flow not the exact half
        pyrup_warp_lk_cuda(img1, img2, torch.zeros(32, 35), torch.zeros(32, 35),
                           max_disp=C, clamp=CLAMP)


# ------------------------------------------------------------- K4: warp_lk


def _j_warp_lk_unfused(img1, img2, u, v, *, max_disp, clamp, negate):
    wu, wv = jnp.clip(u, -clamp, clamp), jnp.clip(v, -clamp, clamp)
    if negate:
        wu, wv = -wu, -wv
    w1, w2 = j_symmetric_warp(img1, img2, wu, wv, quantize=True, impl="shift_sep",
                              max_disp=max_disp)
    return lucas_kanade_jnp(w1, w2), (w1, w2)


@pytest.mark.parametrize(
    "shape,max_disp,clamp,negate,scale,seed",
    [
        ((64, 96), 5, 8.0, True, 2.0, 0),
        ((2, 32, 130), 5, 8.0, True, 2.0, 0),
        ((61, 37), 5, 8.0, True, 2.0, 0),  # odd H and W
        ((40, 64), 5, 8.0, True, 30.0, 3),  # flow beyond the clamp
        ((32, 48), 3, 4.0, False, 1.5, 7),  # reference (non-negated) direction
        # ragged for the CUDA kernel's tiles, at C = 1 and 8 (|k| reaches C)
        ((2, 61, 37), 1, 2.0, True, 3.0, 11),
        ((2, 61, 37), 8, 16.0, True, 24.0, 11),
        ((1080, 1000), 1, 2.0, True, 3.0, 12),
        ((1080, 1000), 8, 16.0, True, 24.0, 12),
    ],
)
def test_warp_lk_plain_matches_jax(shape, max_disp, clamp, negate, scale, seed):
    from optical_flow_tpu.kernels.warp_lk_kernel import warp_lk_pallas

    rng = np.random.RandomState(seed)
    img1 = rng.rand(*shape).astype(np.float32)
    img2 = rng.rand(*shape).astype(np.float32)
    u, v = _flow(rng, shape, scale)
    kw = dict(max_disp=max_disp, clamp=clamp, negate=negate)
    du, dv = warp_lk_cuda(_t(img1), _t(img2), _t(u), _t(v), **kw)
    j = [jnp.asarray(x) for x in (img1, img2, u, v)]
    (du0, dv0), warped = _j_warp_lk_unfused(*j, **kw)
    ok = _well_conditioned(*warped)
    assert ok.mean() > 0.5  # the mask must not hide real divergence
    _close_where(ok, du, du0, 2e-5)
    _close_where(ok, dv, dv0, 2e-5)
    du1, dv1 = _interpret(warp_lk_pallas, *j, **kw)
    if max_disp > 5:
        # A reach beyond the production clamp (C = 8) warps the random frames
        # by up to 8 px and LK's outputs reach tens of px (float32's spacing
        # at 32 px is 3.8e-6), so the Pallas kernel is held at 2e-6 relative
        # too, and away from the frame's first three rows and columns: there
        # its REFLECT_101 fix departs from its own jnp composition (which the
        # port equals) by up to 1e-3 at this reach (ROADMAP.md, Queue 3).
        ok = ok.copy()
        ok[..., :3, :] = False
        ok[..., :, :3] = False
        _close_where(ok, du, du1, 2e-5, 2e-6)
        _close_where(ok, dv, dv1, 2e-5, 2e-6)
    else:
        _close_where(ok, du, du1, 2e-5)
        _close_where(ok, dv, dv1, 2e-5)


def test_warp_lk_zero_flow_is_plain_lk():
    rng = np.random.RandomState(5)
    img1, img2 = _t(rng.rand(64, 72)), _t(rng.rand(64, 72))
    z = torch.zeros(64, 72)
    du, dv = warp_lk_cuda(img1, img2, z, z, max_disp=5, clamp=8.0)
    u0, v0 = lucas_kanade_jnp(jnp.asarray(img1.numpy()), jnp.asarray(img2.numpy()))
    np.testing.assert_allclose(_np(du), _np(u0), atol=2e-5)
    np.testing.assert_allclose(_np(dv), _np(v0), atol=2e-5)


def test_cpu_wrappers_launch_nothing():
    before = launch_counts()
    x = torch.rand(16, 16)
    lucas_kanade_cuda(x, x)
    pyr_down_cuda(x)
    gaussian_pyramid_cuda(x, 3)
    tile_copy_cuda(x)
    warp_lk_cuda(x, x, x, x, max_disp=2, clamp=4.0)
    pyrup_warp_lk_cuda(x, x, x[:8, :8].contiguous(), x[:8, :8].contiguous(), max_disp=2, clamp=4.0)
    assert launch_counts() == before


# ---------------------------------------------------- on the card (marked)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _on(dev, rng, *shape, scale=1.0):
    return torch.from_numpy((rng.rand(*shape) * scale).astype(np.float32)).to(dev)


def _counted(name, fn):
    before = launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    assert launch_counts()[name] == before + 1
    return out


def _masked_equal(ok, a, b, atol):
    z = torch.zeros((), device=a.device)
    torch.testing.assert_close(torch.where(ok, a, z), torch.where(ok, b, z), atol=atol, rtol=0)


def _ok_mask(w1, w2):
    from optical_flow_tpu_torch.ops.gradients import spatio_temporal_gradients
    from optical_flow_tpu_torch.ops.window import sum3x3_interior

    fx, fy, _ = spatio_temporal_gradients(w1, w2)
    s = sum3x3_interior(torch.stack([fx * fx, fy * fy, fx * fy]))
    det = s[0] * s[1] - s[2] * s[2]
    return det.abs() > 1e-6 * torch.clamp_min(det.abs().max(), 1.0)


@pytest.mark.cuda
def test_lk_kernel_on_card(cuda_device):
    """Both sides of the launcher's strip rule: 2-row strips of one column a
    lane (small grids), 4-row strips of two (a 1080^2 grid or a batch that
    large; 8-byte accesses at even widths), with partial warps and blocks."""
    rng = np.random.RandomState(1)
    big = [(1080, 1080), (1, 1080, 1000), (1, 1081, 1001), (1, 1089, 1021), (1, 1087, 1022),
           (32, 127, 119), (32, 129, 120)]
    for shape in [(2, 135, 135), (540, 540)] + _K1_RAGGED + big:
        a, b = _on(cuda_device, rng, *shape), _on(cuda_device, rng, *shape)
        u0, v0 = lucas_kanade_plain(a, b)
        ok = _ok_mask(a, b)
        u, v = _counted("oft_lk", lambda: lucas_kanade_cuda(a, b))
        _masked_equal(ok, u, u0, 0.0)
        _masked_equal(ok, v, v0, 0.0)


@pytest.mark.cuda
def test_pyrdown_kernel_on_card(cuda_device):
    rng = np.random.RandomState(2)
    for shape in [(2, 1080, 1080), (135, 271), (3, 7)]:
        x = _on(cuda_device, rng, *shape, scale=255.0)
        got = _counted("oft_pyrdown", lambda: pyr_down_cuda(x))
        torch.testing.assert_close(got, pyr_down_plain(x), atol=0, rtol=0)


@pytest.mark.cuda
def test_tile_copy_kernel_on_card(cuda_device):
    """P1 equals ``clone`` bit for bit: float4 body and scalar tail, and a
    storage offset of 1 (not 16-byte aligned: the 64-bit grid-stride loop)."""
    rng = np.random.RandomState(5)
    for n in (1, 3, 1024, 1027):
        x = _on(cuda_device, rng, n)
        torch.testing.assert_close(_counted("oft_tile_copy", lambda: tile_copy_cuda(x)),
                                   tile_copy_plain(x), atol=0, rtol=0)
    x = _on(cuda_device, rng, 1028)[1:]
    assert x.is_contiguous() and x.storage_offset() == 1
    torch.testing.assert_close(_counted("oft_tile_copy", lambda: tile_copy_cuda(x)),
                               tile_copy_plain(x), atol=0, rtol=0)


# the ragged and C sweep on the card: (shape, C), clamp 2C, flows that reach C
_SWEEP_C = (1, 4, 8)
_K4_RAGGED = [(2, 61, 37), (1080, 1000)]


@pytest.mark.cuda
def test_pyrup_warp_lk_kernel_on_card(cuda_device):
    """K3 follows its plain version operation for operation: max |err| 0 on
    the well-conditioned pixels, at the main path's shape and the ragged
    and C sweep (both strip heights of the kernel's tile)."""
    from optical_flow_tpu_torch.ops.pyramid import pyr_up_cols_first
    from optical_flow_tpu_torch.ops.warp import symmetric_warp

    rng = np.random.RandomState(3)
    cases = [((540, 540), C, 8.0), ((52, 38), C, 8.0)]
    cases += [(s, md, 4.0 * md) for md in _SWEEP_C for s in _K3_RAGGED]
    for shape, md, scale in cases:
        cl = 2.0 * md
        cshape = shape[:-2] + (shape[-2] // 2, shape[-1] // 2)
        a, b = _on(cuda_device, rng, *shape), _on(cuda_device, rng, *shape)
        uc = (_on(cuda_device, rng, *cshape) - 0.5) * scale
        vc = (_on(cuda_device, rng, *cshape) - 0.5) * scale
        u, v = _counted("oft_pyrup_warp_lk",
                        lambda: pyrup_warp_lk_cuda(a, b, uc, vc, max_disp=md, clamp=cl))
        u0, v0 = pyrup_warp_lk_plain(a, b, uc, vc, max_disp=md, clamp=cl)
        upu, upv = 2.0 * pyr_up_cols_first(uc), 2.0 * pyr_up_cols_first(vc)
        w1, w2 = symmetric_warp(a, b, -upu.clamp(-cl, cl), -upv.clamp(-cl, cl),
                                impl="shift_sep", max_disp=md)
        ok = _ok_mask(w1, w2)
        _masked_equal(ok, u, u0, 0.0)
        _masked_equal(ok, v, v0, 0.0)


@pytest.mark.cuda
def test_warp_lk_kernel_on_card(cuda_device):
    """K4, as K3: max |err| 0 on the well-conditioned pixels."""
    from optical_flow_tpu_torch.ops.warp import symmetric_warp

    rng = np.random.RandomState(4)
    cases = [((1080, 1080), 4, 8.0, 12.0), ((2, 61, 37), 5, 8.0, 12.0)]
    cases += [(s, md, 2.0 * md, 6.0 * md) for md in _SWEEP_C for s in _K4_RAGGED]
    for shape, md, cl, scale in cases:
        a, b = _on(cuda_device, rng, *shape), _on(cuda_device, rng, *shape)
        u = (_on(cuda_device, rng, *shape) - 0.5) * scale
        v = (_on(cuda_device, rng, *shape) - 0.5) * scale
        du, dv = _counted("oft_warp_lk",
                          lambda: warp_lk_cuda(a, b, u, v, max_disp=md, clamp=cl))
        du0, dv0 = warp_lk_plain(a, b, u, v, max_disp=md, clamp=cl)
        w1, w2 = symmetric_warp(a, b, -u.clamp(-cl, cl), -v.clamp(-cl, cl),
                                impl="shift_sep", max_disp=md)
        ok = _ok_mask(w1, w2)
        _masked_equal(ok, du, du0, 0.0)
        _masked_equal(ok, dv, dv0, 0.0)


@pytest.mark.cuda
def test_warp_lk_kernels_refuse_a_reach_beyond_shared_memory(cuda_device):
    """A block's shared memory grows with C; a C whose block does not fit
    raises and launches nothing (no smaller tile is taken instead)."""
    a = torch.rand(64, 64, device=cuda_device)
    c = torch.rand(32, 32, device=cuda_device)
    before = launch_counts()
    with pytest.raises(RuntimeError):
        warp_lk_cuda(a, a, a, a, max_disp=64, clamp=128.0)
    with pytest.raises(RuntimeError):
        pyrup_warp_lk_cuda(a, a, c, c, max_disp=64, clamp=128.0)
    assert launch_counts() == before
