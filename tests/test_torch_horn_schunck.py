"""The port's Horn–Schunck (optical_flow_tpu_torch/flow/horn_schunck.py)
against the JAX package's, on identical numpy inputs made from a seed.

float64 (JAX x64): within 1e-9, the single level and the corrected
pyramid with each warp; float32: the slice's bar (median < 1e-3 px, q99 <
0.02 px). On the port alone: the 3 px translation bar of
tests/test_horn_schunck.py:72-91. The test marked ``cuda`` holds the card
against the port's CPU result and skips where there is none.
"""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from optical_flow_tpu_torch import convert

j_hs = importlib.import_module("optical_flow_tpu.flow.horn_schunck")
t_hs = importlib.import_module("optical_flow_tpu_torch.flow.horn_schunck")


def _texture(h, w, seed, sigma=2.0):
    rng = np.random.RandomState(seed)
    fy, fx = np.fft.fftfreq(h)[:, None], np.fft.fftfreq(w)[None, :]
    g = np.exp(-2.0 * (np.pi * sigma) ** 2 * (fx * fx + fy * fy))
    t = np.real(np.fft.ifft2(np.fft.fft2(rng.rand(h, w)) * g))
    return (t - t.min()) / (t.max() - t.min())


def _pair(dtype, shape=(64, 80), seed=0, roll=(1, 2)):
    a = _texture(*shape, seed).astype(dtype)
    return a, np.roll(a, roll, (0, 1)).astype(dtype)


def _max_diff(j, t):
    return max(float(np.abs(np.asarray(x) - y.numpy()).max()) for x, y in zip(j, t))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_neighbor_avg_matches_jax(dtype):
    x = np.random.RandomState(1).rand(2, 9, 13).astype(dtype)
    np.testing.assert_array_equal(t_hs._neighbor_avg(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_hs._neighbor_avg(jnp.asarray(x))))


@pytest.mark.parametrize("alpha", [1.0, 0.3])
def test_single_level_matches_jax_f64(alpha):
    a, b = _pair(np.float64)
    cfg = dict(alpha=alpha, iters=40, levels=1)
    j = j_hs.horn_schunck(jnp.asarray(a), jnp.asarray(b), j_hs.HornSchunckConfig(**cfg))
    t = t_hs.horn_schunck(a, b, t_hs.HornSchunckConfig(**cfg), device="cpu")
    assert t[0].dtype == torch.float64 and t[0].shape == (64, 80)
    assert _max_diff(j, t) <= 1e-9


@pytest.mark.parametrize("warp_impl", ["gather", "shift_sep", "shift"])
def test_pyramid_matches_jax_f64(warp_impl):
    a, b = _pair(np.float64, roll=(2, 3))
    cfg = dict(alpha=0.5, iters=30, levels=3, warp_clamp=8.0, warp_impl=warp_impl)
    j = j_hs.horn_schunck(jnp.asarray(a), jnp.asarray(b), j_hs.HornSchunckConfig(**cfg))
    t = t_hs.horn_schunck(torch.from_numpy(a), torch.from_numpy(b), t_hs.HornSchunckConfig(**cfg))
    assert _max_diff(j, t) <= 1e-9


@pytest.mark.parametrize("levels", [1, 3])
def test_matches_jax_f32(levels):
    a, b = _pair(np.float32, roll=(2, 3))
    jcfg = j_hs.HornSchunckConfig(alpha=0.5, iters=30, levels=levels, warp_impl="shift_sep")
    j = j_hs.horn_schunck(jnp.asarray(a), jnp.asarray(b), jcfg)
    t = t_hs.horn_schunck(a, b, convert.horn_schunck_config_from_jax(jcfg), device="cpu")
    assert t[0].dtype == torch.float32
    s = (slice(8, -8), slice(8, -8))
    d = np.hypot(np.asarray(j[0])[s] - t[0].numpy()[s], np.asarray(j[1])[s] - t[1].numpy()[s])
    assert np.median(d) < 1e-3 and np.quantile(d, 0.99) < 0.02, (np.median(d), np.quantile(d, 0.99))


def test_pyramid_recovers_a_3px_translation():
    """tests/test_horn_schunck.py:72-91's bar on the port alone: a 3 px
    shift, beyond single-level HS's linearization range, to < 0.2 px."""
    img = _texture(128, 128, 4, sigma=3.0).astype(np.float32)
    img2 = np.roll(img, 3, axis=1)
    u, v = t_hs.horn_schunck(img, img2, t_hs.HornSchunckConfig(alpha=0.5, iters=300, levels=3),
                             device="cpu")
    assert abs(float(u[24:-24, 24:-24].median()) - 3.0) < 0.2
    assert abs(float(v[24:-24, 24:-24].median())) < 0.1


def test_rejects_too_many_levels_and_promotes_integers():
    a = (np.random.RandomState(2).rand(24, 40) * 255).astype(np.uint8)
    with pytest.raises(ValueError):  # 24 = 8 x 3: 4 levels at most
        t_hs.horn_schunck(a, a, t_hs.HornSchunckConfig(levels=5), device="cpu")
    u, v = t_hs.horn_schunck(a, a, t_hs.HornSchunckConfig(iters=3), device="cpu")
    assert u.dtype == torch.float32 and not bool(u.any())  # identical frames: no flow


@pytest.mark.cuda
def test_horn_schunck_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from optical_flow_tpu_torch import kernels

    a, b = _pair(np.float32, shape=(256, 256), roll=(2, 3))
    cfg = t_hs.HornSchunckConfig(alpha=0.5, iters=50, levels=4, warp_impl="shift_sep")
    cpu = t_hs.horn_schunck(a, b, cfg, device="cpu")
    kernels.reset_launch_counts()
    card = t_hs.horn_schunck(a, b, cfg)
    assert card[0].is_cuda
    assert kernels.launch_counts().get("oft_pyramid") == 2  # K2: one call a pyramid
    s = (slice(8, -8), slice(8, -8))
    d = torch.hypot(card[0].cpu()[s] - cpu[0][s], card[1].cpu()[s] - cpu[1][s]).numpy()
    assert np.median(d) < 1e-3 and np.quantile(d, 0.99) < 0.02, (np.median(d), np.quantile(d, 0.99))
