"""The port's appearance descriptors (optical_flow_tpu_torch/slam/
descriptors.py) against the JAX package's (optical_flow_tpu/slam/
descriptors.py) on identical numpy inputs made from a seed, on the CPU.
Images are rendered with numpy/scipy (no cv2). Tolerances:

  patch_descriptors       <= 1e-6 (float32, unit-norm rows), flat rows 0 in both
  ncc_scores              <= 1e-6
  match_descriptors       equal index sets and masks
  verify_tracks           equal masks

The test marked ``cuda`` holds the card against the CPU and skips where
there is no card.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from optical_flow_tpu.slam import descriptors as jd
from optical_flow_tpu_torch.slam import descriptors as td
from test_torch_stereo import one_thread  # noqa: F401 (a fixture)


def _textured(h=160, w=200, seed=3):
    rng = np.random.RandomState(seed)
    small = rng.rand(h // 8, w // 8).astype(np.float32)
    img = ndimage.zoom(small, (h / small.shape[0], w / small.shape[1]), order=3)
    return (255 * (img - img.min()) / np.ptp(img)).astype(np.float32)


def _points(n, h=160, w=200, seed=0):
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(-5, w + 5, n), rng.uniform(-5, h + 5, n)], 1).astype(np.float32)


@pytest.mark.parametrize("half", [3, 7])
def test_patch_descriptors_match_jax(half):
    img = _textured()
    pts = _points(70)  # subpixel, some off the image (edge-clamped taps)
    flat = np.full((64, 64), 7.0, np.float32)
    for im, p in ((img, pts), (flat, pts[:5])):
        want = np.asarray(jd.patch_descriptors(im, p, half=half))
        got = td.patch_descriptors(im, p, half=half, device="cpu")
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        assert np.array_equal(np.abs(got.numpy()).sum(1) == 0, np.abs(want).sum(1) == 0)


def test_ncc_and_matching_match_jax():
    img = _textured()
    shifted = np.roll(img, (3, 5), axis=(0, 1))
    pts = _points(40, seed=1)
    da = np.asarray(jd.patch_descriptors(img, pts))
    perm = np.random.RandomState(2).permutation(40)
    db = np.asarray(jd.patch_descriptors(shifted, pts[perm] + [5.0, 3.0]))
    np.testing.assert_allclose(td.ncc_scores(da, db), jd.ncc_scores(da, db), rtol=0, atol=1e-6)
    for kw in ({}, dict(min_score=0.5, ratio=0.95), dict(min_score=-1.0)):
        ji, jo = jd.match_descriptors(da, db, **kw)
        ti, to = td.match_descriptors(da, db, device="cpu", **kw)
        assert ti.dtype == np.int64 and to.dtype == bool
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(to, jo)
    # the permutation is recovered (tests/test_descriptors.py's claim)
    idx, ok = td.match_descriptors(da, db, device="cpu")
    assert ok.sum() >= 30 and np.array_equal(perm[idx[ok]], np.flatnonzero(ok))


def test_matching_edge_cases_match_jax():
    # empty sides, a single column, and an anti-correlated best match
    e = np.random.RandomState(5).randn(2, 225).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    z = np.zeros((0, 225), np.float32)
    for a, b in ((z, e), (e, z), (e, e[:1])):
        ji, jo = jd.match_descriptors(a, b)
        ti, to = td.match_descriptors(a, b, device="cpu")
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(to, jo)
    u = np.zeros(64, np.float32)
    v = np.zeros(64, np.float32)
    u[0], v[1] = 1.0, 1.0
    da = np.stack([u, v])
    db = np.stack([-u, -v, -(u + v) / np.sqrt(2, dtype=np.float32)])
    _, ok = td.match_descriptors(da, db, min_score=-1.0, device="cpu")
    assert not ok.any()


def test_verify_tracks_matches_jax():
    img = _textured()
    pts = np.array([[40.0, 40.0], [100.0, 60.0], [150.0, 110.0], [60.5, 120.25]], np.float32)
    anchor = np.array(jd.patch_descriptors(img, pts))
    anchor[3] = 0.0  # flat at birth: exempt
    for cur in (pts, pts + np.array([5.0, 4.0], np.float32), pts + 0.3):
        want = jd.verify_tracks(anchor, img, cur, gate=0.6)
        got = td.verify_tracks(anchor, img, cur, gate=0.6, device="cpu")
        np.testing.assert_array_equal(got, want)
    assert td.verify_tracks(anchor, img, pts, gate=0.6, device="cpu").all()
    drifted = td.verify_tracks(anchor, img, pts + np.float32(5.0), gate=0.6, device="cpu")
    assert not drifted[:3].any() and drifted[3]


@pytest.mark.cuda
def test_descriptors_on_card_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    img = _textured()
    pts = _points(300, seed=4)
    cpu = td.patch_descriptors(img, pts, device="cpu")
    card = td.patch_descriptors(img, pts)
    assert card.is_cuda
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=0, atol=1e-6)
    db = td.patch_descriptors(np.roll(img, (2, 1), axis=(0, 1)), pts + [1.0, 2.0], device="cpu")
    for a, b in zip(td.match_descriptors(cpu, db, device="cpu"), td.match_descriptors(cpu, db)):
        np.testing.assert_array_equal(a, b)
