"""The port's sparse-tracking path (optical_flow_tpu_torch/track/) against
the JAX package's, on identical numpy inputs made from a seed, float32 on
the CPU (the port with ``device="cpu"``). Tolerances:

  min_eig_map                       atol 1e-5 of the map's max
  good_features_to_track            valid corner sets equal (the whole
                                    fixed-size arrays compared where no
                                    scores tie)
  _sample_patches, _scharr,
  _extract_regions, _shift_sample   atol 1e-6
  track_features (both impls)       features tracked on both sides: median
                                    |d| < 1e-4 px, q99 < 0.03 px (one
                                    Newton step of up to eps = 0.03 px may
                                    differ where float32 roundoff moves a
                                    feature across the |delta| <= eps
                                    freeze); status agreement >= 99%
  pose helpers (float64, JAX x64)   <= 1e-9
  _ransac_homography, JAX's sets    the same inlier mask and count; H / H[2, 2]
                                    within 1e-5 in float64 (JAX x64), within
                                    5e-4 of max |H| in float32

The tests marked ``cuda`` hold the card against the port's CPU result and
skip where there is none.
"""

import argparse
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from optical_flow_tpu.track import features as j_feat
from optical_flow_tpu.track import pose as j_pose
from optical_flow_tpu.track import sparse_lk as j_lk
from optical_flow_tpu_torch.track import features as t_feat
from optical_flow_tpu_torch.track import pose as t_pose
from optical_flow_tpu_torch.track import sparse_lk as t_lk

CPU = torch.device("cpu")


def _texture(h, w, seed, sigma=2.0):
    """Unit-range smooth random texture (FFT Gaussian, periodic) x 255."""
    rng = np.random.RandomState(seed)
    fy, fx = np.fft.fftfreq(h)[:, None], np.fft.fftfreq(w)[None, :]
    g = np.exp(-2.0 * (np.pi * sigma) ** 2 * (fx * fx + fy * fy))
    t = np.real(np.fft.ifft2(np.fft.fft2(rng.rand(h, w)) * g))
    return (255.0 * (t - t.min()) / (t.max() - t.min())).astype(np.float32)


def _shift(img, dx, dy):
    """img2(p) = img(p - d), bilinear, periodic (the texture is periodic)."""
    H, W = img.shape
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    y, x = ys - dy, xs - dx
    y0, x0 = np.floor(y).astype(int), np.floor(x).astype(int)
    fy, fx = y - y0, x - x0
    g = lambda a, b: img[a % H, b % W]  # noqa: E731
    out = (g(y0, x0) * (1 - fy) * (1 - fx) + g(y0, x0 + 1) * (1 - fy) * fx
           + g(y0 + 1, x0) * fy * (1 - fx) + g(y0 + 1, x0 + 1) * fy * fx)
    return out.astype(np.float32)


def _valid_set(pts, valid):
    p = np.asarray(pts)[np.asarray(valid)]
    return {(float(x), float(y)) for x, y in p}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# ------------------------------------------------------------------ corners


@pytest.mark.parametrize("shape,seed", [((96, 128), 0), ((61, 77), 1)])
def test_min_eig_map_matches_jax(shape, seed):
    img = _texture(*shape, seed)
    j = np.asarray(j_feat.min_eig_map(jnp.asarray(img)))
    t = t_feat.min_eig_map(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * np.abs(j).max())


@pytest.mark.parametrize(
    "shape,seed,k,quality,dist",
    [((96, 128), 0, 80, 0.01, 5.0), ((120, 160), 2, 500, 0.01, 10.0),
     ((64, 64), 3, 40, 0.05, 3.0), ((50, 70), 4, 3000, 0.001, 1.0)],
)
def test_good_features_match_jax(shape, seed, k, quality, dist):
    img = _texture(*shape, seed, sigma=1.5)
    jp, jv = j_feat.good_features_to_track(jnp.asarray(img), k, quality, dist)
    tp, tv = t_feat.good_features_to_track(img, k, quality, dist, device="cpu")
    assert tp.shape == (k, 2) and tv.dtype == torch.bool
    assert _valid_set(tp, tv) == _valid_set(jp, jv)
    assert int(tv.sum()) >= 10
    # no ties on a random texture: the fixed-size arrays match whole, the
    # slots past the valid corners included
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_good_features_uint8_and_batched_thresholds():
    """A batch thresholds per image: a bright image must not blank a
    low-contrast one (tests/test_track.py:170-186); each batch entry equals
    the image alone, and the JAX package's batch."""
    rng = np.random.RandomState(3)
    lowc = (rng.rand(64, 64) * 10).astype(np.float32)
    bright = (rng.rand(64, 64) * 255).astype(np.float32)
    batch = np.stack([bright, lowc])
    tp, tv = t_feat.good_features_to_track(batch, 50, 0.01, 8, device="cpu")
    jp, jv = j_feat.good_features_to_track(jnp.asarray(batch), 50, 0.01, 8)
    for k, img in enumerate((bright, lowc)):
        sp, sv = t_feat.good_features_to_track(img, 50, 0.01, 8, device="cpu")
        assert _valid_set(tp[k], tv[k]) == _valid_set(sp, sv) == _valid_set(jp[k], jv[k])
    assert int(tv[1].sum()) >= 10
    u8 = _texture(48, 56, 5).astype(np.uint8)
    a = t_feat.good_features_to_track(torch.from_numpy(u8), 30, 0.01, 4)
    b = j_feat.good_features_to_track(jnp.asarray(u8), 30, 0.01, 4)
    assert _valid_set(*a) == _valid_set(*b)


def test_good_features_close_to_cv2():
    cv2 = pytest.importorskip("cv2")
    img = _texture(240, 320, 0, sigma=3.0).astype(np.uint8)
    pts, valid = t_feat.good_features_to_track(img, 100, 0.01, 10, device="cpu")
    ours = pts.numpy()[valid.numpy()]
    assert len(ours) >= 20
    ref = cv2.goodFeaturesToTrack(img, 100, 0.01, 10).reshape(-1, 2)
    d = np.linalg.norm(ours[:, None, :] - ref[None, :, :], axis=-1).min(axis=1)
    assert (d <= 2.0).mean() >= 0.6, (d <= 2.0).mean()


# ------------------------------------------------------------- sparse LK


def test_sparse_lk_helpers_match_jax():
    rng = np.random.RandomState(6)
    img = _texture(40, 52, 6)
    centers = np.stack([rng.uniform(-5, 57, 9), rng.uniform(-5, 45, 9)], -1).astype(np.float32)
    jpatch = j_lk._sample_patches(jnp.asarray(img), jnp.asarray(centers), 4, extra=1)
    tpatch = t_lk._sample_patches(torch.from_numpy(img), torch.from_numpy(centers), 4, extra=1)
    np.testing.assert_allclose(tpatch.numpy(), np.asarray(jpatch), rtol=0, atol=1e-6)
    for a, b in zip(j_lk._scharr(jpatch), t_lk._scharr(tpatch)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
    oy = rng.randint(-8, 40, 9).astype(np.int32)
    ox = rng.randint(-8, 50, 9).astype(np.int32)
    jr = j_lk._extract_regions(jnp.asarray(img), jnp.asarray(oy), jnp.asarray(ox), 13)
    tr = t_lk._extract_regions(torch.from_numpy(img), torch.from_numpy(oy), torch.from_numpy(ox), 13)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    py = rng.uniform(0, 3, 9).astype(np.float32)
    px = rng.uniform(0, 3, 9).astype(np.float32)
    js = j_lk._shift_sample(jr, jnp.asarray(py), jnp.asarray(px), 4, 4)
    ts = t_lk._shift_sample(tr, torch.from_numpy(py), torch.from_numpy(px), 4, 4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)


def _track_pair(shape=(120, 160), seed=7, d=(2.6, -1.7)):
    img1 = _texture(*shape, seed, sigma=2.5)
    return img1, _shift(img1, *d)


def _assert_tracks_close(jres, tres):
    """The bars of the module docstring; returns the count of features
    whose endpoints differ by more than 1e-4 px."""
    jn, js, je = (np.asarray(x) for x in jres)
    tn, ts, te = (x.numpy() for x in tres)
    assert (js == ts).mean() >= 0.99, (js != ts).sum()
    both = js & ts
    d = np.linalg.norm(jn[both] - tn[both], axis=1)
    assert np.median(d) < 1e-4, np.median(d)
    assert np.quantile(d, 0.99) < 0.03, np.quantile(d, 0.99)
    assert np.isfinite(te).all()
    return int((d > 1e-4).sum())


@pytest.mark.parametrize("impl", ["gather", "shift"])
@pytest.mark.parametrize("win", [31, 15])
def test_track_features_matches_jax(impl, win):
    img1, img2 = _track_pair()
    jp, jv = j_feat.good_features_to_track(jnp.asarray(img1), 200, 0.01, 5)
    pts = np.asarray(jp)  # the whole fixed-size array, invalid slots included
    jres = j_lk.track_features(img1, img2, pts, j_lk.SparseLKConfig(impl=impl, win=win))
    tres = t_lk.track_features(img1, img2, pts, t_lk.SparseLKConfig(impl=impl, win=win),
                               device="cpu")
    _assert_tracks_close(jres, tres)
    ok = tres[1].numpy() & np.asarray(jv)
    med = np.median(tres[0].numpy()[ok] - pts[ok], axis=0)
    np.testing.assert_allclose(med, [2.6, -1.7], atol=0.1)


def test_track_features_auto_is_gather():
    img1, img2 = _track_pair((64, 80), 8, (1.3, 0.6))
    pts = np.stack([np.linspace(10, 70, 12), np.linspace(10, 54, 12)], -1).astype(np.float32)
    a = t_lk.track_features(img1, img2, pts, device="cpu")
    b = t_lk.track_features(img1, img2, pts, t_lk.SparseLKConfig(impl="gather"), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        t_lk.track_features(img1, img2, pts, t_lk.SparseLKConfig(impl="pallas"), device="cpu")


def test_sparse_lk_shift_impl_matches_gather():
    """tests/test_track.py:105-140's bar on the port alone: same status,
    endpoints within median 1e-5 and max 1e-3 px, on up to ~10 px of
    motion."""
    rng = np.random.RandomState(5)
    h, w = 160, 208
    base = _texture(h, w, 9, sigma=3.0)
    disp = 4.0 + 6.0 * _texture(h, w, 10, sigma=20.0) / 255.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    x = xs + disp
    x0 = np.floor(x).astype(int)
    fx = x - x0
    img2 = (base[ys.astype(int), x0 % w] * (1 - fx) + base[ys.astype(int), (x0 + 1) % w] * fx)
    img2 = img2.astype(np.float32)
    pts = np.stack([rng.uniform(20, w - 20, 80), rng.uniform(20, h - 20, 80)], 1).astype(np.float32)
    pg, sg, _ = t_lk.track_features(base, img2, pts, t_lk.SparseLKConfig(impl="gather"), device="cpu")
    ps, ss, _ = t_lk.track_features(base, img2, pts, t_lk.SparseLKConfig(impl="shift"), device="cpu")
    assert torch.equal(sg, ss)
    d = np.linalg.norm(pg.numpy() - ps.numpy(), axis=1)[sg.numpy()]
    assert np.median(d) < 1e-5 and d.max() < 1e-3, (np.median(d), d.max())


def test_prebuilt_pyramids_equal_rebuilt():
    rng = np.random.RandomState(5)
    img1 = (rng.rand(96, 128) * 255).astype(np.float32)
    img2 = np.roll(img1, (1, 2), axis=(0, 1))
    pts = np.stack([rng.uniform(20, 100, 12), rng.uniform(20, 70, 12)], -1)
    cfg = t_lk.SparseLKConfig(win=15, max_level=1)
    a = t_lk.track_features(img1, img2, pts, cfg, device="cpu")
    pyr1 = t_lk.build_tracking_pyramid(img1, cfg, device="cpu")
    pyr2 = t_lk.build_tracking_pyramid(img2, cfg, device="cpu")
    assert len(pyr1) == 2 and pyr1[1].shape == (48, 64) and pyr1[0].dtype == torch.float32
    jpyr = j_lk.build_tracking_pyramid(img1, j_lk.SparseLKConfig(win=15, max_level=1))
    for x, y in zip(pyr1, jpyr):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    b = t_lk.track_features(img1, img2, pts, cfg, pyr1=pyr1, pyr2=pyr2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_track_border_and_out_of_bounds_status():
    img1 = _texture(240, 320, 3, sigma=3.0)
    img2 = _shift(img1, 2.0, 0.0)
    pts = np.array([[5.0, 5.0], [160.0, 120.0], [-40.0, 120.0], [40.0, 120.0]], np.float32)
    _, status, _ = t_lk.track_features(img1, img2, pts, device="cpu")
    _, jstatus, _ = j_lk.track_features(img1, img2, pts)
    assert status.tolist() == [True, True, False, True]
    assert status.tolist() == np.asarray(jstatus).tolist()


# ------------------------------------------------------------------- pose


def _homography_case(rng, K=60, outliers=0.3, dtype=np.float32):
    H_true = np.asarray([[1.1, 0.05, 3.0], [-0.04, 0.95, -2.0], [1e-4, -2e-4, 1.0]])
    p1 = rng.uniform(0, 300, (K, 2))
    ph = np.concatenate([p1, np.ones((K, 1))], 1) @ H_true.T
    p2 = ph[:, :2] / ph[:, 2:]
    n_out = int(round(outliers * K))
    p2[:n_out] += rng.uniform(15, 40, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    return H_true, p1.astype(dtype), p2.astype(dtype)


def test_pose_helpers_match_jax_f64():
    rng = np.random.RandomState(11)
    _, p1, p2 = _homography_case(rng, dtype=np.float64)
    w = (rng.rand(60) > 0.3).astype(np.float64)
    jn, jT = j_pose._normalize_points(jnp.asarray(p1), jnp.asarray(w))
    tn, tT = t_pose._normalize_points(torch.from_numpy(p1), torch.from_numpy(w))
    assert np.abs(tn.numpy() - np.asarray(jn)).max() <= 1e-9
    assert np.abs(tT.numpy() - np.asarray(jT)).max() <= 1e-9
    jH = np.asarray(j_pose._dlt_homography(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w)))
    tH = t_pose._dlt_homography(torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(w))
    assert np.abs(tH.numpy() - jH).max() <= 1e-9
    je = np.asarray(j_pose._transfer_error(jnp.asarray(jH), jnp.asarray(p1), jnp.asarray(p2)))
    te = t_pose._transfer_error(torch.tensor(jH), torch.from_numpy(p1), torch.from_numpy(p2))
    assert np.abs(te.numpy() - je).max() <= 1e-9
    # batched weights: one solve per row, each the unbatched solve
    wb = np.stack([w, np.roll(w, 7)])
    tHb = t_pose._dlt_homography(torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(wb))
    assert np.abs(tHb[0].numpy() - tH.numpy()).max() <= 1e-9


def _jax_sets(valid, n_hypotheses, seed):
    """JAX's own 4-point sets, drawn as optical_flow_tpu/track/pose.py:86-92
    draws them."""
    K = valid.shape[0]
    scores = jax.random.uniform(jax.random.PRNGKey(seed), (n_hypotheses, K))
    scores = jnp.where(jnp.asarray(valid)[None, :], scores, -jnp.inf)
    return np.array(jax.lax.top_k(scores, 4)[1])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed", [0, 3])
def test_ransac_with_jax_sets_matches_jax(seed, dtype):
    """The port's solver fed JAX's own 4-point sets, against JAX's RANSAC
    (its private solver, so that float64 runs under x64): the same inlier
    mask and count; H / H[2, 2] within 1e-5 in float64. In float32 the
    normal matrix's null vector carries roundoff of about 5e-5 of max |H|
    in both packages (a different amount in each), so the float32 bar is
    5e-4 of max |H|."""
    rng = np.random.RandomState(12 + seed)
    H_true, p1, p2 = _homography_case(rng, dtype=dtype)
    valid = rng.rand(60) > 0.1
    cfg = j_pose.RansacConfig(seed=seed)
    jH, jinl, jn = j_pose._ransac_homography(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
                                             jnp.float32(cfg.inlier_px), seed, cfg.n_hypotheses)
    idx = _jax_sets(valid, cfg.n_hypotheses, seed)
    tH, tinl, tn = t_pose._ransac_homography(
        torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(valid), cfg.inlier_px,
        torch.from_numpy(idx).long())
    assert tH.dtype == getattr(torch, np.dtype(dtype).name)
    jH = np.asarray(jH) / np.asarray(jH)[2, 2]
    tH = tH.numpy() / tH.numpy()[2, 2]
    atol = 1e-5 if dtype == np.float64 else 5e-4 * np.abs(jH).max()
    np.testing.assert_allclose(tH, jH, rtol=0, atol=atol)
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
    assert int(tn) == int(jn) >= 30
    if dtype == np.float32:  # the public entry point draws JAX's sets too
        eH, einl, en = j_pose.estimate_homography(p1, p2, valid, cfg)
        assert int(en) == int(tn)


def test_homography_from_minimal_four_points():
    H_true = np.asarray([[1.1, 0.05, 3.0], [-0.04, 0.95, -2.0], [1e-4, -2e-4, 1.0]])
    p1 = np.asarray([[10.0, 12.0], [80.0, 15.0], [20.0, 70.0], [90.0, 85.0]], np.float32)
    ph = np.concatenate([p1, np.ones((4, 1))], axis=1) @ H_true.T
    p2 = (ph[:, :2] / ph[:, 2:3]).astype(np.float32)
    H, inliers, n = t_pose.estimate_homography(
        p1, p2, config=t_pose.RansacConfig(inlier_px=0.5), device="cpu")
    assert int(n) == 4 and bool(inliers.all())
    np.testing.assert_allclose(H.numpy() / H.numpy()[2, 2], H_true, atol=1e-3)


def test_sampler_recovers_homography_from_outliers():
    rng = np.random.RandomState(13)
    H_true, p1, p2 = _homography_case(rng, K=100, outliers=0.3)
    H, inl, n = t_pose.estimate_homography(p1, p2, device="cpu")
    assert int(n) == 70 and not bool(inl[:30].any()) and bool(inl[30:].all())
    Hn = H.numpy() / H.numpy()[2, 2]
    pts = np.array([[0.0, 0.0, 1.0], [300.0, 300.0, 1.0], [150.0, 40.0, 1.0]])
    a, b = pts @ Hn.T, pts @ H_true.T
    assert np.abs(a[:, :2] / a[:, 2:] - b[:, :2] / b[:, 2:]).max() < 0.05


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_two_motion_vote_is_stable(seed):
    """A static background and a patch moving (+3, +2) px, both within the
    3 px inlier bar of a homography between them: the public entry point
    solves in float64, so a 1e-6 relative change of the points changes
    nothing (in float32 it moved the winning count by up to 25%)."""
    rng = np.random.RandomState(seed)
    p1 = np.concatenate([rng.uniform(0, 1280, (350, 2)),
                         rng.uniform(400, 600, (150, 2))]).astype(np.float32)
    p2 = p1.copy()
    p2[350:] += np.array([3.0, 2.0], np.float32)
    p2 += (rng.randn(500, 2) * 0.01).astype(np.float32)
    H, inl, n = t_pose.estimate_homography(p1, p2, device="cpu")
    H2, inl2, n2 = t_pose.estimate_homography(p1 * (1 + 1e-6), p2 * (1 + 1e-6), device="cpu")
    assert H.dtype == torch.float32 and int(n) == int(n2) >= 350
    assert torch.equal(inl, inl2)


def test_sample_hypotheses_depend_on_the_seed_only():
    valid = torch.from_numpy(np.random.RandomState(14).rand(50) > 0.2)
    a = t_pose.sample_hypotheses(valid, 256, 5)
    b = t_pose.sample_hypotheses(valid.clone(), 256, 5)
    assert a.shape == (256, 4) and torch.equal(a, b)
    assert bool(valid[a].all())  # only valid points
    assert not torch.equal(a, t_pose.sample_hypotheses(valid, 256, 6))
    # a Generator of its own: the global stream is neither read nor moved
    torch.manual_seed(0)
    x = torch.rand(3)
    torch.manual_seed(0)
    t_pose.sample_hypotheses(valid, 256, 5)
    assert torch.equal(torch.rand(3), x)


# ---------------------------------------------------------- entry points


def test_host_arrays_need_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: host arrays go to it")
    img = _texture(32, 40, 15)
    pts = np.array([[10.0, 10.0]], np.float32)
    calls = [
        lambda **kw: t_feat.good_features_to_track(img, 10, **kw),
        lambda **kw: t_lk.track_features(img, img, pts, **kw),
        lambda **kw: t_lk.build_tracking_pyramid(img, **kw),
        lambda **kw: t_pose.estimate_homography(pts.repeat(4, 0), pts.repeat(4, 0), **kw),
        lambda **kw: importlib.import_module("optical_flow_tpu_torch.flow.horn_schunck")
        .horn_schunck(img, img, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")
    # a tensor stays where it is
    out = t_feat.good_features_to_track(torch.from_numpy(img), 10)
    assert out[0].device == CPU


def test_track_cli_prints_what_the_jax_cli_prints(tmp_path, capsys):
    """`python -m optical_flow_tpu_torch track` on a pipe: raw file prints
    the JAX package's `track` lines (optical_flow_tpu/__main__.py:145-165)."""
    from optical_flow_tpu.__main__ import _cmd_track as j_cmd_track
    from optical_flow_tpu_torch.__main__ import main
    from test_torch_slice import _frames

    frames = _frames(n=5, hw=(96, 128))
    path = tmp_path / "frames.raw"
    frames.tofile(path)
    spec = f"pipe:128x96:{path}"
    j_cmd_track(argparse.Namespace(input=spec, frames=5, corners=200))
    want = capsys.readouterr().out.splitlines()
    assert main(["track", "--input", spec, "--frames", "5", "--corners", "200",
                 "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert len(want) == 5 and want[0].startswith("frame 0: seeded")
    assert got == want


# ------------------------------------------------------------------ card


@pytest.mark.cuda
def test_tracking_pyramid_on_card_equals_poly(cuda_device):
    from optical_flow_tpu_torch import kernels
    from optical_flow_tpu_torch.ops.pyramid import gaussian_pyramid

    img = torch.from_numpy(_texture(720, 1280, 16)).to(cuda_device)
    kernels.reset_launch_counts()
    pyr = t_lk.build_tracking_pyramid(img)
    assert kernels.launch_counts().get("oft_pyramid") == 1
    for a, b in zip(pyr, gaussian_pyramid(img, 3, impl="poly")):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["gather", "shift"])
def test_track_features_on_card_matches_cpu(cuda_device, impl):
    img1, img2 = _track_pair((360, 480), 17, (3.0, 2.0))
    pts, valid = t_feat.good_features_to_track(img1, 300, 0.01, 10, device="cpu")
    cpts, cvalid = t_feat.good_features_to_track(img1, 300, 0.01, 10, device=cuda_device)
    assert _valid_set(cpts.cpu(), cvalid.cpu()) == _valid_set(pts, valid)
    cfg = t_lk.SparseLKConfig(impl=impl)
    cpu = t_lk.track_features(img1, img2, pts, cfg, device="cpu")
    card = t_lk.track_features(img1, img2, pts, cfg, device=cuda_device)
    assert card[0].is_cuda
    _assert_tracks_close(cpu, tuple(x.cpu() for x in card))
    rng = np.random.RandomState(18)
    _, p1, p2 = _homography_case(rng)
    for dev in ("cpu", cuda_device):
        H, inl, n = t_pose.estimate_homography(p1, p2, device=dev)
        assert int(n) == 42
    a = t_pose.sample_hypotheses(torch.ones(60, dtype=torch.bool), 256, 0)
    b = t_pose.sample_hypotheses(torch.ones(60, dtype=torch.bool, device=cuda_device), 256, 0)
    assert torch.equal(a, b.cpu())
