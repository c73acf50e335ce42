"""The port's two-view geometry (optical_flow_tpu_torch/slam/epipolar.py,
pnp.py, frontend.py) against the JAX package's, on identical numpy inputs
made from a seed, on the CPU (the port with ``device="cpu"``; JAX with x64,
as tests/conftest.py sets it). Tolerances:

  5-point solver (float64 numpy on both sides)   <= 1e-9
  8-point helpers in float64                      E after scale and sign <= 1e-9
  estimate_essential's solver on JAX's own        E after scale and sign <= 1e-4,
  threefry sets, ransac_essential_5pt on the      the same inlier mask and count
  same RandomState samples (float32)
  recover_pose, triangulate, refine_pose,         <= 1e-4 (float32; points
  pnp_dlt, pnp_ransac on JAX's sets               relative to their largest)
  two_view_reconstruct, multi_view_reconstruct    R within 0.05 deg, t direction
  (160x208 scene, the port's sampler replaced     within 0.1 deg, rmse_after within
  by JAX's sets)                                  2% (observed maxima in the tests)

The 8-point null vector is the float64 normal matrix's eigenvector in the
port and the float32 SVD's in JAX, so float32 results agree to roundoff,
not bit for bit. The tests marked ``cuda`` skip where there is no card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from scipy import ndimage

from optical_flow_tpu.slam import epipolar as j_epi
from optical_flow_tpu.slam import frontend as j_front
from optical_flow_tpu.slam import pnp as j_pnp
from optical_flow_tpu_torch.slam import ba as t_ba
from optical_flow_tpu_torch.slam import epipolar as t_epi
from optical_flow_tpu_torch.slam import frontend as t_front
from optical_flow_tpu_torch.slam import pnp as t_pnp
from optical_flow_tpu_torch.track import pose as t_pose

CPU = torch.device("cpu")


def _rot(axis, th):
    axis = np.asarray(axis, float)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _pair(n=120, seed=0, noise=0.0, outliers=0.0):
    """tests/test_epipolar.py's two-view scene: deep structure, a rotation
    of 0.08 rad and a unit translation, normalized float32 points."""
    rng = np.random.RandomState(seed)
    X = np.stack([rng.randn(n) * 1.5, rng.randn(n) * 1.0, rng.uniform(3.0, 12.0, n)], axis=1)
    R = _rot([0.2, 1.0, 0.1], 0.08)
    t = np.array([1.0, 0.15, 0.1])
    t /= np.linalg.norm(t)
    x1 = X[:, :2] / X[:, 2:3]
    X2 = X @ R.T + t
    x2 = X2[:, :2] / X2[:, 2:3]
    x1 = x1 + rng.randn(n, 2) * noise
    x2 = x2 + rng.randn(n, 2) * noise
    out = rng.rand(n) < outliers
    x2[out] = rng.randn(out.sum(), 2) * 0.4
    return x1.astype(np.float32), x2.astype(np.float32), X, R, t, out


CASES = {"clean": dict(), "outliers": dict(outliers=0.3), "noisy": dict(noise=1e-3, outliers=0.1)}


def _jax_sets(valid, n_hypotheses, seed, k):
    """JAX's own k-point sets, drawn as optical_flow_tpu/slam/epipolar.py:93-96
    (k = 8) and slam/pnp.py:77-79 (k = 6) draw them."""
    valid = np.asarray(valid.cpu() if isinstance(valid, torch.Tensor) else valid)
    scores = jax.random.uniform(jax.random.PRNGKey(seed), (n_hypotheses, valid.shape[0]))
    scores = jnp.where(jnp.asarray(valid)[None, :], scores, -jnp.inf)
    return torch.from_numpy(np.array(jax.lax.top_k(scores, k)[1])).long()


def _unit(E):
    """E / |E| with the sign of its largest entry positive."""
    E = np.asarray(E, np.float64)
    E = E / np.linalg.norm(E)
    return E * np.sign(E.flat[np.argmax(np.abs(E))])


def _rot_deg(Ra, Rb):
    """Angle between two rotations, from the chord |Ra - Rb|_F = 2 sqrt(2)
    sin(th / 2) (exact near 0, where arccos of the trace is not)."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(np.degrees(2 * np.arcsin(min(d / (2 * np.sqrt(2)), 1.0))))


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------------ 8-point RANSAC


def test_eight_point_helpers_match_jax_f64():
    x1, x2, *_ = _pair(n=60, seed=2, noise=1e-3)
    p1, p2 = x1.astype(np.float64), x2.astype(np.float64)
    w = (np.random.RandomState(3).rand(60) > 0.3).astype(np.float64)
    jn, jT = j_epi._hartley(jnp.asarray(p1), jnp.asarray(w))
    tn, tT = t_epi._hartley(_t(p1), _t(w))
    assert np.abs(tn.numpy() - np.asarray(jn)).max() <= 1e-9
    assert np.abs(tT.numpy() - np.asarray(jT)).max() <= 1e-9
    jE = j_epi._eight_point(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w))
    tE = t_epi._eight_point(_t(p1), _t(p2), _t(w))
    assert np.abs(_unit(tE.numpy()) - _unit(jE)).max() <= 1e-9
    je = np.asarray(j_epi._sampson(jE, jnp.asarray(p1), jnp.asarray(p2)))
    te = t_epi._sampson(torch.tensor(np.asarray(jE)), _t(p1), _t(p2))
    assert np.abs(te.numpy() - je).max() <= 1e-9
    # batched weights: one solve per row, each the unbatched solve
    tEb = t_epi._eight_point(_t(p1), _t(p2), _t(np.stack([w, np.roll(w, 5)])))
    assert np.abs(_unit(tEb[0].numpy()) - _unit(tE.numpy())).max() <= 1e-12


def test_eight_point_with_exactly_eight_pairs():
    """A divergence from the reference: with exactly K = 8 pairs JAX's
    reduced SVD of the (8, 9) design matrix has no null vector in its vt
    (optical_flow_tpu/slam/epipolar.py:68), and its E is garbage (0.74 off
    the true E after scale and sign). The port's normal-matrix null vector
    is the true E (observed 4.9e-8, float64 on float32 points); at K = 9
    both agree with it."""
    x1, x2, _, R, t, _ = _pair(n=8, seed=1)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    want = _unit(tx @ R)
    p1, p2, w = (_t(a.astype(np.float64)) for a in (x1, x2, np.ones(8)))
    assert np.abs(_unit(t_epi._eight_point(p1, p2, w).numpy()) - want).max() <= 1e-6
    jE = j_epi._eight_point(jnp.asarray(x1, jnp.float64), jnp.asarray(x2, jnp.float64),
                            jnp.ones(8))
    assert np.abs(_unit(jE) - want).max() > 0.1


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 3])
def test_ransac_essential_with_jax_sets_matches_jax(seed, case):
    """The port's solver fed JAX's own 8-point sets, against JAX's private
    solver: E within 1e-4 after scale and sign (observed <= 9e-7), the same
    inlier mask and count."""
    x1, x2, *_ = _pair(seed=seed, **CASES[case])
    valid = np.random.RandomState(seed).rand(len(x1)) > 0.05
    cfg = j_epi.EssentialRansacConfig(seed=seed)
    jE, jinl, jn = j_epi._ransac_essential(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid),
                                           jnp.float32(cfg.inlier_thresh), seed, cfg.n_hypotheses)
    tE, tinl, tn = t_epi._ransac_essential(
        _t(x1), _t(x2), _t(valid), torch.tensor(cfg.inlier_thresh, dtype=torch.float32),
        _jax_sets(valid, cfg.n_hypotheses, seed, 8))
    assert tE.dtype == torch.float32
    assert np.abs(_unit(tE.numpy()) - _unit(jE)).max() <= 1e-4
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
    assert int(tn) == int(jn) >= 60


def test_estimate_essential_recovers_the_pose():
    """The public entry point with the port's own sampler: the clean scene's
    pose to 0.1 deg (tests/test_epipolar.py's bar)."""
    x1, x2, _, R_true, t_true, _ = _pair()
    E, inl, n = t_epi.estimate_essential(x1, x2, config=t_epi.EssentialRansacConfig(seed=1),
                                         device="cpu")
    assert E.device == CPU and int(n) >= 110
    R, t, _ = t_epi.recover_pose(E, _t(x1)[inl], _t(x2)[inl])
    assert _rot_deg(R.numpy(), R_true) < 0.1
    assert np.degrees(np.arccos(min(abs(float(t.numpy() @ t_true)), 1.0))) < 0.5


def test_too_few_valid_points_raise():
    x1, x2, *_ = _pair(n=20)
    valid = np.zeros(20, bool)
    valid[:7] = True
    with pytest.raises(ValueError, match="needs >= 8 valid"):
        t_epi.estimate_essential(x1, x2, valid, device="cpu")
    valid[:4] = False
    with pytest.raises(ValueError, match="need >= 5 valid"):
        t_epi.ransac_essential_5pt(x1, x2, valid, device="cpu")


def test_sample_hypotheses_k8_depend_on_the_seed_only():
    valid = torch.from_numpy(np.random.RandomState(14).rand(50) > 0.2)
    a = t_pose.sample_hypotheses(valid, 512, 5, k=8)
    assert a.shape == (512, 8) and torch.equal(a, t_pose.sample_hypotheses(valid.clone(), 512, 5, k=8))
    assert bool(valid[a].all())
    assert not torch.equal(a, t_pose.sample_hypotheses(valid, 512, 6, k=8))
    assert all(len(set(row.tolist())) == 8 for row in a)  # 8 distinct points a set
    # the default stays the homography's 4-point set, and k=4 draws it
    assert torch.equal(t_pose.sample_hypotheses(valid, 64, 5),
                       t_pose.sample_hypotheses(valid, 64, 5, k=4))


# ------------------------------------------------------------ 5-point solver


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_five_point_matches_jax(seed):
    x1, x2, *_ = _pair(n=5, seed=seed)
    jE = j_epi.five_point(x1, x2)
    tE = t_epi.five_point(x1, x2)
    assert tE.shape == jE.shape and len(tE) >= 1
    np.testing.assert_allclose(tE, jE, rtol=0, atol=1e-9)


def test_five_point_batch_matches_jax():
    x1, x2, *_ = _pair(n=150, seed=2, noise=1e-3, outliers=0.3)
    rng = np.random.RandomState(1)
    ids = np.stack([rng.choice(150, 5, replace=False) for _ in range(24)])
    jE, jm = j_epi.five_point_batch(x1[ids], x2[ids])
    tE, tm = t_epi.five_point_batch(_t(x1[ids]), x2[ids])  # a tensor or an array
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tE[tm], jE[jm], rtol=0, atol=1e-9)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ransac_essential_5pt_matches_jax(case):
    """The same RandomState samples on both sides: E within 1e-4 after scale
    and sign (observed <= 2.3e-6), the same inlier mask and count."""
    x1, x2, *_ = _pair(seed=3, **CASES[case])
    cfg = j_epi.EssentialRansacConfig(seed=3)
    jE, jinl, jn = j_epi.ransac_essential_5pt(x1, x2, config=cfg, n_samples=48)
    tE, tinl, tn = t_epi.ransac_essential_5pt(x1, x2, config=t_epi.EssentialRansacConfig(seed=3),
                                              n_samples=48, device="cpu")
    assert tE.dtype == torch.float32 and tE.device == CPU
    assert np.abs(_unit(tE.numpy()) - _unit(jE)).max() <= 1e-4
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
    assert int(tn) == int(jn)


# ------------------------------------------------- pose, triangulation, LO


@pytest.mark.parametrize("case", sorted(CASES))
def test_recover_pose_matches_jax(case):
    x1, x2, *_ = _pair(seed=5, **CASES[case])
    E, inl, _ = j_epi.estimate_essential(x1, x2, config=j_epi.EssentialRansacConfig(seed=2))
    inl = np.asarray(inl)
    jR, jt, jc = j_epi.recover_pose(E, jnp.asarray(x1)[inl], jnp.asarray(x2)[inl])
    tR, tt, tc = t_epi.recover_pose(torch.tensor(np.asarray(E)), x1[inl], x2[inl], device="cpu")
    assert np.abs(tR.numpy() - np.asarray(jR)).max() <= 1e-4
    assert np.abs(tt.numpy() - np.asarray(jt)).max() <= 1e-4
    assert int(tc) == int(jc)
    # with an inlier mask in place of the selection
    tR2, tt2, tc2 = t_epi.recover_pose(torch.tensor(np.asarray(E)), x1, x2, inl, device="cpu")
    assert torch.equal(tR2, tR) and int(tc2) == int(tc)


def test_triangulate_matches_jax():
    x1, x2, X, R, t, _ = _pair(n=60, seed=3, noise=1e-3)
    P1 = np.eye(3, 4, dtype=np.float32)
    P2 = np.concatenate([R, t[:, None]], axis=1).astype(np.float32)
    jX = np.asarray(j_epi.triangulate(jnp.asarray(P1), jnp.asarray(P2), x1, x2))
    tX = t_epi.triangulate(P1, P2, x1, x2, device="cpu")
    assert tX.dtype == torch.float32
    assert np.abs(tX.numpy() - jX).max() <= 1e-4 * np.abs(jX).max()
    np.testing.assert_allclose(np.median(tX.numpy()[:, 2] / X[:, 2]), 1.0, atol=0.01)


@pytest.mark.parametrize("masked", [False, True])
def test_refine_pose_matches_jax(masked):
    x1, x2, *_ = _pair(noise=1e-3, outliers=0.2 if masked else 0.0, seed=7)
    E, inl, _ = j_epi.estimate_essential(x1, x2, config=j_epi.EssentialRansacConfig(seed=3))
    inl = np.asarray(inl)
    R0, t0, _ = j_epi.recover_pose(E, jnp.asarray(x1)[inl], jnp.asarray(x2)[inl])
    mask = inl if masked else None
    jR, jt, jE = j_epi.refine_pose(R0, t0, x1, x2, inliers=mask)
    tR, tt, tE = t_epi.refine_pose(np.asarray(R0), np.asarray(t0), x1, x2, inliers=mask,
                                   device="cpu")
    for a, b in ((tR, jR), (tt, jt), (tE, jE)):
        assert a.dtype == torch.float32
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-4


def test_lo_helpers_match_jax_f64():
    rng = np.random.RandomState(4)
    for w in (np.zeros(3), rng.randn(3) * 0.1):
        np.testing.assert_allclose(t_epi._exp_so3(_t(w)).numpy(),
                                   np.asarray(j_epi._exp_so3(jnp.asarray(w))), rtol=0, atol=1e-12)
    t = rng.randn(3)
    t /= np.linalg.norm(t)
    np.testing.assert_allclose(t_epi._tangent_basis(_t(t)).numpy(),
                               np.asarray(j_epi._tangent_basis(jnp.asarray(t))), rtol=0, atol=1e-12)
    x1, x2, *_ = _pair(n=30, seed=1)
    h1 = np.concatenate([x1, np.ones((30, 1), np.float32)], 1).astype(np.float64)
    h2 = np.concatenate([x2, np.ones((30, 1), np.float32)], 1).astype(np.float64)
    E = rng.randn(3, 3)
    np.testing.assert_allclose(t_epi._sampson_signed(_t(E), _t(h1), _t(h2)).numpy(),
                               np.asarray(j_epi._sampson_signed(jnp.asarray(E), jnp.asarray(h1),
                                                                jnp.asarray(h2))),
                               rtol=0, atol=1e-12)


def test_normalize_pixels_matches_jax():
    px = np.random.RandomState(0).uniform(0, 640, (50, 2)).astype(np.float32)
    got = t_epi.normalize_pixels(px, 500.0, 320.0, 240.0, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_epi.normalize_pixels(px, 500.0, 320.0, 240.0)))


# ---------------------------------------------------------------------- PnP


def _pnp_scene(seed=7, n=60, noisy=10):
    rng = np.random.RandomState(seed)
    X = np.stack([rng.randn(n) * 1.5, rng.randn(n), rng.uniform(3, 10, n)], axis=1)
    R = _rot([0.3, 0.7, -0.2], 0.15)
    t = np.array([0.4, -0.2, 0.3])
    Xc = X @ R.T + t
    x = Xc[:, :2] / Xc[:, 2:3]
    x[:noisy] += rng.randn(noisy, 2) * 0.1  # gross errors on the first points
    return X.astype(np.float32), x.astype(np.float32), R, t


def test_pnp_dlt_matches_jax():
    X, x, R, t = _pnp_scene(noisy=0)
    jR, jt = j_pnp.pnp_dlt(X, x)
    tR, tt = t_pnp.pnp_dlt(X, x, device="cpu")
    assert np.abs(tR.numpy() - np.asarray(jR)).max() <= 1e-4
    assert np.abs(tt.numpy() - np.asarray(jt)).max() <= 1e-4
    assert _rot_deg(tR.numpy(), R) < 0.1 and np.abs(tt.numpy() - t).max() < 1e-3
    w = np.random.RandomState(1).rand(60).astype(np.float32)
    jRw, jtw = j_pnp.pnp_dlt(X, x, w)
    tRw, ttw = t_pnp.pnp_dlt(X, x, w, device="cpu")
    assert np.abs(tRw.numpy() - np.asarray(jRw)).max() <= 1e-4
    je = np.asarray(j_pnp.reprojection_errors(jR, jt, jnp.asarray(X), jnp.asarray(x)))
    te = t_pnp.reprojection_errors(torch.tensor(np.asarray(jR)), torch.tensor(np.asarray(jt)), _t(X), _t(x))
    np.testing.assert_allclose(te.numpy(), je, rtol=0, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 3])
def test_pnp_ransac_with_jax_sets_matches_jax(seed):
    X, x, R, t = _pnp_scene(seed=seed + 8)
    valid = np.ones(60, bool)
    valid[-3:] = False
    jR, jt, jinl = j_pnp.pnp_ransac(X, x, valid, seed=seed)
    tR, tt, tinl = t_pnp._pnp_ransac(_t(X), _t(x), _t(valid), 2e-3, _jax_sets(valid, 256, seed, 6))
    assert np.abs(tR.numpy() - np.asarray(jR)).max() <= 1e-4
    assert np.abs(tt.numpy() - np.asarray(jt)).max() <= 1e-4
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
    assert int(tinl.sum()) >= 45
    # the public entry point (the port's sampler) finds the same pose
    pR, pt, pinl = t_pnp.pnp_ransac(X, x, valid, seed=seed, device="cpu")
    assert _rot_deg(pR.numpy(), R) < 0.05 and torch.equal(pinl, tinl)


# -------------------------------------------------------------- the front end


def render_scene(n, hw=(160, 208), focal=200.0, step=0.05, seed=9):
    """n gray uint8 frames of a camera sliding along +x over a textured
    plane with a random depth field clipped to [3, 12] (examples/sfm_demo.py's
    scene without cv2: cubic zoom for the texture and depth, bilinear
    REFLECT_101 resampling for the parallax). Returns (frames, depth)."""
    rng = np.random.RandomState(seed)
    h, w = hw
    small = rng.rand(h // 4, w // 4)
    base = ndimage.zoom(small, (h / small.shape[0], w / small.shape[1]), order=3)
    base = (255 * (base - base.min()) / np.ptp(base)).astype(np.uint8)
    d = rng.rand(10, 13)
    depth = np.clip(4.0 + 6.0 * ndimage.zoom(d, (h / 10, w / 13), order=3), 3.0, 12.0)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    frames = [base]
    for k in range(1, n):
        img = ndimage.map_coordinates(base.astype(np.float64), [ys, xs + focal * step * k / depth],
                                      order=1, mode="mirror")
        frames.append(np.clip(np.rint(img), 0, 255).astype(np.uint8))
    return frames, depth


@pytest.fixture(scope="module")
def scene():
    return render_scene(4)


@pytest.fixture
def jax_sampler(monkeypatch):
    """The port's essential RANSAC drawing JAX's threefry sets."""
    monkeypatch.setattr(t_epi, "sample_hypotheses",
                        lambda valid, n, seed, k=4: _jax_sets(valid, n, seed, k).to(valid.device))


def test_two_view_reconstruct_matches_jax(scene, jax_sampler):
    """Observed: R 4.6e-5 deg apart, t 0 deg, rmse_after within 1.9e-6
    relative."""
    frames, _ = scene
    j = j_front.two_view_reconstruct(frames[0], frames[3], 200.0)
    t = t_front.two_view_reconstruct(frames[0], frames[3], 200.0, device="cpu")
    assert j is not None and t is not None
    assert _rot_deg(t.R, j.R) < 0.05
    assert np.degrees(np.arccos(min(float(t.t @ j.t), 1.0))) < 0.1
    assert abs(t.rmse_after - j.rmse_after) <= 0.02 * j.rmse_after
    assert t.rmse_after <= t.rmse_before and t.points.shape == j.points.shape
    assert t.problem.points.dtype == torch.float64 and t.problem.points.device == CPU


def test_multi_view_reconstruct_matches_jax(scene, jax_sampler):
    """Observed: rotations within 1.6e-5 deg, the last translation's
    direction within 6.4e-5 deg, cameras within 3.1e-5 of JAX's
    (translations up to about 1.6), rmse_after within 2.3e-6 relative."""
    frames, _ = scene
    j = j_front.multi_view_reconstruct(frames, 200.0)
    t = t_front.multi_view_reconstruct(frames, 200.0, device="cpu")
    assert j is not None and t is not None
    assert t.cams.shape == j.cams.shape and t.tracks.shape == j.tracks.shape
    for i in range(len(frames)):
        assert _rot_deg(t_ba._rodrigues(_t(t.cams[i, :3])).numpy(),
                        t_ba._rodrigues(_t(j.cams[i, :3])).numpy()) < 0.05
    tdir = [c[3:] / max(np.linalg.norm(c[3:]), 1e-12) for c in (t.cams[-1], j.cams[-1])]
    assert np.degrees(np.arccos(min(float(tdir[0] @ tdir[1]), 1.0))) < 0.1
    assert abs(t.rmse_after - j.rmse_after) <= 0.02 * j.rmse_after
    # camera translations along x grow monotonically (tests/test_epipolar.py)
    txs = t.cams[:, 3] * np.sign(t.cams[-1, 3])
    assert txs[0] == 0.0 and np.all(np.diff(txs) > 0)


def test_multi_view_needs_three_frames():
    frames, _ = render_scene(2, hw=(48, 64))
    with pytest.raises(ValueError, match=">= 3 frames"):
        t_front.multi_view_reconstruct(frames, 100.0, device="cpu")


def test_axis_angle_matches_jax():
    rng = np.random.RandomState(2)
    for th in (0.0, 1e-9, 0.3, np.pi - 1e-4):
        axis = rng.randn(3)
        R = _rot(axis, th) if th else np.eye(3)
        np.testing.assert_allclose(t_front._rotmat_to_axis_angle(R),
                                   j_front._rotmat_to_axis_angle(R), rtol=0, atol=1e-12)


# ---------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_multi_view_on_card_matches_cpu(cuda_device):
    """chip_smoke.py phase 13 (a) at 320x416: K2 builds both pyramids of
    every link (2 (N - 1) launches), the card's cameras within 1e-3 of the
    baseline of the CPU's, the bars of tests/test_epipolar.py."""
    from optical_flow_tpu_torch import kernels

    frames, _ = render_scene(6, hw=(320, 416), focal=400.0, step=0.02)
    kernels.reset_launch_counts()
    card = t_front.multi_view_reconstruct([torch.from_numpy(f).to(cuda_device) for f in frames],
                                          400.0)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["oft_pyramid"] == 2 * (len(frames) - 1)
    assert sum(counts.values()) == counts["oft_pyramid"]
    cpu = t_front.multi_view_reconstruct(frames, 400.0, device="cpu")
    assert card.rmse_after <= card.rmse_before and card.rmse_after < 3.0
    baseline = np.linalg.norm(cpu.cams[-1, 3:])
    centres = [-np.stack([t_ba._rodrigues(_t(c[:3])).numpy().T @ c[3:] for c in r.cams])
               for r in (card, cpu)]
    assert np.abs(centres[0] - centres[1]).max() <= 1e-3 * baseline
