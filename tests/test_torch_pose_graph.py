"""The port's pose graphs, place recognition, loop verification and
relocalization (optical_flow_tpu_torch/slam/pose_graph.py) against the JAX
package's (optical_flow_tpu/slam/pose_graph.py) on identical numpy inputs
made from a seed, on the CPU (JAX with x64, as tests/conftest.py sets it).
The scenes are tests/test_pose_graph.py's, rendered with numpy/scipy (no
cv2). Tolerances:

  _log_so3, float64 (theta 1e-8 .. 1e-2;       <= 1e-12 (near pi: <= 1e-8,
  near pi), and its Jacobian at the identity    the skew-part formula is
                                                ill-conditioned there)
  PoseGraph, Sim3PoseGraph (JAX's loops, the    rotations <= 1e-5,
  graphs carried over by convert.py; the port   translations and scales
  solves in float64, JAX in float32)            <= 1e-5 relative
  sim3_compose / sim3_inverse                   equal (the same numpy)
  umeyama_alignment (float64 against float32)   s, R <= 1e-5, t <= 1e-4
  resize weights of jax.image.resize            <= 1e-6
  thumbnail / place descriptors (unit norm)     <= 5e-6 / <= 2e-5 (float32 sums
                                                in another order)
  propose_loop_candidates                       the same pairs, distances 1e-5
  verify_loop_closure                           the same inlier count, R and
                                                t <= 1e-4
  relocalize (the port's PnP drawing JAX's      the same keyframe and inlier
  threefry sets)                                count, centre <= 1e-4
  measure_loop_sim3                             support within 2 (the trim
                                                gate), s <= 1e-5 relative,
                                                R, t <= 1e-4

The test marked ``cuda`` holds the card against the CPU and skips where
there is no card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

import test_pose_graph as jt
from optical_flow_tpu.slam import pose_graph as jp
from optical_flow_tpu.slam.epipolar import _exp_so3 as j_exp_so3
from optical_flow_tpu_torch import convert
from optical_flow_tpu_torch.slam import pnp as t_pnp
from optical_flow_tpu_torch.slam import pose_graph as tp
from test_torch_stereo import one_thread, smooth_scene  # noqa: F401 (one_thread: a fixture)


def _zoom(a, h, w):
    return ndimage.zoom(a, (h / a.shape[0], w / a.shape[1]), order=3)


def _slide(base, depth, tx, focal):
    """The camera slid tx along +x: bilinear, REFLECT_101 (cv2.remap's)."""
    h, w = base.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    img = ndimage.map_coordinates(base.astype(np.float32), [ys, xs + tx * focal / depth],
                                  order=1, mode="mirror")
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _rot_f64(w):
    return np.asarray(j_exp_so3(jnp.asarray(w, jnp.float64)))


@pytest.mark.parametrize("theta", [1e-8, 1e-5, 1e-2, 1.0, np.pi - 1e-3, np.pi - 1e-6])
def test_log_so3_matches_jax(theta):
    rng = np.random.RandomState(0)
    for _ in range(5):
        d = rng.randn(3)
        R = _rot_f64(d / np.linalg.norm(d) * theta)
        want = np.asarray(jp._log_so3(jnp.asarray(R)))
        got = tp._log_so3(torch.from_numpy(R)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-8 if theta > 3 else 1e-12)
    # batched form = one matrix at a time
    Rs = np.stack([_rot_f64(rng.randn(3) * 0.3) for _ in range(4)])
    np.testing.assert_allclose(tp._log_so3(torch.from_numpy(Rs)).numpy(),
                               np.stack([np.asarray(jp._log_so3(jnp.asarray(R))) for R in Rs]),
                               rtol=0, atol=1e-12)


def test_log_so3_jacobian_at_identity_matches_jax():
    """The reason for the floored form: finite derivatives at theta = 0."""
    eye = np.eye(3)
    want = np.asarray(jax.jacfwd(jp._log_so3)(jnp.asarray(eye)))
    got = torch.func.jacfwd(tp._log_so3)(torch.from_numpy(eye)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def _pose_loop():
    Rs_true, ts_true = jt._circle_trajectory()
    Rs_d, ts_d = jt._integrate_with_drift(Rs_true, ts_true)
    g = jp.PoseGraph.from_odometry(Rs_d, ts_d)
    R_lc, t_lc = jp.relative_pose(Rs_true[0], ts_true[0], Rs_true[-1], ts_true[-1])
    g.add_edge(0, len(Rs_true) - 1, R_lc, t_lc, weight=4.0)
    return g, Rs_true, ts_true


def _close(got, want, rot_atol=1e-5, rel=1e-5):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=rot_atol)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=rel * np.abs(want[1]).max())


@pytest.mark.parametrize("case", ["loop", "fixed_point"])
def test_pose_graph_matches_jax(case):
    if case == "loop":
        g, Rs_true, ts_true = _pose_loop()
        iters = 12
    else:
        g = jp.PoseGraph.from_odometry(*jt._circle_trajectory(N=10))
        iters = 5
    tg = convert.pose_graph_from_jax(g)
    np.testing.assert_allclose(tg.residual_norms(device="cpu"), g.residual_norms(), rtol=0,
                               atol=1e-6)
    want = g.optimize(iters=iters)
    got = tg.optimize(iters=iters, device="cpu")
    assert got[0].dtype == np.float32 and got[1].dtype == np.float32
    _close(got, want)
    if case == "loop":
        # tests/test_pose_graph.py's claims, on the port: the far end's
        # drift halves and pose 0 stays the gauge
        a0, d0 = jt._pose_errors(g.Rs, g.ts, Rs_true, ts_true)
        a1, d1 = jt._pose_errors(*got, Rs_true, ts_true)
        assert a1[-1] < 0.5 * a0[-1] and d1[-1] < 0.5 * d0[-1]
        np.testing.assert_allclose(got[0][0], g.Rs[0], atol=1e-6)


def _sim3_scale_drift():
    """tests/test_pose_graph.py's Sim(3) scene: odometry edges at scale 0.93
    and one true-scale loop edge."""
    Rs_true, ts_true = jt._circle_trajectory(N=16)
    edges = []
    for i in range(len(Rs_true) - 1):
        R_ij, t_ij = jp.relative_pose(Rs_true[i], ts_true[i], Rs_true[i + 1], ts_true[i + 1])
        edges.append((0.93, R_ij, t_ij))
    S = [(1.0, Rs_true[0], ts_true[0])]
    for m in edges:
        S.append(jp.sim3_compose(m, S[-1]))
    g = jp.Sim3PoseGraph(ss=np.asarray([s for s, _, _ in S], np.float32),
                         Rs=np.stack([R for _, R, _ in S]).astype(np.float32),
                         ts=np.stack([t for _, _, t in S]).astype(np.float32))
    for i, (s_m, R_m, t_m) in enumerate(edges):
        g.add_edge(i, i + 1, s_m, R_m, t_m)
    R_lc, t_lc = jp.relative_pose(Rs_true[0], ts_true[0], Rs_true[-1], ts_true[-1])
    g.add_edge(0, len(Rs_true) - 1, 1.0, R_lc, t_lc, weight=4.0)
    return g


@pytest.mark.parametrize("case", ["scale_drift", "fixed_point"])
def test_sim3_pose_graph_matches_jax(case):
    if case == "scale_drift":
        g, iters = _sim3_scale_drift(), 20
    else:
        g, iters = jp.Sim3PoseGraph.from_se3_odometry(*jt._circle_trajectory(N=8)), 5
    want = g.optimize(iters=iters)
    tg = convert.sim3_pose_graph_from_jax(g)
    got = tg.optimize(iters=iters, device="cpu")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=0)
    _close(got[1:], want[1:])
    np.testing.assert_allclose(tg.centers(*got), g.centers(*want), rtol=0,
                               atol=1e-5 * np.abs(g.centers(*want)).max())
    if case == "scale_drift":
        assert abs(got[0][0] - 1.0) < 1e-6 and got[0][-1] > 0.7  # the scales lift back


def test_sim3_compose_inverse_match_jax():
    rng = np.random.RandomState(2)
    a = (1.7, jt._rot(rng.randn(3), 0.4), rng.randn(3))
    b = (0.6, jt._rot(rng.randn(3), -0.9), rng.randn(3))
    for got, want in ((tp.sim3_compose(a, b), jp.sim3_compose(a, b)),
                      (tp.sim3_inverse(a), jp.sim3_inverse(a))):
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
    R = jt._rot([1.0, 2.0, 3.0], 0.3).astype(np.float32)
    for x, y in zip(tp.relative_pose(R, np.ones(3), R.T, np.zeros(3)),
                    jp.relative_pose(R, np.ones(3), R.T, np.zeros(3))):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("weighted", [False, True])
def test_umeyama_alignment_matches_jax(weighted):
    rng = np.random.RandomState(4)
    X = rng.randn(50, 3).astype(np.float32)
    Y = 0.37 * (X @ jt._rot([0.2, -1.0, 0.5], 0.8).T) + np.array([1.0, -2.0, 0.5])
    Y = Y + rng.randn(50, 3) * 0.01
    w = None
    if weighted:
        Y[:5] += 100.0
        w = np.ones(50)
        w[:5] = 0.0
    s_j, R_j, t_j = jp.umeyama_alignment(X, Y, w)
    s_t, R_t, t_t = tp.umeyama_alignment(X, Y, w)
    assert abs(s_t - s_j) <= 1e-5 * s_j
    np.testing.assert_allclose(R_t, R_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_t, t_j, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n_in,n_out", [(120, 64), (416, 64), (320, 16), (7, 3), (10, 16)])
def test_resize_weights_match_jax(n_in, n_out):
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

    want = np.asarray(compute_weight_mat(n_in, n_out, n_out / n_in, 0.0, _fill_triangle_kernel,
                                         True)).astype(np.float32)
    np.testing.assert_allclose(tp._resize_weights(n_in, n_out), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw", [(64, 64), (120, 160), (320, 416)])
def test_place_descriptors_match_jax(hw):
    rng = np.random.RandomState(hw[1])
    img = (rng.rand(*hw) * 255).astype(np.float32)
    smooth = _zoom(rng.rand(hw[0] // 8, hw[1] // 8), *hw).astype(np.float32) * 255
    for im in (img, smooth):
        np.testing.assert_allclose(tp.thumbnail_descriptor(im, device="cpu"),
                                   jp.thumbnail_descriptor(im), rtol=0, atol=5e-6)
        np.testing.assert_allclose(tp.place_descriptor(im, device="cpu"), jp.place_descriptor(im),
                                   rtol=0, atol=2e-5)


def test_propose_loop_candidates_matches_jax():
    rng = np.random.RandomState(1)
    imgs = [rng.rand(64, 64).astype(np.float32) for _ in range(15)]
    imgs.append(imgs[0] + rng.randn(64, 64).astype(np.float32) * 0.01)  # a revisit
    descs = [jp.place_descriptor(im) for im in imgs]
    for kw in ({}, dict(min_separation=3, max_candidates=8), dict(min_separation=20)):
        got = tp.propose_loop_candidates(descs, **kw)
        want = jp.propose_loop_candidates(descs, **kw)
        assert [c[:2] for c in got] == [c[:2] for c in want]
        np.testing.assert_allclose([c[2] for c in got], [c[2] for c in want], atol=1e-5)
    # the port's own descriptors rank the revisit first too
    ours = [tp.thumbnail_descriptor(im, device="cpu") for im in imgs]
    assert tp.propose_loop_candidates(ours, min_separation=10)[0][:2] == (0, 15)


def _slide_frames(seed=9, focal=400.0):
    """tests/test_pose_graph.py::test_relocalize_against_synthetic_map's
    frames: the camera slides 0.05 a frame along +x."""
    base, depth, _ = smooth_scene(seed=seed)
    return [base] + [_slide(base, depth, 0.05 * k, focal) for k in (1, 2, 3)], focal


def test_verify_loop_closure_matches_jax():
    frames, focal = _slide_frames()
    h, w = frames[0].shape
    for i, j in ((0, 3), (1, 2)):
        want = jp.verify_loop_closure(frames[i], frames[j], focal, w / 2.0, h / 2.0)
        got = tp.verify_loop_closure(frames[i], frames[j], focal, w / 2.0, h / 2.0, device="cpu")
        assert got is not None and want is not None
        assert got[2] == want[2]
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)
    assert got[1][0] < -0.99  # the camera moved +x: t points along -x
    # too few inliers: None in both
    assert tp.verify_loop_closure(frames[0], frames[3], focal, w / 2.0, h / 2.0,
                                  min_inliers=10_000, device="cpu") is None


def test_relocalize_matches_jax(monkeypatch):
    from test_torch_epipolar import _jax_sets

    from optical_flow_tpu_torch.slam.frontend import multi_view_reconstruct

    monkeypatch.setattr(t_pnp, "sample_hypotheses",
                        lambda valid, n, seed, k=4: _jax_sets(valid, n, seed, k).to(valid.device))
    frames, focal = _slide_frames()
    h, w = frames[0].shape
    # the map both relocalize against (the port's reconstruction; any map
    # will do, as long as both get the same)
    rec = multi_view_reconstruct(frames[:3], focal, device="cpu")
    tracks, points = rec.tracks, rec.points.astype(np.float32)
    want = jp.relocalize(frames[3], frames[:3], tracks, points, focal, w / 2.0, h / 2.0)
    got = tp.relocalize(frames[3], frames[:3], tracks, points, focal, w / 2.0, h / 2.0,
                        device="cpu")
    assert got[2] == want[2] == 2  # the nearest keyframe is the closest viewpoint
    assert got[3] == want[3] and got[3] >= 20
    c_got, c_want = -got[0].T @ got[1], -want[0].T @ want[1]
    np.testing.assert_allclose(c_got, c_want, rtol=0, atol=1e-4 * np.abs(c_want).max())
    # a frame that shares nothing with the map: None
    noise = (np.random.RandomState(3).rand(h, w) * 255).astype(np.uint8)
    assert tp.relocalize(noise, frames[:3], tracks, points, focal, w / 2.0, h / 2.0,
                         device="cpu") is None


def _revisit(seed=8, focal=400.0, sigma=0.6, tx=0.02):
    """tests/test_pose_graph.py::test_measure_loop_sim3_recovers_scale_drift:
    a revisit 0.02 along x; keyframe j's map at 0.6x scale."""
    base, depth, rng = smooth_scene(seed=seed)
    h, w = base.shape
    cx, cy = w / 2.0, h / 2.0
    frame_j = _slide(base, depth, tx, focal)
    uu, vv = np.meshgrid(np.arange(60, w - 60, 42), np.arange(60, h - 60, 42))
    uu, vv = uu.ravel(), vv.ravel()
    Z = depth[vv, uu]
    X = np.stack([(uu - cx) / focal * Z, (vv - cy) / focal * Z, Z], axis=1)
    obs_i = [(k, np.array([u, v], np.float32)) for k, (u, v) in enumerate(zip(uu, vv))]
    disp = tx * focal / Z
    obs_j = [(1000 + k, np.array([u - d + rng.uniform(-0.8, 0.8), v + rng.uniform(-0.8, 0.8)],
                                 np.float32))
             for k, (u, v, d) in enumerate(zip(uu, vv, disp))]
    points = {k: X[k] for k in range(len(uu))}
    points.update({1000 + k: sigma * X[k] for k in range(len(uu))})
    poses = (np.eye(3), np.zeros(3), np.eye(3), sigma * np.array([-tx, 0.0, 0.0]))
    return base, frame_j, obs_i, obs_j, points, poses


def test_measure_loop_sim3_matches_jax():
    img_i, img_j, obs_i, obs_j, points, poses = _revisit()
    want = jp.measure_loop_sim3(img_i, img_j, obs_i, obs_j, points, *poses)
    got = tp.measure_loop_sim3(img_i, img_j, obs_i, obs_j, points, *poses, device="cpu")
    assert got is not None and want is not None
    # the trim gate (residual <= 2.5 x median) compares residuals that JAX's
    # float32 alignment and the port's float64 one round apart: a point on
    # the gate may fall either way (observed: support 40 and 39)
    assert abs(got[3] - want[3]) <= 2 and got[3] >= 12
    assert abs(got[0] - want[0]) <= 1e-5 * want[0] and abs(got[0] - 0.6) < 0.03
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-4)
    # thin support: None in both (tests/test_pose_graph.py's degenerate inputs)
    I3, z3 = np.eye(3), np.zeros(3)
    few = {k: np.array([0.0, 0.0, 5.0]) for k in range(5)}
    for args in (([], [], {}), (obs_i, obs_i, {}), (obs_i[:5], obs_i[:5], few)):
        assert jp.measure_loop_sim3(img_i, img_i, *args, I3, z3, I3, z3) is None
        assert tp.measure_loop_sim3(img_i, img_i, *args, I3, z3, I3, z3, device="cpu") is None


@pytest.mark.cuda
def test_pose_graph_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    g = convert.sim3_pose_graph_from_jax(_sim3_scale_drift())
    for got, want in zip(g.optimize(iters=20), g.optimize(iters=20, device="cpu")):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    pg = convert.pose_graph_from_jax(_pose_loop()[0])
    for got, want in zip(pg.optimize(), pg.optimize(device="cpu")):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    frames, focal = _slide_frames()
    np.testing.assert_allclose(tp.place_descriptor(frames[0]),
                               tp.place_descriptor(frames[0], device="cpu"), atol=2e-5)
    h, w = frames[0].shape
    card = tp.verify_loop_closure(frames[0], frames[3], focal, w / 2.0, h / 2.0)
    cpu = tp.verify_loop_closure(frames[0], frames[3], focal, w / 2.0, h / 2.0, device="cpu")
    assert abs(card[2] - cpu[2]) <= 0.02 * cpu[2]
    np.testing.assert_allclose(card[0], cpu[0], atol=1e-3)
