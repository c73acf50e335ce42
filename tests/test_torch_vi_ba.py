"""The port's visual-inertial BA (optical_flow_tpu_torch/slam/vi_ba.py)
against the JAX package's (optical_flow_tpu/slam/vi_ba.py) on identical
numpy inputs made from a seed, on the CPU (JAX with x64, as
tests/conftest.py sets it), and the behavioural tests of
tests/test_vi_ba.py and tests/test_vi_ba_bias_states.py (all but the
sharded ones) at their own bars. Tolerances:

  _imu_residual, _imu_residual15 and       <= 1e-12 (float64); the mean square
  their Jacobians                          residual of _imu_system too
  _imu_system's H                          <= 1e-12 x max|.|
  _imu_system's b (sums that cancel)       <= 1e-9 x max|.|
  vi_bundle_adjust, float64, on            states, points, history <= 1e-8 (every
  tests/test_vi_ba.py's scene: 9-DOF,      point is seen by all 8 keyframes, so the
  15-DOF, robust                           point blocks are well conditioned and the
                                           two Schur forms agree to roundoff)
  refine_with_imu (float32, as JAX         JAX's bars, and camera centres within
  builds it)                               1e-3 of the 0.4 radius of JAX's
  group_imu_by_keyframes                   equal; its layout preintegrated: dR atol
                                           1e-6, dv and dp <= 1e-5 x max|.|
  convert.vi_problem_from_jax              a round trip that is exact
  sharded_vi_bundle_adjust, float64, 9-    states, points, history <= 1e-6 against
  and 15-DOF, on JAX's flow_mesh(2, 2, 2)  JAX's sharded solve (its own bar,
  and the port's 8 CPU slots               tests/test_vi_ba.py:265-300,
                                           tests/test_vi_ba_bias_states.py:185);
                                           <= 1e-9 against the port's unsharded
                                           solve; JAX's errors

The behavioural tests run the port in float32 (the dtype of
``refine_with_imu``); the monocular and stereo SlamResults they refine are
the port's own, built on the scenes of tests/test_torch_incremental.py.
tests/test_vi_ba.py's scene needs cv2, so the tests on it skip without
cv2, as that file's do. The test marked ``cuda`` runs on chip_smoke.py's
scene of the same trajectory, built without cv2 (held to
tests/test_vi_ba.py's here) so that it runs on a host without cv2, holds
the card against the CPU and skips where there is no card.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from optical_flow_tpu.parallel import flow_mesh as j_flow_mesh  # noqa: E402
from optical_flow_tpu.slam import imu as jimu  # noqa: E402
from optical_flow_tpu.slam import vi_ba as jv  # noqa: E402
from optical_flow_tpu_torch import convert  # noqa: E402
from optical_flow_tpu_torch.parallel import flow_mesh  # noqa: E402
from optical_flow_tpu_torch.slam import ba as tba  # noqa: E402
from optical_flow_tpu_torch.slam import imu as timu  # noqa: E402
from optical_flow_tpu_torch.slam import vi_ba as tv  # noqa: E402
from optical_flow_tpu_torch.slam.frontend import _rotmat_to_axis_angle  # noqa: E402
from test_torch_imu import assert_close, assert_deltas_match_jax  # noqa: E402
from test_torch_incremental import render_loop  # noqa: E402
from test_torch_stereo import one_thread, stereo_loop  # noqa: E402,F401 (one_thread: a fixture)

try:
    import cv2
except ImportError:
    cv2 = None
else:
    from test_vi_ba import FOCAL, _make_scene, _problem, _scale_of

G_W = np.asarray([0.0, -9.81, 0.0])
_FLOAT_FIELDS = ("states", "points", "obs", "dR", "dv", "dp", "interval_T", "gravity", "weight",
                 "baseline", "imu_weight", "bias_jac", "bias_rw_weight")


@pytest.fixture(scope="module")
def scene():
    """tests/test_vi_ba.py's scene: 8 keyframes, 120 points seen by all."""
    if cv2 is None:
        pytest.skip("tests/test_vi_ba.py's scene needs cv2")
    return _make_scene()


def _perturbed(sc, seed=7, vel=0.05):
    """test_vi_ba_converges_from_perturbed_init's start: (states, points)."""
    rng = np.random.RandomState(seed)
    states = np.concatenate([sc["cams"], sc["vel"]], -1)
    pert = states.copy()
    pert[1:, :3] += rng.randn(len(states) - 1, 3) * 0.01
    pert[1:, 3:6] += rng.randn(len(states) - 1, 3) * 0.02
    pert[:, 6:9] += rng.randn(len(states), 3) * vel
    return pert, sc["X"] + rng.randn(*sc["X"].shape) * 0.02


def _as_f32(jprob):
    """A float64 JAX problem as the port's float32 one."""
    prob = convert.vi_problem_from_jax(jprob)
    return prob._replace(**{k: getattr(prob, k).float() for k in _FLOAT_FIELDS
                            if getattr(prob, k) is not None})


def _centre_errors(states, sc):
    scale, est = _scale_of(np.asarray(states), sc)
    return scale, np.linalg.norm(est - sc["centers"], axis=1)


def _add_drifting_bias(sc, bg0, bg_slope, ba0, ba_slope):
    """tests/test_vi_ba_bias_states.py's biases b(t) = b0 + slope * t on the
    scene's exact IMU log (that module imports its helpers as
    ``tests.test_vi_ba``, which not every host can import)."""
    n = sc["dt"].shape[1]
    t = (sc["kf_t"][:-1][:, None] + np.arange(n)[None, :] * sc["dt"][0, 0])[..., None]
    return (sc["gyro"] + np.asarray(bg0) + np.asarray(bg_slope) * t,
            sc["accel"] + np.asarray(ba0) + np.asarray(ba_slope) * t)


def _bias_problem(sc, seed=5):
    """A 15-DOF problem on a drifting-bias log (the sharded bias-state
    test's), perturbed."""
    gyro, accel = _add_drifting_bias(sc, [0.005, -0.004, 0.006], [0.01, -0.008, 0.009], 0.0, 0.0)
    dR, dv, dp, J = jimu.preintegrate_with_bias_jacobians(gyro, accel, sc["dt"])
    pert, Xp = _perturbed(sc, seed=seed, vel=0.0)
    base = jv.BAProblem(cams=jnp.asarray(pert[:, :6]), points=jnp.asarray(Xp),
                        cam_idx=jnp.asarray(sc["cam_idx"]), pt_idx=jnp.asarray(sc["pt_idx"]),
                        obs=jnp.asarray(sc["obs"]), focal=FOCAL)
    return jv.vi_problem_from_ba(base, pert[:, 6:9], dR, dv, dp, np.sum(sc["dt"], -1), G_W,
                                 bias_jac=J)


def _outlier_obs(sc, seed=13):
    """test_robust_vi_ba_survives_gross_outliers' corruption: 1/12 of the
    observations moved by 30-60 px. Returns (obs, generator after it)."""
    rng = np.random.RandomState(seed)
    M = len(sc["obs"])
    bad = rng.choice(M, M // 12, replace=False)
    obs = sc["obs"].copy()
    obs[bad] += rng.uniform(30, 60, (len(bad), 2)) * np.sign(rng.randn(len(bad), 2))
    return obs, rng


# ------------------------------------------------------------------ parity


def test_imu_residuals_match_jax(scene):
    """Residuals, Jacobians and the assembled IMU system, 9- and 15-DOF, at
    the truth and at a perturbed state, float64."""
    sc = scene
    for jprob in (_problem(sc), _problem(sc, *_perturbed(sc)), _bias_problem(sc)):
        prob = convert.vi_problem_from_jax(jprob)
        if prob.states.shape[1] == 15:
            prob = prob._replace(states=prob.states + 1e-3)  # live bias deltas
            jprob = jprob._replace(states=jnp.asarray(prob.states.numpy()))
        C = prob.states.shape[0]
        H, b, msr = tv._imu_system(prob, C)
        jH, jb, jmsr = jax.jit(jv._imu_system, static_argnums=1)(jprob, C)
        assert H.dtype == b.dtype == msr.dtype == torch.float64
        assert_close(H, jH, rel=1e-12)
        assert_close(msr, jmsr, atol=1e-12)
        # b sums J^T r over the factors, J weighted 1e3 and r near 0 at the
        # truth: it cancels, so it is held to 1e-9 of its largest entry
        assert_close(b, jb, rel=1e-9)
        w3 = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
        args = [prob.states[2], prob.states[3], prob.dR[2], prob.dv[2], prob.dp[2],
                prob.interval_T[2], prob.gravity, w3]
        fn, jfn = tv._imu_residual_jac, jv._imu_residual_jac
        if prob.states.shape[1] == 15:
            args += [prob.bias_jac[2], torch.tensor([30.0, 4.0], dtype=torch.float64)]
            fn, jfn = tv._imu_residual_jac15, jv._imu_residual_jac15
        for got, want in zip(fn(*args), jax.jit(jfn)(*(jnp.asarray(a.numpy()) for a in args))):
            assert_close(got, want, atol=1e-12)


@pytest.mark.parametrize("mode", ["9dof", "15dof", "robust"])
def test_vi_bundle_adjust_matches_jax(scene, mode):
    sc = scene
    kw = dict(iters=12, lam=1e-4)
    if mode == "9dof":
        jprob = _problem(sc, *_perturbed(sc))
    elif mode == "15dof":
        jprob = _bias_problem(sc)
    else:
        obs, rng = _outlier_obs(sc)
        pert = np.concatenate([sc["cams"], sc["vel"]], -1)
        pert[1:, 3:6] += rng.randn(len(pert) - 1, 3) * 0.02
        jprob = _problem(dict(sc, obs=obs), states=pert)
        kw["robust_delta"] = 3.0
    jout, jhist = jv.vi_bundle_adjust(jprob, **kw)
    out, hist = tv.vi_bundle_adjust(convert.vi_problem_from_jax(jprob), **kw)
    assert hist.shape == (12, 2) and out.states.dtype == torch.float64
    for got, want in ((out.states, jout.states), (out.points, jout.points)):
        assert_close(got, want, atol=1e-8)
    assert_close(hist, jhist, rel=1e-8)
    assert out.weight is None or mode == "robust"


def _by_shard(jprob, sc, n=8):
    """tests/test_vi_ba.py's sharded layout: observations grouped by owning
    shard, pt_idx local to it."""
    order = np.argsort(sc["pt_idx"], kind="stable")
    return jprob._replace(cam_idx=jnp.asarray(sc["cam_idx"][order]),
                          pt_idx=jnp.asarray(sc["pt_idx"][order] % (len(sc["X"]) // n)),
                          obs=jnp.asarray(sc["obs"][order]))


@pytest.mark.parametrize("mode", ["9dof", "15dof"])
def test_sharded_vi_bundle_adjust_matches_jax(scene, mode):
    sc = scene
    jprob = _problem(sc, *_perturbed(sc)) if mode == "9dof" else _bias_problem(sc)
    js = _by_shard(jprob, sc)
    jout, jhist = jv.sharded_vi_bundle_adjust(js, j_flow_mesh(2, 2, 2), iters=4, lam=1e-4)
    out, hist = tv.sharded_vi_bundle_adjust(convert.vi_problem_from_jax(js),
                                            flow_mesh(2, 2, 2, devices=["cpu"] * 8), iters=4,
                                            lam=1e-4)
    assert hist.shape == (4, 2) and out.states.dtype == torch.float64
    for got, want in ((out.states, jout.states), (out.points, jout.points)):
        assert_close(got, want, atol=1e-6)
    assert_close(hist, jhist, rel=1e-6)
    flat, flat_hist = tv.vi_bundle_adjust(convert.vi_problem_from_jax(jprob), iters=4, lam=1e-4)
    for got, want in ((out.states, flat.states), (out.points, flat.points)):
        assert float((got - want).abs().max()) <= 1e-9
    assert float((hist - flat_hist).abs().max()) <= 1e-9 * float(flat_hist.abs().max())


def test_sharded_vi_bundle_adjust_raises_as_jax(scene):
    sc = scene
    js = _by_shard(_bias_problem(sc), sc)
    mesh, jmesh = flow_mesh(2, 2, 2, devices=["cpu"] * 8), j_flow_mesh(2, 2, 2)
    for bad in (js._replace(bias_jac=None), js._replace(points=js.points[:-1])):
        with pytest.raises(ValueError) as jerr:
            jv.sharded_vi_bundle_adjust(bad, jmesh, iters=1)
        with pytest.raises(ValueError) as terr:
            tv.sharded_vi_bundle_adjust(convert.vi_problem_from_jax(bad), mesh, iters=1)
        assert str(terr.value) == str(jerr.value)


def test_refine_with_imu_end_to_end_under_bias(scene):
    """tests/test_vi_ba.py: an up-to-scale solution and BIASED raw IMU logs
    -> a metric trajectory; the port's float32 solve within 1e-3 of the 0.4
    radius of JAX's."""
    sc = scene
    s_true = 3.0
    bg = np.asarray([0.01, -0.008, 0.012])
    ba = np.asarray([0.08, -0.05, 0.10])
    args = (sc["poses"], sc["trans"] / s_true, sc["X"] / s_true, sc["cam_idx"], sc["pt_idx"],
            sc["obs"], FOCAL, sc["gyro"] + bg, sc["accel"] + ba, sc["dt"])
    out, info = tv.refine_with_imu(*args, iters=12, device="cpu")
    jout, jinfo = jv.refine_with_imu(*args, iters=12)
    assert out.states.dtype == torch.float32 and info["history"].shape == (12, 2)
    assert abs(info["scale"] - s_true) / s_true < 0.05, info["scale"]
    np.testing.assert_allclose(info["gyro_bias"], bg, atol=2e-3)
    scale, err = _centre_errors(out.states.numpy(), sc)
    span = np.linalg.norm(sc["centers"], axis=1).max()
    assert err.mean() < 0.03 * span, (err.mean(), span)
    assert abs(scale - 1.0) < 0.03, scale
    _, est = _scale_of(out.states.numpy(), sc)
    _, jest = _scale_of(np.asarray(jout.states), sc)
    assert np.abs(est - jest).max() < 1e-3 * 0.4
    assert abs(info["scale"] - jinfo["scale"]) < 1e-5 * s_true


def test_group_imu_by_keyframes():
    """tests/test_vi_ba.py: counts, durations and tail drop; the layout equal
    to JAX's and preintegrated as JAX's and as each slice alone."""
    rate = 100.0
    t = np.arange(0, 4.0, 1.0 / rate)
    rng = np.random.RandomState(2)
    gyro = rng.randn(len(t), 3) * 0.3
    accel = rng.randn(len(t), 3)
    kf_t = np.asarray([0.0, 1.0, 2.0, 3.0])
    got = tv.group_imu_by_keyframes(t, gyro, accel, kf_t)
    for a, b in zip(got, jv.group_imu_by_keyframes(t, gyro, accel, kf_t)):
        np.testing.assert_array_equal(a, b)
    g, a, h, ok = got
    assert g.shape[0] == 3 and ok.sum(axis=1).tolist() == [100, 100, 100]
    np.testing.assert_allclose((h * ok).sum(axis=1), 1.0, atol=1e-9)
    assert ok.sum() == 300  # samples at or after kf_t[-1] are dropped
    deltas = timu.preintegrate(g, a, h, ok, device="cpu")
    assert_deltas_match_jax(deltas, jimu.preintegrate(g, a, h, ok))
    first = timu.preintegrate(gyro[:100], accel[:100], np.full(100, 0.01), device="cpu")
    for x, y in zip(deltas, first):
        np.testing.assert_allclose(x[0].numpy(), y.numpy(), atol=1e-6)
    with pytest.raises(ValueError):
        tv.group_imu_by_keyframes(t[:1], gyro[:1], accel[:1], kf_t)


def test_vi_problem_from_jax_round_trip(scene):
    jprob = _bias_problem(scene)._replace(weight=jnp.ones(len(scene["obs"])),
                                          baseline=jnp.zeros(len(scene["obs"])))
    prob = convert.vi_problem_from_jax(jprob)
    assert prob.focal == FOCAL and prob.states.shape == (8, 15)
    for name in tv.VIBAProblem._fields:
        if name != "focal":
            got, want = getattr(prob, name), np.asarray(getattr(jprob, name))
            assert isinstance(got, torch.Tensor) and got.dtype == torch.from_numpy(want).dtype
            np.testing.assert_array_equal(got.numpy(), want)
    bare = convert.vi_problem_from_jax(_problem(scene))
    assert bare.bias_jac is None and bare.weight is None and bare.bias_rw_weight is None


# ------------------------------------------------------- behaviour (float32)


def test_vi_residuals_zero_at_ground_truth(scene):
    """At the truth every residual is integration error only (the
    conventions: world->cam poses, c = -R^T t, body == camera, gravity)."""
    prob = _as_f32(_problem(scene))
    w3 = torch.ones(3)
    for i in range(len(scene["kf_t"]) - 1):
        r = tv._imu_residual(prob.states[i], prob.states[i + 1], prob.dR[i], prob.dv[i],
                             prob.dp[i], prob.interval_T[i], prob.gravity, w3).numpy()
        assert np.abs(r[:3]).max() < 2e-4, (i, r)  # rad
        assert np.abs(r[3:6]).max() < 2e-3, (i, r)  # m/s (float32 preintegration)
        assert np.abs(r[6:9]).max() < 1e-3, (i, r)  # m


def test_vi_ba_converges_from_perturbed_init(scene):
    sc = scene
    out, hist = tv.vi_bundle_adjust(_as_f32(_problem(sc, *_perturbed(sc))), iters=12, lam=1e-4)
    scale, err = _centre_errors(out.states.numpy(), sc)
    assert err.mean() < 5e-3, err
    assert abs(scale - 1.0) < 0.01, scale
    assert np.abs(out.states.numpy()[:, 6:9] - sc["vel"]).max() < 0.03
    assert hist[-1, 0] < hist[0, 0]


def test_vi_ba_recovers_metric_scale_where_vision_cannot(scene):
    """Scale the whole solution by 1.15: vision-only BA leaves it there (a
    gauge), the IMU factors pull it back."""
    sc = scene
    s0 = 1.15
    scaled = np.concatenate([sc["cams"], sc["vel"]], -1)
    scaled[:, 3:9] *= s0  # t = -R c and v scale with c
    Xs = sc["X"] * s0
    vis, _ = tba.bundle_adjust(
        tba.BAProblem(torch.tensor(scaled[:, :6], dtype=torch.float32),
                      torch.tensor(Xs, dtype=torch.float32), torch.from_numpy(sc["cam_idx"]),
                      torch.from_numpy(sc["pt_idx"]), torch.tensor(sc["obs"], dtype=torch.float32),
                      FOCAL), iters=8)
    s_vis, _ = _centre_errors(np.concatenate([vis.cams.numpy(), scaled[:, 6:9]], -1), sc)
    assert s_vis > 1.12, s_vis
    out, _ = tv.vi_bundle_adjust(_as_f32(_problem(sc, states=scaled, points=Xs)), iters=15,
                                 lam=1e-4)
    s_vi, err = _centre_errors(out.states.numpy(), sc)
    assert abs(s_vi - 1.0) < 0.015, s_vi
    assert err.mean() < 5e-3, err


def test_robust_vi_ba_survives_gross_outliers(scene):
    """Huber IRLS on the visual residuals: squared loss drags the trajectory,
    the robust solve stays near clean-data accuracy."""
    sc = scene
    obs, rng = _outlier_obs(sc)
    pert = np.concatenate([sc["cams"], sc["vel"]], -1)
    pert[1:, 3:6] += rng.randn(len(pert) - 1, 3) * 0.02
    prob = _as_f32(_problem(dict(sc, obs=obs), states=pert))
    out_sq, _ = tv.vi_bundle_adjust(prob, iters=12, lam=1e-4)
    out_rb, _ = tv.vi_bundle_adjust(prob, iters=12, lam=1e-4, robust_delta=3.0)
    err_sq = _centre_errors(out_sq.states.numpy(), sc)[1].mean()
    err_rb = _centre_errors(out_rb.states.numpy(), sc)[1].mean()
    assert err_rb < 5e-3, err_rb
    assert err_rb < 0.5 * err_sq, (err_rb, err_sq)


def test_vi_ba_rejects_single_keyframe(scene):
    prob = _as_f32(_problem(scene))
    with pytest.raises(ValueError, match=">= 2 keyframes"):
        tv.vi_bundle_adjust(prob._replace(states=prob.states[:1]))
    with pytest.raises(ValueError, match="bias_jac"):
        tv.vi_bundle_adjust(prob._replace(states=torch.cat([prob.states, prob.states[:, :6]], 1)),
                            iters=1)


def _refine_drift(sc, **kw):
    s_true = 3.0
    gyro, accel = _add_drifting_bias(sc, [0.01, -0.008, 0.012], [0.016, -0.012, 0.014],
                                     [0.08, -0.05, 0.10], 0.0)
    return tv.refine_with_imu(sc["poses"], sc["trans"] / s_true, sc["X"] / s_true, sc["cam_idx"],
                              sc["pt_idx"], sc["obs"], FOCAL, gyro, accel, sc["dt"], iters=12,
                              device="cpu", **kw)


def test_bias_states_recover_drifting_gyro_bias(scene):
    """tests/test_vi_ba_bias_states.py: under a drifting gyro bias the
    frozen-bias refinement degrades, the 15-DOF solve recovers the
    trajectory and tracks the per-keyframe bias walk."""
    sc = scene
    out_f, _ = _refine_drift(sc)
    out_b, info_b = _refine_drift(sc, bias_states=True, bias_rw_weight=(1e2, 1e2))
    assert out_b.states.shape == (8, 15)
    err_f = _centre_errors(out_f.states.numpy(), sc)[1].mean()
    err_b = _centre_errors(out_b.states.numpy(), sc)[1].mean()
    span = np.linalg.norm(sc["centers"], axis=1).max()
    assert err_f > 2.0 * err_b, (err_f, err_b)
    assert err_b < 0.03 * span, (err_b, span)
    bg_slope = np.asarray([0.016, -0.012, 0.014])
    true_bg = np.asarray([0.01, -0.008, 0.012])[None] + bg_slope[None] * sc["kf_t"][:, None]
    track_err = np.abs(info_b["gyro_bias_per_kf"] - true_bg)
    assert track_err.mean() < 0.2 * np.abs(bg_slope * sc["kf_t"][-1]).mean(), track_err


def test_bias_states_noop_on_clean_log(scene):
    """With constant biases the 15-DOF solve matches the frozen-bias one and
    its bias deltas stay near zero."""
    sc = scene
    s_true = 2.0
    args = (sc["poses"], sc["trans"] / s_true, sc["X"] / s_true, sc["cam_idx"], sc["pt_idx"],
            sc["obs"], FOCAL, sc["gyro"] + [0.01, -0.008, 0.012], sc["accel"] + [0.08, -0.05, 0.10],
            sc["dt"])
    out_f, _ = tv.refine_with_imu(*args, iters=12, device="cpu")
    out_b, _ = tv.refine_with_imu(*args, iters=12, bias_states=True, device="cpu")
    _, est_f = _scale_of(out_f.states.numpy(), sc)
    _, est_b = _scale_of(out_b.states.numpy(), sc)
    np.testing.assert_allclose(est_b, est_f, atol=5e-3)
    assert np.abs(out_b.states.numpy()[:, 9:15]).max() < 5e-3


# ------------------------------------------------- on the port's SlamResults

PERIOD = 6.0  # s, one loop
MONO_FRAMES = 10


def _loop_imu(rate=200.0, radius=1.0):
    """The continuous IMU log of the true loop: zero gyro (R = I), accel a -
    g. Returns (t, gyro, accel)."""
    om = 2 * np.pi / PERIOD
    t = np.arange(0.0, PERIOD, 1.0 / rate)
    acc = radius * np.stack([-0.12 * om * om * np.sin(om * t), 0.08 * om * om * np.cos(om * t),
                             np.zeros_like(t)], -1)
    return t, np.zeros((len(t), 3)), acc - G_W


@pytest.fixture(scope="module")
def mono_slam():
    """The port's monocular SlamResult on the loop (no loop closure, as the
    JAX tests run it), 10 frames where they take 12, for time."""
    from optical_flow_tpu_torch.slam import incremental_slam

    frames, centers = render_loop(n_frames=MONO_FRAMES)
    res = incremental_slam(frames, 400.0, loop_min_separation=20, min_tracks=40, window=8,
                           device="cpu")
    assert res is not None and len(res.keyframes) >= 6
    return res, centers


def _true_keyframe_centres(res, centers):
    return np.asarray([centers[i] for i in res.keyframes])


def test_alignment_on_monocular_slam_result(mono_slam):
    """tests/test_imu.py: an up-to-scale SlamResult plus an IMU log of the
    true loop -> the metric scale of an oracle fit against the truth."""
    res, centers = mono_slam
    n = MONO_FRAMES
    om = 2 * np.pi / PERIOD
    kf_t = np.asarray(res.keyframes) * (PERIOD / n)
    segs = []
    for i in range(len(kf_t) - 1):
        m = int(round((kf_t[i + 1] - kf_t[i]) * 200.0))
        ts = kf_t[i] + (np.arange(m) + 0.5) / 200.0
        acc = np.stack([-0.12 * om * om * np.sin(om * ts), 0.08 * om * om * np.cos(om * ts),
                        np.zeros_like(ts)], -1)
        segs.append((acc - G_W, np.full(m, 1 / 200.0)))
    width = max(len(h) for _, h in segs)
    accel = np.zeros((len(segs), width, 3))
    dt = np.zeros((len(segs), width))
    ok = np.zeros((len(segs), width), bool)
    for i, (a, h) in enumerate(segs):
        accel[i, :len(h)], dt[i, :len(h)], ok[i, :len(h)] = a, h, True
    _, dv, dp = timu.preintegrate(np.zeros_like(accel), accel, dt, valid=ok, device="cpu")
    s, g, _, _ = timu.visual_inertial_alignment(res.poses, res.trans, np.diff(kf_t), dv, dp,
                                                gravity_mag=9.81)
    est = res.centers()
    true = _true_keyframe_centres(res, centers)
    s_oracle = np.linalg.norm(true[1]) / max(np.linalg.norm(est[1]), 1e-12)
    err = np.linalg.norm(est * s - true, axis=1)
    assert abs(s - s_oracle) / s_oracle < 0.15, (s, s_oracle)
    assert err.mean() < 0.05, (s, s_oracle, err)
    np.testing.assert_allclose(g / np.linalg.norm(g), G_W / 9.81, atol=0.1)


def _refined_centres(out):
    poses, trans = tv.states_to_poses(out.states)
    return np.stack([-R.T @ t for R, t in zip(poses, trans)])


def test_refine_slam_result_with_imu(mono_slam):
    """tests/test_vi_ba.py: the finished monocular solution and the
    continuous IMU log -> a metric trajectory, no scale fit anywhere."""
    res, centers = mono_slam
    assert res.cam_idx is not None and len(res.cam_idx) > 100
    cams6 = np.concatenate([np.stack([_rotmat_to_axis_angle(R.astype(np.float64))
                                      for R in res.poses]), res.trans], -1)
    f64 = [np.asarray(x, np.float64) for x in (cams6, res.points, res.obs, res.obs_baseline)]
    rmse = float(tba.reprojection_rmse(tba.BAProblem(f64[0], f64[1], res.cam_idx, res.pt_idx,
                                                     f64[2], 400.0, baseline=f64[3]),
                                       device="cpu"))
    assert rmse < 2.0, rmse
    t, gyro, accel = _loop_imu()
    kf_t = np.asarray(res.keyframes) * (PERIOD / MONO_FRAMES)
    out, info = tv.refine_slam_with_imu(res, 400.0, t, gyro, accel, kf_t,
                                        estimate_accel_bias=False, device="cpu")
    assert info["scale_applied"] == info["scale"]
    est = _refined_centres(out)
    true = _true_keyframe_centres(res, centers)
    err = np.linalg.norm(est - true, axis=1)
    assert err.mean() < 0.05, (info["scale"], err)
    span_est = np.linalg.norm(est[1:] - est[:-1], axis=1).sum()
    span_true = np.linalg.norm(true[1:] - true[:-1], axis=1).sum()
    assert abs(span_est / span_true - 1.0) < 0.15, (span_est, span_true)


def test_refine_stereo_slam_result_keeps_metric():
    """tests/test_vi_ba.py: a stereo SlamResult is already metric, so the
    alignment's scale is not applied and the refinement stays at stereo
    accuracy."""
    from optical_flow_tpu_torch.slam import incremental_slam

    n = 6  # the JAX test's rig and loop, 6 frames where it takes 10, for time
    pairs, centers = stereo_loop(n_frames=n, baseline=0.3)
    res = incremental_slam([np.stack(p) for p in pairs], 400.0, stereo_baseline=0.3,
                           loop_min_separation=20, min_tracks=40, window=8, device="cpu")
    assert res is not None and np.any(res.obs_baseline != 0)
    true = _true_keyframe_centres(res, centers)
    err_in = np.linalg.norm(res.centers() - true, axis=1).mean()
    t, gyro, accel = _loop_imu()
    out, info = tv.refine_slam_with_imu(res, 400.0, t, gyro, accel,
                                        np.asarray(res.keyframes) * (PERIOD / n),
                                        estimate_accel_bias=False, device="cpu")
    assert info["scale_applied"] == 1.0, info
    err_out = np.linalg.norm(_refined_centres(out) - true, axis=1).mean()
    assert err_out < max(2.0 * err_in, 0.05), (err_in, err_out)


# ---------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_chip_smoke_vi_scene_matches_jax_scene(scene):
    """chip_smoke.py's cv2-free scene (phase 15 and the card test below) has
    tests/test_vi_ba.py's trajectory, poses, velocities and IMU log."""
    import chip_smoke

    sc = chip_smoke.vi_scene(C=8, P=50)
    for key in ("kf_t", "poses", "trans", "centers", "vel", "dt"):
        np.testing.assert_allclose(sc[key], scene[key], atol=1e-9, err_msg=key)
    np.testing.assert_allclose(sc["cams"][:, :3], scene["cams"][:, :3], atol=1e-9)
    np.testing.assert_allclose(sc["gyro"], scene["gyro"], atol=1e-6)  # finite differences
    np.testing.assert_allclose(sc["accel"], scene["accel"], atol=1e-9)


@pytest.mark.cuda
def test_vi_bundle_adjust_on_card_matches_cpu(cuda_device):
    """chip_smoke.py's scene at 8 keyframes and 600 points, its start
    perturbed as test_vi_ba_converges_from_perturbed_init's: float64, the
    card within 1e-8 m of the CPU; float32 (index_add_ sums in another
    order) within 1e-4 m; both at that test's bars."""
    import chip_smoke

    sc = chip_smoke.vi_scene(C=8, P=600)
    prob32 = chip_smoke.vi_problem(sc, "cpu")
    prob64 = prob32._replace(**{k: getattr(prob32, k).double() for k in _FLOAT_FIELDS
                                if getattr(prob32, k) is not None})
    for prob, tol in ((prob64, 1e-8), (prob32, 1e-4)):
        card, hist = tv.vi_bundle_adjust(prob, iters=12, lam=1e-4, device=cuda_device)
        assert card.states.device.type == "cuda"
        cpu, _ = tv.vi_bundle_adjust(prob, iters=12, lam=1e-4)
        r, est_card = chip_smoke.vi_summary(card, hist, sc)
        assert np.abs(est_card - chip_smoke.state_centres(cpu.states)).max() <= tol
        assert r["centre_err_mean_m"] < 5e-3 and abs(r["scale"] - 1.0) < 0.01, r
        assert r["vel_err_max"] < 0.03 and r["hist_vis_last"] < r["hist_vis_first"], r


@pytest.mark.cuda
def test_sharded_vi_bundle_adjust_on_card(cuda_device):
    """chip_smoke.py phase 17 (b) at a smaller size: an 8-slot mesh that
    repeats the card against vi_bundle_adjust on the card, float32, 9- and
    15-DOF, within the card-vs-CPU bar of the test above (1e-4 m)."""
    import chip_smoke

    sc = chip_smoke.vi_scene(C=8, P=600)
    mesh = flow_mesh(2, 2, 2, devices=[cuda_device] * 8)
    for bias in (False, True):
        prob = chip_smoke.vi_problem(sc, cuda_device, bias_jac=bias)
        flat, _ = tv.vi_bundle_adjust(prob, iters=12, lam=1e-4)
        out, hist = tv.sharded_vi_bundle_adjust(prob._replace(pt_idx=prob.pt_idx % (600 // 8)),
                                                mesh, iters=12, lam=1e-4)
        assert out.states.device.type == "cuda" and hist.shape == (12, 2)
        r, est = chip_smoke.vi_summary(out, hist, sc)
        assert np.abs(est - chip_smoke.state_centres(flat.states)).max() <= 1e-4
        chip_smoke.vi_bars("sharded", r)
