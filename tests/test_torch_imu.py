"""The port's IMU preintegration and visual-inertial alignment
(optical_flow_tpu_torch/slam/imu.py) against the JAX package's
(optical_flow_tpu/slam/imu.py) on identical numpy inputs made from a seed,
on the CPU, and the behavioural tests of tests/test_imu.py and
tests/test_vi_ba_bias_states.py at their own bars. Tolerances:

  _exp_so3, _log_so3 (float64)             <= 1e-12
  preintegrate (float32 in both)           dR atol 1e-6; dv, dp <= 1e-5 x max|.|
  bias Jacobians, _rotation_residuals'     <= 1e-5 x max|.|, finite at zero rates
  Jacobian
  _rotation_residuals                      atol 1e-6 (preintegrate's dR bar)
  estimate_gyro_bias                       <= 1e-6 rad/s
  visual_inertial_alignment (float64)      <= 1e-9
  visual_inertial_alignment_with_bias      s, g, v, ba <= 1e-5 relative; bg, the
                                           estimate_gyro_bias result, <= 1e-6 rad/s

The JAX tests' scenes need cv2 (as those tests do, by ``importorskip``);
the test marked ``cuda`` makes its own inputs, so that it runs on a host
without cv2, holds the card against the CPU and skips where there is no
card.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from optical_flow_tpu.slam import imu as jimu  # noqa: E402
from optical_flow_tpu_torch.slam import imu as timu  # noqa: E402
from test_imu import G_W, _loop_trajectory, _rotating_trajectory  # noqa: E402
from test_torch_stereo import one_thread  # noqa: E402,F401 (a fixture)


@pytest.fixture(scope="module")
def cv2():
    return pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def scene4(cv2):
    """tests/test_vi_ba.py's scene at 4 keyframes (that module needs cv2)."""
    from test_vi_ba import _make_scene

    return _make_scene(K=4)


def assert_close(got, want, rel=None, atol=None):
    """max |got - want| <= atol, or <= rel x max |want|."""
    got, want = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, np.float64)
                 for x in (got, want))
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = atol if atol is not None else rel * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bound, (err, bound)


def assert_deltas_match_jax(got, want):
    dR, dv, dp = got
    assert dR.dtype == dv.dtype == dp.dtype == torch.float32
    assert_close(dR, want[0], atol=1e-6)
    assert_close(dv, want[1], rel=1e-5)
    assert_close(dp, want[2], rel=1e-5)


def test_so3_helpers_match_jax():
    rng = np.random.RandomState(0)
    ws = np.concatenate([np.zeros((1, 3)), rng.randn(4, 3) * 1e-7, rng.randn(4, 3) * 1e-3,
                         rng.randn(8, 3) * 0.5])
    R = timu._exp_so3(torch.from_numpy(ws))
    assert_close(R, jax.vmap(jimu._exp_so3)(jnp.asarray(ws)), atol=1e-12)
    assert_close(timu._log_so3(R), jax.vmap(jimu._log_so3)(jnp.asarray(R.numpy())), atol=1e-12)
    # the guards keep the derivative finite where both branches are taken
    for f in (timu._exp_so3, lambda w: timu._log_so3(timu._exp_so3(w))):
        for dtype in (torch.float64, torch.float32):
            J = torch.func.jacfwd(f)(torch.zeros(3, dtype=dtype))
            assert torch.isfinite(J).all()


def test_preintegrate_matches_jax():
    rng = np.random.RandomState(1)
    gyro = rng.randn(3, 80, 3) * 0.8
    accel = rng.randn(3, 80, 3) + G_W
    dt = rng.uniform(0.004, 0.006, (3, 80))
    ok = np.ones((3, 80), bool)
    ok[1, 50:] = False
    ok[2] = False
    got = timu.preintegrate(gyro, accel, dt, ok, device="cpu")
    assert_deltas_match_jax(got, jimu.preintegrate(gyro, accel, dt, ok))
    # a tensor stays on its device; the leading axes come back as they went
    got = timu.preintegrate(torch.from_numpy(gyro[None]), accel[None], dt[None])
    assert got[0].shape == (1, 3, 3, 3) and got[1].shape == (1, 3, 3)
    assert_deltas_match_jax([x[0] for x in got], jimu.preintegrate(gyro, accel, dt))


def test_preintegrate_constant_rates_closed_form(cv2):
    """tests/test_imu.py: constant rate about one axis, constant specific
    force; dR = exp([w]x T), dv and dp against a float64 numpy loop."""
    N, h = 400, 0.0025  # T = 1 s
    w = np.asarray([0.0, 0.0, 1.3])
    a = np.asarray([0.4, -0.2, 9.0])
    dR, dv, dp = timu.preintegrate(np.tile(w, (N, 1)), np.tile(a, (N, 1)), np.full(N, h),
                                   device="cpu")
    np.testing.assert_allclose(dR.numpy(), cv2.Rodrigues(w * N * h)[0], atol=1e-5)
    R, v, p = np.eye(3), np.zeros(3), np.zeros(3)
    for _ in range(N):
        aw = (R @ cv2.Rodrigues(w * (h / 2))[0]) @ a  # midpoint rotation
        p = p + v * h + 0.5 * aw * h * h
        v = v + aw * h
        R = R @ cv2.Rodrigues(w * h)[0]
    np.testing.assert_allclose(dv.numpy(), v, atol=1e-4)
    np.testing.assert_allclose(dp.numpy(), p, atol=1e-4)


def test_preintegrate_batched_and_padded():
    """tests/test_imu.py: a padded interval matches its unpadded integration;
    all padding gives identity."""
    rng = np.random.RandomState(3)
    g1, a1, dt1 = rng.randn(50, 3) * 0.5, rng.randn(50, 3), np.full(50, 0.004)
    dR1, dv1, dp1 = timu.preintegrate(g1, a1, dt1, device="cpu")
    gp, ap, dtp = np.zeros((2, 80, 3)), np.zeros((2, 80, 3)), np.zeros((2, 80))
    ok = np.zeros((2, 80), bool)
    gp[0, :50], ap[0, :50], dtp[0, :50], ok[0, :50] = g1, a1, dt1, True
    dR, dv, dp = timu.preintegrate(gp, ap, dtp, valid=ok, device="cpu")
    np.testing.assert_allclose(dR[0].numpy(), dR1.numpy(), atol=1e-6)
    np.testing.assert_allclose(dv[0].numpy(), dv1.numpy(), atol=1e-6)
    np.testing.assert_allclose(dp[0].numpy(), dp1.numpy(), atol=1e-6)
    np.testing.assert_allclose(dR[1].numpy(), np.eye(3), atol=1e-7)
    np.testing.assert_allclose(dv[1].numpy(), 0, atol=1e-7)


def _alignment_both(poses, trans, T, dv, dp, **kw):
    got = timu.visual_inertial_alignment(poses, trans, T, dv, dp, **kw)
    want = jimu.visual_inertial_alignment(poses, trans, T, np.asarray(dv), np.asarray(dp), **kw)
    for a, b in zip(got, want):
        assert_close(a, b, atol=1e-9)
    return got


def test_alignment_recovers_scale_and_gravity():
    """tests/test_imu.py's bars, and JAX's alignment on the same deltas."""
    s_true = 3.7
    centers, kf_t, gyro, accel, dt = _loop_trajectory()
    _, dv, dp = timu.preintegrate(gyro, accel, dt, device="cpu")
    poses = np.tile(np.eye(3), (len(centers), 1, 1))
    s, g, v, rms = _alignment_both(poses, -centers / s_true, np.diff(kf_t), dv, dp)
    assert abs(s - s_true) / s_true < 0.02, s
    np.testing.assert_allclose(g, G_W, atol=0.15)
    assert rms < 1e-2, rms
    om = 2 * np.pi / 6.0
    np.testing.assert_allclose(v[0], [0.12 * om, 0.0, 0.0], atol=0.02)


def test_alignment_gravity_mag_refinement():
    centers, kf_t, gyro, accel, dt = _loop_trajectory()
    _, dv, dp = timu.preintegrate(gyro, accel, dt, device="cpu")
    poses = np.tile(np.eye(3), (len(centers), 1, 1))
    s, g, _, _ = _alignment_both(poses, -centers / 2.0, np.diff(kf_t), dv, dp, gravity_mag=9.81)
    assert abs(np.linalg.norm(g) - 9.81) < 1e-9
    assert abs(s - 2.0) / 2.0 < 0.02


def test_alignment_rejects_too_few_keyframes():
    with pytest.raises(ValueError):
        timu.visual_inertial_alignment(np.tile(np.eye(3), (2, 1, 1)), np.zeros((2, 3)),
                                       np.ones(1), np.zeros((1, 3)), np.zeros((1, 3)))


def test_gyro_bias_estimation_recovers_injected_bias(cv2):
    bg_true = np.asarray([0.01, -0.008, 0.012])
    _, poses, _, gyro, _, dt = _rotating_trajectory()
    bg = timu.estimate_gyro_bias(poses, gyro + bg_true, dt, device="cpu")
    np.testing.assert_allclose(bg, bg_true, atol=1.5e-3)
    assert_close(bg, jimu.estimate_gyro_bias(poses, gyro + bg_true, dt), atol=1e-6)


def test_alignment_with_bias_under_realistic_biases(cv2):
    """tests/test_imu.py: under bg = 0.01 rad/s and ba = 0.1 m/s^2 the
    bias-free solver fails and the bias-estimating one recovers the scale;
    JAX's on the same logs within 1e-5 relative."""
    s_true = 3.7
    bg_true = np.asarray([0.01, -0.006, 0.008])
    ba_true = np.asarray([0.10, -0.07, 0.05])
    centers, poses, kf_t, gyro, accel, dt = _rotating_trajectory()
    gyro_m, accel_m = gyro + bg_true, accel + ba_true
    trans = np.stack([-R @ c for R, c in zip(poses, centers)]) / s_true
    _, dv_b, dp_b = timu.preintegrate(gyro_m, accel_m, dt, device="cpu")
    s_biased, _, _, rms_biased = timu.visual_inertial_alignment(
        poses, trans, np.diff(kf_t), dv_b, dp_b, gravity_mag=9.81)
    assert abs(s_biased - s_true) / s_true > 0.05, s_biased

    got = timu.visual_inertial_alignment_with_bias(
        poses, trans, np.diff(kf_t), gyro_m, accel_m, dt, gravity_mag=9.81,
        estimate_accel_bias=True, device="cpu")
    want = jimu.visual_inertial_alignment_with_bias(
        poses, trans, np.diff(kf_t), gyro_m, accel_m, dt, gravity_mag=9.81,
        estimate_accel_bias=True)
    for i in (0, 1, 2, 4):  # s, g, v, ba
        assert_close(got[i], want[i], rel=1e-5)
    # bg comes from estimate_gyro_bias, held at its own bar (1e-5 of 0.01
    # rad/s would be below the float32 roundoff of the rotation products:
    # measured 1.3e-7 rad/s)
    assert_close(got[3], want[3], atol=1e-6)
    s, g, v, bg, ba, rms = got
    assert abs(s - s_true) / s_true < 0.03, (s, s_true)
    np.testing.assert_allclose(bg, bg_true, atol=1.5e-3)
    np.testing.assert_allclose(ba, ba_true, atol=0.04)
    np.testing.assert_allclose(g / np.linalg.norm(g), G_W / np.linalg.norm(G_W), atol=0.05)
    assert rms < rms_biased


def _rotation_problem(gyro, dt, poses):
    R_rel = np.stack([poses[i] @ poses[i + 1].T for i in range(len(poses) - 1)]).astype(np.float32)
    ok = np.ones(dt.shape, bool)
    return [np.asarray(x, np.float32) for x in (gyro, dt)] + [ok, R_rel]


def test_gyro_bias_jacobian_finite_at_zero_rates(cv2):
    """tests/test_imu.py's regression (an exactly zero gyro log), and the
    residuals and their Jacobian against JAX's jacrev there and on a
    rotating log."""
    rng = np.random.RandomState(0)
    K = 5
    poses = np.stack([cv2.Rodrigues(rng.randn(3) * 1e-3)[0] for _ in range(K)])
    zero_log = (np.zeros((K - 1, 20, 3)), np.full((K - 1, 20), 0.005), poses)
    _, rposes, _, gyro, _, dt = _rotating_trajectory()
    bg = np.asarray([0.004, -0.002, 0.003], np.float32)
    for (g, h, P), b in ((zero_log, np.zeros(3, np.float32)), ((gyro, dt, rposes), bg)):
        args = _rotation_problem(g, h, P)
        r, J = timu._rotation_residuals_and_jac(torch.from_numpy(b),
                                                *(torch.from_numpy(x) for x in args))
        assert torch.isfinite(J).all()
        jargs = [jnp.asarray(x) for x in args]
        # the residuals compare two products of 100 rotations: preintegrate's bar
        assert_close(r, jimu._rotation_residuals(jnp.asarray(b), *jargs), atol=1e-6)
        assert_close(J, jax.jacrev(jimu._rotation_residuals, argnums=0)(jnp.asarray(b), *jargs),
                     rel=1e-5)
    bg = timu.estimate_gyro_bias(poses, zero_log[0], zero_log[1], device="cpu")
    assert np.isfinite(bg).all() and np.abs(bg).max() < 0.01


def test_bias_jacobians_match_jax(scene4):
    """On tests/test_vi_ba.py's log (4 keyframes) and on an exactly zero
    gyro log, where the Jacobians must stay finite."""
    sc = scene4
    for gyro in (sc["gyro"], np.zeros_like(sc["gyro"])):
        got = timu.preintegrate_with_bias_jacobians(gyro, sc["accel"], sc["dt"], device="cpu")
        want = jimu.preintegrate_with_bias_jacobians(gyro, sc["accel"], sc["dt"])
        assert_deltas_match_jax(got[:3], want[:3])
        assert got[3].shape == (3, 5, 3, 3) and torch.isfinite(got[3]).all()
        assert_close(got[3], want[3], rel=1e-5)


def test_bias_jacobians_match_finite_differences(scene4):
    """tests/test_vi_ba_bias_states.py: the Jacobians equal central
    differences of the preintegration (rotation in the Exp-correction
    chart)."""
    sc = scene4

    def pre(gyro, accel):
        return [x.numpy() for x in timu.preintegrate(gyro, accel, sc["dt"], device="cpu")]

    dR0, dv0, dp0, J = (x.numpy() for x in timu.preintegrate_with_bias_jacobians(
        sc["gyro"], sc["accel"], sc["dt"], device="cpu"))
    dR_p, dv_p, _ = pre(sc["gyro"], sc["accel"])
    np.testing.assert_allclose(dR0, dR_p, atol=1e-6)
    np.testing.assert_allclose(dv0, dv_p, atol=1e-6)
    eps_g, eps_a = 3e-3, 1e-2
    tol = dict(atol=5e-3, rtol=5e-3)

    def log_rel(dR):
        return timu._log_so3(torch.from_numpy(np.einsum("kji,kjl->kil", dR0, dR))).numpy()

    for axis in range(3):
        dbg = np.zeros(3)
        dbg[axis] = eps_g
        dRp, dvp, dpp = pre(sc["gyro"] - dbg, sc["accel"])  # b enters as (measurement - b)
        dRm, dvm, dpm = pre(sc["gyro"] + dbg, sc["accel"])
        np.testing.assert_allclose(J[:, 0, :, axis], (log_rel(dRp) - log_rel(dRm)) / (2 * eps_g),
                                   **tol)
        np.testing.assert_allclose(J[:, 1, :, axis], (dvp - dvm) / (2 * eps_g), **tol)
        np.testing.assert_allclose(J[:, 3, :, axis], (dpp - dpm) / (2 * eps_g), **tol)
        dba = np.zeros(3)
        dba[axis] = eps_a
        _, dva, dpa = pre(sc["gyro"], sc["accel"] - dba)
        np.testing.assert_allclose(J[:, 2, :, axis], (dva - dv0) / eps_a, **tol)
        np.testing.assert_allclose(J[:, 4, :, axis], (dpa - dp0) / eps_a, **tol)


# ---------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_preintegrate_on_card_matches_cpu(cuda_device):
    """Host arrays go to the card by default; the card within the JAX
    tolerances of the CPU on a padded log of 7 intervals of 100 samples,
    the bias Jacobians too."""
    rng = np.random.RandomState(5)
    gyro, accel = rng.randn(7, 100, 3) * 0.8, rng.randn(7, 100, 3) + G_W
    dt = rng.uniform(0.004, 0.006, (7, 100))
    ok = np.ones((7, 100), bool)
    ok[3, 60:] = False
    card = timu.preintegrate(gyro, accel, dt, ok)
    assert card[0].device.type == "cuda"
    assert_deltas_match_jax([x.cpu() for x in card],
                            timu.preintegrate(gyro, accel, dt, ok, device="cpu"))
    card = timu.preintegrate_with_bias_jacobians(gyro, accel, dt, ok)
    cpu = timu.preintegrate_with_bias_jacobians(gyro, accel, dt, ok, device="cpu")
    assert_close(card[3], cpu[3], rel=1e-5)
