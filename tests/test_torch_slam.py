"""The port's bundle adjustment and windowed mapper
(optical_flow_tpu_torch/slam/ba.py, window.py) against the JAX package's, on
identical numpy inputs made from a seed, on the CPU (the port's tensors on
the CPU; JAX with x64, as tests/conftest.py sets it). Tolerances:

  bundle_adjust, float64 (the scenes of        cameras, points and
  tests/test_slam.py: clean, noisy, robust     reprojection_rmse <= 1e-9;
  with outliers, rig baselines with weights,   the per-iteration history
  fixed_cams)                                  <= 1e-9 relative
  bundle_adjust, float32 (rig, fixed_cams:    <= 1e-4 relative to the largest
  problems whose gauge is fixed)
  _residual_jac against jax.jacfwd             <= 1e-12 (float64; entries up
  (r = 0 and r != 0)                           to ~600)
  _schur_reduce, _solve_cameras (fixed_dofs,   <= 1e-9 relative
  precondition)
  WindowedBA, 14-keyframe trajectory           retired sets and live sizes
                                               equal; poses and points <= 1e-9
                                               (monocular: after one global
                                               scale, see the test)

  sharded_bundle_adjust, float64, on JAX's    cameras, points, history <= 1e-6
  flow_mesh(2, 2, 2) and the port's           against JAX's sharded solve (its
  flow_mesh(2, 2, 2, devices=["cpu"] * 8):    own bar, tests/test_slam.py:221-258);
  plain, Huber, rig with weights              <= 1e-9 against the port's
                                              unsharded solve

The tests marked ``cuda`` hold the card against the CPU and skip where
there is no card.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from optical_flow_tpu.slam import ba as j_ba
from optical_flow_tpu.slam import epipolar as j_epi
from optical_flow_tpu.slam import window as j_win
from optical_flow_tpu.parallel import flow_mesh as j_flow_mesh
from optical_flow_tpu_torch import convert
from optical_flow_tpu_torch.parallel import flow_mesh
from optical_flow_tpu_torch.slam import ba as t_ba
from optical_flow_tpu_torch.slam import window as t_win

FOCAL = 500.0


def _jproject(cams, pts, ci, pi, baseline=None):
    b = np.zeros(len(ci)) if baseline is None else baseline
    return np.asarray(jax.vmap(j_ba.project, in_axes=(0, 0, None, 0))(
        jnp.asarray(cams)[ci], jnp.asarray(pts)[pi], FOCAL, jnp.asarray(b)))


def _scene(C=4, P=32, noise=0.0, seed=0):
    """tests/test_slam.py's scene: P points 8 units ahead, C cameras along x
    with tiny rotations, every point seen by every camera (float64)."""
    rng = np.random.RandomState(seed)
    pts = rng.randn(P, 3) * np.array([2.0, 2.0, 0.5]) + np.array([0, 0, 8.0])
    cams = np.zeros((C, 6))
    cams[:, 3] = np.linspace(-1, 1, C)
    cams[:, :3] = rng.randn(C, 3) * 0.02
    ci = np.repeat(np.arange(C), P).astype(np.int32)
    pi = np.tile(np.arange(P), C).astype(np.int32)
    obs = _jproject(cams, pts, ci, pi) + rng.randn(C * P, 2) * noise
    return cams, pts, ci, pi, obs, rng


def _problem(case):
    """(numpy fields of a BAProblem, bundle_adjust keywords) for a case."""
    if case == "clean":
        cams, pts, ci, pi, obs, _ = _scene()
        rng = np.random.RandomState(7)
        cams_n = cams + rng.randn(*cams.shape) * 0.01
        cams_n[0] = cams[0]
        return (cams_n, pts + rng.randn(*pts.shape) * 0.05, ci, pi, obs, None, None), dict(
            iters=12, lam=1e-4)
    if case == "noisy":
        cams, pts, ci, pi, obs, _ = _scene(noise=0.5, seed=2)
        rng = np.random.RandomState(8)
        return (cams + rng.randn(*cams.shape) * 0.005, pts + rng.randn(*pts.shape) * 0.03,
                ci, pi, obs, None, None), dict(iters=10, lam=1e-3)
    if case == "robust":
        cams, pts, ci, pi, obs, _ = _scene(C=5, P=40, noise=0.2, seed=11)
        rng = np.random.RandomState(3)
        bad = rng.rand(len(obs)) < 0.08
        obs = obs.copy()
        obs[bad] += rng.uniform(30, 60, (int(bad.sum()), 2)) * np.sign(rng.randn(int(bad.sum()), 2))
        return (cams + rng.randn(5, 6) * 0.01, pts + rng.randn(40, 3) * 0.05, ci, pi, obs, None,
                None), dict(iters=8, lam=1e-3, robust_delta=2.0)
    if case == "rig":
        # every observation also made by a right eye 0.3 along +x, with
        # per-observation weights, and a few zero-weight rows
        cams, pts, ci, pi, obs, rng = _scene(C=3, P=24, noise=0.1, seed=4)
        M = len(ci)
        b = np.concatenate([np.zeros(M), np.full(M, 0.3)])
        ci2, pi2 = np.concatenate([ci, ci]), np.concatenate([pi, pi])
        obs2 = np.concatenate([obs, _jproject(cams, pts, ci, pi, np.full(M, 0.3))])
        w = rng.uniform(0.5, 1.5, 2 * M)
        w[::17] = 0.0
        return (cams + rng.randn(3, 6) * 0.01, pts + rng.randn(24, 3) * 0.05, ci2, pi2, obs2, w,
                b), dict(iters=6, lam=1e-3)
    if case == "fixed_cams":
        cams, pts, ci, pi, obs, rng = _scene(C=5, P=30, noise=0.2, seed=6)
        return (cams + rng.randn(5, 6) * 0.01, pts + rng.randn(30, 3) * 0.05, ci, pi, obs, None,
                None), dict(iters=6, lam=1e-3, fixed_cams=np.array([False, False, True, False, True]))
    raise ValueError(case)


def _both(fields, dtype=np.float64):
    cams, pts, ci, pi, obs, w, b = fields
    f = lambda x: None if x is None else np.asarray(x, dtype)  # noqa: E731
    jp = j_ba.BAProblem(jnp.asarray(f(cams)), jnp.asarray(f(pts)), jnp.asarray(ci),
                        jnp.asarray(pi), jnp.asarray(f(obs)), FOCAL,
                        None if w is None else jnp.asarray(f(w)),
                        None if b is None else jnp.asarray(f(b)))
    return jp, convert.ba_problem_from_jax(jp)


@pytest.mark.parametrize("case", ["clean", "noisy", "robust", "rig", "fixed_cams"])
def test_bundle_adjust_matches_jax_f64(case):
    fields, kw = _problem(case)
    jp, tp = _both(fields)
    jr, jh = j_ba.bundle_adjust(jp, **kw)
    tr, th = t_ba.bundle_adjust(tp, **kw)
    assert tr.cams.dtype == torch.float64 and tr.cams.device == torch.device("cpu")
    assert np.abs(tr.cams.numpy() - np.asarray(jr.cams)).max() <= 1e-9
    assert np.abs(tr.points.numpy() - np.asarray(jr.points)).max() <= 1e-9
    jh = np.asarray(jh)
    assert th.shape == jh.shape and np.abs(th.numpy() - jh).max() <= 1e-9 * jh.max()
    j_rmse = float(j_ba.reprojection_rmse(jr))
    assert abs(float(t_ba.reprojection_rmse(tr)) - j_rmse) <= 1e-9
    assert float(t_ba.reprojection_rmse(tr)) < float(t_ba.reprojection_rmse(tp))
    if "fixed_cams" in kw:  # pinned cameras do not move
        pinned = kw["fixed_cams"] | (np.arange(5) == 0)
        assert torch.equal(tr.cams[pinned], tp.cams[pinned])


@pytest.mark.parametrize("case", ["rig", "fixed_cams"])
def test_bundle_adjust_matches_jax_f32(case):
    """In float32 only a problem whose gauge is fixed has one answer to hold
    the port to. With camera 0 pinned alone, the scale is a gauge that the
    damping barely holds, and roundoff picks it: observations changed by one
    ulp (x (1 + 2^-23)) move JAX's own float32 cameras by 8.1% (clean), 0.03%
    (noisy) and 1.5% (robust) of their largest. The rig observes the scale
    and fixed_cams pins three cameras: there JAX moves by <= 7e-7 and the
    port is held to 1e-4 (observed 1.6e-6 and 7.4e-7)."""
    fields, kw = _problem(case)
    jp, tp = _both(fields, np.float32)
    jr, _ = j_ba.bundle_adjust(jp, **kw)
    tr, th = t_ba.bundle_adjust(tp, **kw)
    assert tr.points.dtype == torch.float32 and th.dtype == torch.float32
    for a, b in ((tr.cams, jr.cams), (tr.points, jr.points)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max()


@pytest.fixture
def one_thread():
    """One intra-op thread for the shards' many small ops, so they do not
    spin against the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _by_shard(fields, n):
    """A problem's observations grouped by owning shard, pt_idx local to it
    (tests/test_slam.py's sharded layout)."""
    cams, pts, ci, pi, obs, w, b = fields
    order = np.argsort(pi, kind="stable")
    sel = lambda x: None if x is None else x[order]  # noqa: E731
    return cams, pts, ci[order], pi[order] % (len(pts) // n), obs[order], sel(w), sel(b)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("case", ["clean", "robust", "rig"])
def test_sharded_bundle_adjust_matches_jax(case):
    fields, kw = _problem(case)
    kw["iters"] = 4  # 8 shards of tiny problems: launch-bound on the CPU
    jp, tp = _both(_by_shard(fields, 8))
    jr, jh = j_ba.sharded_bundle_adjust(jp, j_flow_mesh(2, 2, 2), **kw)
    tr, th = t_ba.sharded_bundle_adjust(tp, flow_mesh(2, 2, 2, devices=["cpu"] * 8), **kw)
    assert tr.cams.dtype == torch.float64 and tr.points.shape == tp.points.shape
    jh = np.asarray(jh)
    assert np.abs(tr.cams.numpy() - np.asarray(jr.cams)).max() <= 1e-6
    assert np.abs(tr.points.numpy() - np.asarray(jr.points)).max() <= 1e-6
    assert th.shape == jh.shape and np.abs(th.numpy() - jh).max() <= 1e-6 * jh.max()
    # the port's sharded solve against its unsharded one (global indices)
    ur, uh = t_ba.bundle_adjust(_both(fields)[1], **kw)
    assert float((tr.cams - ur.cams).abs().max()) <= 1e-9
    assert float((tr.points - ur.points).abs().max()) <= 1e-9
    assert tr.weight is tp.weight or torch.equal(tr.weight, tp.weight)


def test_sharded_bundle_adjust_raises_as_jax():
    fields, _ = _problem("clean")  # 32 points, 128 observations
    jp, tp = _both(fields)
    jp, tp = (p._replace(points=p.points[:30]) for p in (jp, tp))
    with pytest.raises(ValueError) as jerr:
        j_ba.sharded_bundle_adjust(jp, j_flow_mesh(2, 2, 2))
    with pytest.raises(ValueError) as terr:
        t_ba.sharded_bundle_adjust(tp, flow_mesh(2, 2, 2, devices=["cpu"] * 8))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("cam", ["zero", "rotated", "rig"])
def test_residual_jac_matches_jacfwd(cam):
    """Camera 0 sits at r = 0, the small-angle branch of _rodrigues."""
    rng = np.random.RandomState(1)
    c = np.zeros(6) if cam == "zero" else np.concatenate([rng.randn(3) * 0.05, rng.randn(3)])
    X = np.array([0.4, -0.3, 7.5])
    uv = rng.randn(2) * 10
    b = 0.3 if cam == "rig" else 0.0
    jr, jc, jpt = j_ba._residual_jac(jnp.asarray(c), jnp.asarray(X), jnp.asarray(uv), FOCAL, b)
    tr, tc, tpt = t_ba._residual_jac(torch.from_numpy(c), torch.from_numpy(X), torch.from_numpy(uv),
                                     torch.tensor(FOCAL, dtype=torch.float64),
                                     torch.tensor(b, dtype=torch.float64))
    for got, want in ((tr, jr), (tc, jc), (tpt, jpt)):
        assert got.shape == np.asarray(want).shape
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-12


@pytest.mark.parametrize("solve", ["default", "precondition", "fixed_dofs"])
def test_schur_reduce_and_solve_match_jax(solve):
    fields, _ = _problem("rig")
    jp, tp = _both(fields)
    C, P = tp.cams.shape[0], tp.points.shape[0]
    table = t_ba.build_track_table(tp.pt_idx, P, valid=tp.weight.numpy() > 0)
    jout = j_ba._assemble(jp, C, P, jnp.asarray(table))
    tout = t_ba._assemble(tp, C, P, torch.from_numpy(table))
    for got, want in zip(tout, jout):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-9 * max(np.abs(want).max(), 1.0)
    Hcc, Hpp, bc, bp, Wp, camT, _ = jout
    lam = 1e-3
    jS, jrhs, jV = j_ba._schur_reduce(Hpp, bp, Wp, camT, lam, C)
    tS, trhs, tV = t_ba._schur_reduce(*(torch.from_numpy(np.asarray(x)) for x in (Hpp, bp, Wp, camT)),
                                      torch.tensor(lam, dtype=torch.float64), C)
    for got, want in ((tS, jS), (trhs, jrhs), (tV, jV)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-9 * np.abs(want).max()
    kw = {"default": {}, "precondition": dict(precondition=True),
          "fixed_dofs": dict(fixed_dofs=(np.arange(C * 6) < 6) | (np.arange(C * 6) % 5 == 4))}[solve]
    jd = np.asarray(j_ba._solve_cameras(Hcc, bc, jS, jrhs, lam,
                                        **{k: jnp.asarray(v) if k == "fixed_dofs" else v
                                           for k, v in kw.items()}))
    td = t_ba._solve_cameras(torch.from_numpy(np.asarray(Hcc)), torch.from_numpy(np.asarray(bc)),
                             torch.from_numpy(np.asarray(jS)), torch.from_numpy(np.asarray(jrhs)),
                             torch.tensor(lam, dtype=torch.float64),
                             **{k: torch.from_numpy(v) if k == "fixed_dofs" else v
                                for k, v in kw.items()})
    assert np.abs(td.numpy() - jd).max() <= 1e-9 * np.abs(jd).max()
    if solve == "fixed_dofs":
        assert bool((td.reshape(-1)[torch.from_numpy(kw["fixed_dofs"])] == 0).all())
    jpts = np.asarray(j_ba._back_substitute(jV, Wp, camT, bp, jnp.asarray(jd)))
    tpts = t_ba._back_substitute(tV, torch.from_numpy(np.asarray(Wp)), torch.from_numpy(np.asarray(camT)),
                                 torch.from_numpy(np.asarray(bp)), torch.from_numpy(jd))
    assert np.abs(tpts.numpy() - jpts).max() <= 1e-9 * np.abs(jpts).max()


def test_build_track_table_matches_jax():
    rng = np.random.RandomState(2)
    pt = rng.randint(0, 40, 300).astype(np.int32)
    valid = rng.rand(300) > 0.2
    for kw in (dict(), dict(valid=valid), dict(K=30, valid=valid)):
        np.testing.assert_array_equal(t_ba.build_track_table(torch.from_numpy(pt), 45, **kw),
                                      j_ba.build_track_table(pt, 45, **kw))
    with pytest.raises(ValueError, match="exceeds table width"):
        t_ba.build_track_table(pt, 45, K=2)


# ------------------------------------------------------------ WindowedBA


def _trajectory(wba, proj, stereo=False):
    """tests/test_slam.py's 14-keyframe trajectory: 12 new points a
    keyframe, each seen by the next 4 keyframes; optionally each observation
    also by a right eye 0.3 along +x. Returns (wba, live sizes, rmses,
    (true poses, true points, keyframes that saw each point))."""
    rng = np.random.RandomState(5)
    n_kf = 14
    true_poses = np.zeros((n_kf, 6))
    true_poses[:, 3] = np.arange(n_kf) * 0.4
    pts_true, visible, pid = {}, {}, 0
    for k in range(n_kf):
        for _ in range(12):
            pts_true[pid] = np.array([true_poses[k, 3] + rng.uniform(-2, 2), rng.uniform(-2, 2),
                                      rng.uniform(6, 10)])
            for kk in range(k, min(k + 4, n_kf)):
                visible.setdefault(kk, []).append(pid)
            pid += 1
    sizes, rmses, seen = [], [], {}
    for k in range(n_kf):
        pose_init = true_poses[k] + rng.randn(6) * np.array([0.002] * 3 + [0.02] * 3)
        if k == 0:
            pose_init = true_poses[0]  # gauge anchor
        obs, new_pts = [], {}
        for p in visible[k]:
            uv = proj(true_poses[k], pts_true[p], 0.0)
            if abs(uv[0]) > 800 or abs(uv[1]) > 800:
                continue
            obs.append((p, uv))
            seen[p] = seen.get(p, 0) + 1
            if stereo:
                obs.append((p, proj(true_poses[k], pts_true[p], 0.3), 0.3))
            if p not in wba.points and p not in wba.retired:
                new_pts[p] = pts_true[p] + rng.randn(3) * 0.02
        wba.add_keyframe(pose_init, obs, new_pts)
        rmses.append(wba.optimize())
        sizes.append(wba.live_observation_count)
    return wba, sizes, rmses, (true_poses, pts_true, seen)


def _jproj(pose, X, b):
    """The pinhole projection of slam/ba.py's ``project`` in numpy (the
    observations are data, fed alike to both packages)."""
    r = pose[:3]
    th = np.linalg.norm(r)
    K = np.array([[0.0, -r[2], r[1]], [r[2], 0.0, -r[0]], [-r[1], r[0], 0.0]]) / max(th, 1e-12)
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K) if th > 1e-6 else np.eye(3) + K * th
    xc = R @ X + pose[3:]
    return FOCAL * np.array([xc[0] - b, xc[1]]) / xc[2]


@pytest.fixture(scope="module")
def windowed():
    kw = dict(window=4, focal=FOCAL, ba_iters=4, lam=1e-6)
    return {stereo: (_trajectory(j_win.WindowedBA(**kw), _jproj, stereo),
                     _trajectory(t_win.WindowedBA(**kw, device="cpu"), _jproj, stereo))
            for stereo in (False, True)}


@pytest.mark.parametrize("stereo", [False, True], ids=["monocular", "stereo"])
def test_windowed_ba_matches_jax(windowed, stereo):
    """The same trajectory through both mappers. With one eye the scale is a
    gauge of the first window (one camera pinned, damping lam = 1e-6 along
    it), and JAX's W inv(V) W^T lets roundoff pick it: observations
    perturbed by 1e-15 relative move JAX's own x-translations by 2e-4
    relative (the port forms it in the eigenbasis, ``ba._schur_reduce``,
    and moves by 1e-9: test_windowed_ba_is_stable_under_roundoff). So the
    monocular poses are held to JAX's after one global scale, and so are
    the points seen by two keyframes or more; a point seen once has a free
    depth of its own along its ray, which JAX's roundoff picks in the same
    way, so it is not held; a point never seen keeps its initial value on
    both sides. With the right eye the scale and every depth are observed
    and everything is held raw (observed 4e-15 poses, 1e-13 points)."""
    (jw, jsizes, jrmse, (true_poses, _, seen)), (tw, tsizes, trmse, _) = windowed[stereo]
    assert tsizes == jsizes
    assert sorted(tw.retired) == sorted(jw.retired) and len(tw.retired) > 50
    assert np.abs(np.array(trmse) - np.array(jrmse)).max() <= 1e-9
    s = 1.0 if stereo else tw.poses[-1][3] / jw.poses[-1][3]
    if not stereo:
        assert abs(s - 1.0) < 0.05
    assert max(np.abs(a * s - b).max() for a, b in zip(jw.poses, tw.poses)) <= 1e-9
    jp, tp = jw.all_points(), tw.all_points()
    assert sorted(jp) == sorted(tp)
    held = [p for p in jp if stereo or seen.get(p, 0) != 1]
    assert len(held) >= len(jp) - 12
    for p in held:
        want = jp[p] * s if seen.get(p, 0) else jp[p]
        assert np.abs(tp[p] - want).max() <= 1e-9, p
    # the bars of tests/test_slam.py on the port's own run
    assert max(tsizes) <= 12 * 4 * 7 * (2 if stereo else 1)
    assert tsizes[-1] <= max(tsizes[:-1])
    err = np.array([abs(tw.poses[k][3] - true_poses[k, 3]) for k in range(14)])
    assert err.max() < 0.02 * true_poses[-1, 3]


def test_windowed_ba_is_stable_under_roundoff():
    """The monocular trajectory again, every observation scaled by
    (1 + k 1e-15): the port's poses move by <= 1e-6 (observed about 1e-9;
    the last pose 0.0023 off the truth every time). JAX's, built with
    W inv(V) W^T, land from 0.003 to 0.57 off the truth under the same
    changes (this test's inputs through JAX's mapper), against the bar of
    0.104 (tests/test_slam.py:212)."""
    kw = dict(window=4, focal=FOCAL, ba_iters=4, lam=1e-6, device="cpu")
    runs = []
    for k in (0, 2, 5):
        proj = lambda pose, X, b, k=k: _jproj(pose, X, b) * (1 + k * 1e-15)  # noqa: E731
        tw, _, _, (true_poses, _, _) = _trajectory(t_win.WindowedBA(**kw), proj)
        runs.append(np.stack(tw.poses))
    assert max(np.abs(r - runs[0]).max() for r in runs) <= 1e-6
    assert np.abs(runs[0][:, 3] - true_poses[:, 3]).max() < 0.01


def test_windowed_ba_bookkeeping_matches_jax():
    """add_observation from an earlier keyframe, an observation-less point
    aging out, stale observations of retired points, and the errors: the
    same retired, live and observation sets (the poses of this tiny problem
    are not determined; the trajectory test holds the solve)."""
    out = []
    for mod, kw in ((j_win, {}), (t_win, dict(device="cpu"))):
        w = mod.WindowedBA(window=2, focal=FOCAL, **kw)
        w.add_keyframe(np.zeros(6), [(0, (1.0, 2.0))], {0: (0.1, 0.2, 5.0), 1: (0.5, 0.1, 6.0)})
        w.add_observation(0, 0, (1.5, 2.5), baseline=0.3)
        w.add_keyframe(np.array([0, 0, 0, 0.1, 0, 0]), [(0, (0.5, 2.0))], {2: (0.0, 0.0, 7.0)})
        assert w.optimize() is not None
        with pytest.raises(ValueError, match="unknown point"):
            w.add_keyframe(np.zeros(6), [(9, (0.0, 0.0))])
        w.add_keyframe(np.array([0, 0, 0, 0.2, 0, 0]), [(0, (0.2, 2.0))])  # retires 1
        w.add_keyframe(np.array([0, 0, 0, 0.3, 0, 0]), [(1, (0.0, 0.0))])  # stale, skipped
        w.add_observation(1, 0, (0.0, 0.0))  # ignored likewise
        assert 1 in w.retired and w.optimize() is not None
        with pytest.raises(ValueError, match="retired"):
            w.add_keyframe(np.zeros(6), [], {1: (0.0, 0.0, 1.0)})
        out.append((sorted(w.retired), sorted(w.points), w.live_observation_count,
                    len(w.poses), sorted(w._last_seen.items())))
    assert out[1] == out[0]


def test_windowed_ba_pads_to_powers_of_two():
    w = t_win.WindowedBA(window=3, focal=FOCAL, device="cpu")
    w.add_keyframe(np.zeros(6), [(p, (float(p), 1.0)) for p in range(5)],
                   {p: (0.1 * p, 0.0, 6.0) for p in range(5)})
    prob, cam_set, pids, fixed = w._gather_problem()
    assert [t_win._bucket(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]
    assert prob.cams.shape == (1, 6) and prob.points.shape == (8, 3) and prob.obs.shape == (8, 2)
    assert prob.weight.tolist() == [1.0] * 5 + [0.0] * 3 and prob.points[5:, 2].tolist() == [1.0] * 3
    assert prob.cams.device == torch.device("cpu") and prob.cams.dtype == torch.float64


# --------------------------------------------------------------- convert


@pytest.mark.parametrize("default", [True, False])
def test_essential_ransac_config_from_jax(default):
    jcfg = (j_epi.EssentialRansacConfig() if default
            else j_epi.EssentialRansacConfig(n_hypotheses=64, inlier_thresh=1e-3, seed=7))
    got = convert.essential_ransac_config_from_jax(jcfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(jcfg)
    assert ([f.name for f in dataclasses.fields(got)]
            == [f.name for f in dataclasses.fields(j_epi.EssentialRansacConfig)])
    if default:
        assert got == type(got)()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ba_problem_from_jax_round_trip(dtype):
    fields, _ = _problem("rig")
    jp, tp = _both(fields, dtype)
    for name in ("cams", "points", "cam_idx", "pt_idx", "obs", "weight", "baseline"):
        got, want = getattr(tp, name), np.asarray(getattr(jp, name))
        assert got.dtype == getattr(torch, want.dtype.name) and got.device == torch.device("cpu")
        np.testing.assert_array_equal(got.numpy(), want)
    assert tp.focal == jp.focal
    back = j_ba.BAProblem(*(x if isinstance(x, float) or x is None else jnp.asarray(x.numpy())
                            for x in tp))
    assert float(j_ba.reprojection_rmse(back)) == float(j_ba.reprojection_rmse(jp))
    bare = convert.ba_problem_from_jax(jp._replace(weight=None, baseline=None))
    assert bare.weight is None and bare.baseline is None


# ---------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _large_scene(seed=11, C=50, P=10_000):
    """tests/test_slam.py:116-150: 10,000 points, 50 cameras, each point seen
    by 6 consecutive cameras (60,000 observations), float64."""
    rng = np.random.RandomState(seed)
    pts = rng.randn(P, 3) * np.array([4.0, 4.0, 1.0]) + np.array([0, 0, 10.0])
    cams = np.zeros((C, 6))
    cams[:, 3] = np.linspace(-3, 3, C)
    cams[:, :3] = rng.randn(C, 3) * 0.01
    first = rng.randint(0, C - 5, size=P)
    ci = (first[:, None] + np.arange(6)[None, :]).reshape(-1).astype(np.int32)
    pi = np.repeat(np.arange(P), 6).astype(np.int32)
    obs = torch.func.vmap(t_ba.project, in_dims=(0, 0, None))(
        torch.from_numpy(cams)[ci], torch.from_numpy(pts)[pi], torch.tensor(FOCAL, dtype=torch.float64))
    return t_ba.BAProblem(torch.from_numpy(cams + rng.randn(C, 6) * 0.002),
                          torch.from_numpy(pts + rng.randn(P, 3) * 0.02),
                          torch.from_numpy(ci), torch.from_numpy(pi), obs, FOCAL)


@pytest.mark.cuda
def test_bundle_adjust_at_scale_on_card_matches_cpu(cuda_device):
    """chip_smoke.py phase 13 (c): card against CPU within 1e-8 relative."""
    prob = _large_scene()
    cpu, _ = t_ba.bundle_adjust(prob, iters=5, lam=1e-4)
    card, _ = t_ba.bundle_adjust(prob, iters=5, lam=1e-4, device=cuda_device)
    assert card.points.device.type == "cuda"
    assert float(t_ba.reprojection_rmse(card)) < 0.1 * float(t_ba.reprojection_rmse(prob))
    for a, b in ((card.cams, cpu.cams), (card.points, cpu.points)):
        assert float((a.cpu() - b).abs().max()) <= 1e-8 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("stereo", [False, True], ids=["monocular", "stereo"])
def test_windowed_ba_on_card(cuda_device, stereo):
    """chip_smoke.py phase 13 (d): the trajectory's bars on the card, and
    its poses within 1e-6 of the CPU's (test_windowed_ba_is_stable_under_roundoff)."""
    runs = []
    for device in (cuda_device, "cpu"):
        tw, sizes, rmses, (true_poses, _, _) = _trajectory(
            t_win.WindowedBA(window=4, focal=FOCAL, ba_iters=4, lam=1e-6, device=device), _jproj,
            stereo)
        assert len(tw.retired) > 50 and sizes[-1] <= max(sizes[:-1]) and all(np.isfinite(rmses))
        runs.append(np.stack(tw.poses))
    err = np.abs(runs[0][:, 3] - true_poses[:, 3])
    assert err.max() < 0.02 * true_poses[-1, 3]
    assert np.abs(runs[0] - runs[1]).max() <= 1e-6


@pytest.mark.cuda
def test_sharded_bundle_adjust_on_card(cuda_device):
    """chip_smoke.py phase 17 (a) at a fifth of its size: the shards of an
    8-slot mesh that repeats the card, against bundle_adjust on the card."""
    prob = _large_scene(C=20, P=2000)
    mesh = flow_mesh(2, 2, 2, devices=[cuda_device] * 8)
    flat, _ = t_ba.bundle_adjust(prob, iters=5, lam=1e-4, device=cuda_device)
    local = prob._replace(pt_idx=prob.pt_idx % (2000 // 8))  # point-major already
    out, hist = t_ba.sharded_bundle_adjust(local, mesh, iters=5, lam=1e-4)
    assert out.points.device.type == "cuda" and hist.shape == (5,)
    assert float(t_ba.reprojection_rmse(out._replace(pt_idx=prob.pt_idx))) < 0.1 * float(
        t_ba.reprojection_rmse(prob))
    for a, b in ((out.cams, flat.cams), (out.points, flat.points)):
        assert float((a - b).abs().max()) <= 1e-8 * float(b.abs().max())
