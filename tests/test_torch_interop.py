"""The port's evaluation formats (optical_flow_tpu_torch/utils/interop.py)
against the JAX package's (optical_flow_tpu/utils/interop.py) on identical
numpy inputs made from a seed, and the port's ``slam`` subcommand
(``python -m optical_flow_tpu_torch slam``) on raw ``pipe:`` frames with
``--device cpu``. Tolerances:

  .flo, KITTI PNG, TUM files          byte-equal files, equal arrays read back
  rotation_to_quaternion, ATE, RPE,   equal (the same float64 numpy)
  timestamp association
  the slam CLI                        exits 0, prints the JAX CLI's lines;
                                      --out-tum reads back through
                                      load_tum_trajectory; --eval-tum's ATE
                                      (Sim3 monocular, SE3 stereo) < 0.02
                                      (loop radius 0.12); with --imu the METRIC
                                      lines, a saved trajectory within 0.05 of
                                      the truth with no scale fit, ATE(se3) <
                                      0.05; a log missing gyro exits with the
                                      JAX CLI's message
"""

import numpy as np
import pytest

from optical_flow_tpu.utils import interop as ji
from optical_flow_tpu_torch.utils import interop as ti
from test_torch_incremental import render_loop
from test_torch_stereo import one_thread, stereo_loop  # noqa: F401 (one_thread: a fixture)


def _rotations(n, seed=0):
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    Rs = list(Rotation.random(n, random_state=rng).as_matrix())
    # the branches of Shepperd's method: near 180 degrees about each axis
    for axis in np.eye(3):
        Rs.append(Rotation.from_rotvec(axis * (np.pi - 1e-4)).as_matrix())
    Rs.append(np.eye(3))
    return np.stack(Rs)


def test_flo_files_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    u, v = (rng.randn(2, 7, 9) * 5).astype(np.float32)
    ti.save_flo(tmp_path / "t.flo", u, v)
    ji.save_flo(tmp_path / "j.flo", u, v)
    assert (tmp_path / "t.flo").read_bytes() == (tmp_path / "j.flo").read_bytes()
    for got, want in zip(ti.load_flo(tmp_path / "j.flo"), ji.load_flo(tmp_path / "t.flo")):
        np.testing.assert_array_equal(got, want)
    (tmp_path / "bad.flo").write_bytes(b"\0" * 16)
    with pytest.raises(ValueError):
        ti.load_flo(tmp_path / "bad.flo")


def test_kitti_flow_files_match_jax(tmp_path):
    pytest.importorskip("cv2")
    rng = np.random.RandomState(2)
    u, v = rng.randn(2, 6, 8) * 20
    valid = rng.rand(6, 8) > 0.3
    ti.save_kitti_flow(tmp_path / "t.png", u, v, valid)
    ji.save_kitti_flow(tmp_path / "j.png", u, v, valid)
    for got, want in zip(ti.load_kitti_flow(tmp_path / "t.png"), ji.load_kitti_flow(tmp_path / "j.png")):
        np.testing.assert_array_equal(got, want)


def test_quaternions_match_jax():
    for R in _rotations(40):
        np.testing.assert_array_equal(ti.rotation_to_quaternion(R), ji.rotation_to_quaternion(R))
        q = ti.rotation_to_quaternion(R)
        np.testing.assert_allclose(ti._quaternion_to_rotation(q), R, atol=1e-9)


def test_tum_trajectories_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    poses = _rotations(12, seed=3)
    trans = rng.randn(len(poses), 3)
    ts = np.arange(len(poses)) / 30.0
    ti.save_tum_trajectory(tmp_path / "t.txt", ts, poses, trans)
    ji.save_tum_trajectory(tmp_path / "j.txt", ts, poses, trans)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    got, want = ti.load_tum_trajectory(tmp_path / "t.txt"), ji.load_tum_trajectory(tmp_path / "t.txt")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[1], poses, atol=1e-5)  # 6 decimals in the file
    (tmp_path / "empty.txt").write_text("# nothing\n")
    with pytest.raises(ValueError):
        ti.load_tum_trajectory(tmp_path / "empty.txt")


def test_association_and_errors_match_jax():
    rng = np.random.RandomState(4)
    ta = np.sort(rng.uniform(0, 10, 40))
    tb = np.sort(np.concatenate([ta[::2] + rng.uniform(-0.01, 0.01, 20), rng.uniform(0, 10, 15)]))
    for max_diff in (0.005, 0.02):
        for got, want in zip(ti.associate_by_timestamp(ta, tb, max_diff),
                             ji.associate_by_timestamp(ta, tb, max_diff)):
            np.testing.assert_array_equal(got, want)
    est = rng.randn(25, 3)
    ref = 0.4 * est @ _rotations(1, seed=5)[0].T + 1.0 + rng.randn(25, 3) * 0.01
    for align in ("sim3", "se3", "none"):
        got, want = ti.ate_rmse(est, ref, align=align), ji.ate_rmse(est, ref, align=align)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
    Pe, Pr = _rotations(10, seed=6), _rotations(10, seed=7)
    Te, Tr = rng.randn(len(Pe), 3), rng.randn(len(Pr), 3)
    for delta in (1, 3):
        assert ti.rpe_stats(Pe, Te, Pr, Tr, delta) == ji.rpe_stats(Pe, Te, Pr, Tr, delta)


def _write_pipe(path, grays):
    """Gray frames as raw BGR24 (B = G = R: the port's uint8 bgr_to_gray
    returns the gray level exactly)."""
    np.stack([np.repeat(g[..., None], 3, axis=-1) for g in grays]).tofile(path)


def _truth_tum(path, centers, fps=30.0):
    """A TUM reference of camera centres with R = I (world -> cam t = -c)."""
    ti.save_tum_trajectory(path, np.arange(len(centers)) / fps,
                           np.stack([np.eye(3)] * len(centers)), -np.asarray(centers))


def test_slam_cli_on_pipe_frames(tmp_path, capsys):
    from optical_flow_tpu_torch.__main__ import main

    frames, centers = render_loop(n_frames=8)
    h, w = frames[0].shape
    _write_pipe(tmp_path / "loop.raw", frames)
    _truth_tum(tmp_path / "ref.txt", centers)
    tum, npz = tmp_path / "est.txt", tmp_path / "map.npz"
    assert main(["slam", "--input", f"pipe:{w}x{h}:{tmp_path / 'loop.raw'}", "--frames", "8",
                 "--focal", "400", "--kf-disparity", "0", "--device", "cpu",
                 "--out", str(npz), "--out-tum", str(tum),
                 "--eval-tum", str(tmp_path / "ref.txt")]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("keyframes ") and "(last frame 7) map points " in out[0]
    assert "BA rmse" in out[0] and "loop edges" in out[0]
    n_kf = int(out[0].split()[1])
    assert [line.split(":")[0] for line in out[1:1 + n_kf]] == [
        f"  kf {i} (frame {k})" for i, k in enumerate(np.load(npz)["keyframes"])]
    ts, poses, trans = ti.load_tum_trajectory(tum)
    assert len(ts) == n_kf and np.isfinite(poses).all() and np.isfinite(trans).all()
    ate = [line for line in out if line.startswith("eval vs ")]
    assert len(ate) == 1 and "ATE(sim3)" in ate[0]
    assert float(ate[0].split("rmse ")[1].split()[0]) < 0.02, ate[0]


def test_slam_cli_stereo_sbs(tmp_path, capsys):
    from optical_flow_tpu_torch.__main__ import main

    pairs, centers = stereo_loop(n_frames=6, baseline=0.3)
    h, w = pairs[0][0].shape
    _write_pipe(tmp_path / "sbs.raw", [np.concatenate(p, axis=1) for p in pairs])
    _truth_tum(tmp_path / "ref.txt", centers)
    assert main(["slam", "--input", f"pipe:{2 * w}x{h}:{tmp_path / 'sbs.raw'}", "--frames", "6",
                 "--stereo-sbs", "0.3", "--focal", "400", "--kf-disparity", "0",
                 "--device", "cpu", "--eval-tum", str(tmp_path / "ref.txt")]) == 0
    out = capsys.readouterr().out
    ate = [line for line in out.splitlines() if line.startswith("eval vs ")]
    assert "(last frame 5)" in out and len(ate) == 1 and "ATE(se3)" in ate[0]
    assert float(ate[0].split("rmse ")[1].split()[0]) < 0.02, ate[0]


G_W = np.asarray([0.0, -9.81, 0.0])


def _loop_imu_log(path, period):
    """tests/test_vi_ba.py::test_cli_slam_with_imu's log: 200 Hz over one
    loop, zero gyro (R = I), accel a - g."""
    om = 2 * np.pi / period
    t = np.arange(0.0, period, 1.0 / 200.0)
    acc = np.stack([-0.12 * om * om * np.sin(om * t), 0.08 * om * om * np.cos(om * t),
                    np.zeros_like(t)], -1)
    np.savez(path, t=t, gyro=np.zeros((len(t), 3)), accel=acc - G_W)


def test_slam_cli_with_imu(tmp_path, capsys):
    """tests/test_vi_ba.py::test_cli_slam_with_imu on raw pipe: frames: the
    METRIC lines, the saved trajectory metric with no scale fit (mean error
    < 0.05, loop radius 0.12), and --eval-tum aligned in SE(3)."""
    from optical_flow_tpu_torch.__main__ import main

    n, period = 8, 6.0  # the JAX test's loop and log, 8 frames (as the test above) for time
    frames, centers = render_loop(n_frames=n)
    h, w = frames[0].shape
    _write_pipe(tmp_path / "loop.raw", frames)
    _loop_imu_log(tmp_path / "imu.npz", period)
    fps = n / period
    _truth_tum(tmp_path / "ref.txt", centers, fps=fps)
    npz = tmp_path / "traj.npz"
    assert main(["slam", "--input", f"pipe:{w}x{h}:{tmp_path / 'loop.raw'}", "--frames", str(n),
                 "--focal", "400", "--kf-disparity", "0", "--imu", str(tmp_path / "imu.npz"),
                 "--video-fps", str(fps), "--no-accel-bias", "--out", str(npz), "--device", "cpu",
                 "--eval-tum", str(tmp_path / "ref.txt")]) == 0
    out = capsys.readouterr().out.splitlines()
    got = np.load(npz)
    n_kf = len(got["keyframes"])
    vi = [i for i, line in enumerate(out) if line.startswith("VI refinement: scale ")]
    assert len(vi) == 1 and "gyro bias" in out[vi[0]] and "gravity" in out[vi[0]]
    assert [line.split(":")[0] for line in out[vi[0] + 1:vi[0] + 1 + n_kf]] == [
        f"  kf {i} (frame {k})" for i, k in enumerate(got["keyframes"])]
    assert all("METRIC center" in line for line in out[vi[0] + 1:vi[0] + 1 + n_kf])
    est = np.stack([-R.T @ t for R, t in zip(got["poses"], got["trans"])])
    true = np.asarray([centers[i] for i in got["keyframes"]])
    assert np.linalg.norm(est - true, axis=1).mean() < 0.05  # metric, no fit
    ate = [line for line in out if line.startswith("eval vs ")]
    assert len(ate) == 1 and "ATE(se3)" in ate[0]
    assert float(ate[0].split("rmse ")[1].split()[0]) < 0.05, ate[0]


def test_slam_cli_imu_log_missing_gyro(tmp_path):
    """A log without gyro exits with the JAX CLI's message (before any frame
    is read)."""
    from optical_flow_tpu_torch.__main__ import main

    np.savez(tmp_path / "imu.npz", t=np.arange(4.0), accel=np.zeros((4, 3)))
    with pytest.raises(SystemExit) as e:
        main(["slam", "--input", f"pipe:8x8:{tmp_path / 'none.raw'}", "--imu",
              str(tmp_path / "imu.npz"), "--device", "cpu"])
    assert str(e.value.code).startswith("--imu log missing array 'gyro")
    assert str(e.value.code).endswith("(need t, gyro, accel)")
