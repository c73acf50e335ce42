"""The port's example scripts on synthetic scenes (optical_flow_tpu_torch/
examples/: loop_closure, scale_drift, stereo_slam, vi_odometry, sfm_demo,
scaling_report, still_regression), each run in process through its
``main(argv)`` with ``--device cpu`` at small sizes, its printed lines
parsed and held to the JAX package:

  scale_drift       deterministic: the JAX script's printed lines, run in
                    process, line for line (3 decimals; the port's pose
                    graphs solve in float64, JAX's in float32)
  loop_closure      the JAX functions' loop candidates on the same frames
                    (same pairs, distances to the printed 3 decimals); the
                    pose graph at tests/test_pose_graph.py's bars (endpoint
                    error at least halved, mean error lower)
  stereo_slam       tests/test_stereo_slam.py's bars: stereo raw centre
                    error < 0.05 (loop radius 0.12), >= 50 landmarks,
                    median depth in 3-12; the monocular one after its
                    oracle scale fit < 0.05
  vi_odometry       its scene equal to tests/test_vi_ba.py::_make_scene;
                    tests/test_vi_ba.py's refine_with_imu bars (scale
                    within 5%, gyro bias within 2e-3, centre error < 3% of
                    the span, trajectory scale within 0.03 of 1) and
                    tests/test_vi_ba_bias_states.py's (frozen bias error >
                    2x the bias-state error, which is < 3% of the span)
  sfm_demo          tests/test_epipolar.py::test_multi_view_reconstruct's
                    bars on the same scene (rmse falls and stays < 3 px,
                    x translations grow, step ratio < 1.8)
  scaling_report    the batch rows and the JAX package's pyramid depth; the
                    sharded pyramid over 4 CPU slots equal to the unsharded
                    controller bit for bit
  still_regression  the four goldens at the reference's 1e-6 (float64), only
                    where OPTICAL_FLOW_REFERENCE_DIR names a reference
                    checkout (none is in the repository: it skips)
"""

import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FLOAT = r"[-+]?\d+\.\d+"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread keeps the scripts' small ops from spinning
    against the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(module, argv, capsys):
    """The port's example ``module``'s main(argv): (exit code, stdout lines)."""
    import importlib

    mod = importlib.import_module(f"optical_flow_tpu_torch.examples.{module}")
    capsys.readouterr()
    rc = mod.main(argv)
    return rc, capsys.readouterr().out.splitlines()


def _run_jax_script(name, argv, capsys, monkeypatch):
    """The JAX package's examples/<name>.py main() in this process (JAX on
    the CPU, as the suite runs it): its stdout lines."""
    script = runpy.run_path(str(REPO / "examples" / f"{name}.py"), run_name=f"jax_{name}")
    monkeypatch.setattr(sys, "argv", [name, *argv])
    capsys.readouterr()
    script["main"]()
    return capsys.readouterr().out.splitlines()


def _numbers(line):
    return [float(x) for x in re.findall(FLOAT, line)]


def test_scale_drift_prints_the_jax_lines(capsys, monkeypatch):
    rc, got = _run("scale_drift", ["--device", "cpu"], capsys)
    want = _run_jax_script("scale_drift", [], capsys, monkeypatch)
    assert rc == 0 and len(got) == 4
    assert got == want
    # Sim(3) recovers the loop, SE(3) keeps the spiral (the script's claim)
    m3, m7 = _numbers(got[1])[0], _numbers(got[2])[0]
    assert m7 < 0.05 and m3 > 100 * m7


def test_loop_closure_closes_the_loop(capsys):
    from optical_flow_tpu.slam import propose_loop_candidates, thumbnail_descriptor
    from optical_flow_tpu_torch.examples.loop_closure import render_loop_frames

    n = 5  # 4 odometry pairs and the loop edges (0, 4), (0, 3): sparse LK is eager on the CPU
    rc, out = _run("loop_closure", ["--frames", str(n), "--device", "cpu"], capsys)
    assert rc == 0, out
    assert sum(line.startswith("odometry ") for line in out) == n - 1
    frames, _, _ = render_loop_frames(n)
    cands = propose_loop_candidates([thumbnail_descriptor(f) for f in frames],
                                    min_separation=max(3, n - 3))
    line = next(x for x in out if x.startswith("loop candidates:"))
    assert line == "loop candidates: " + str([(i, j, round(d, 3)) for i, j, d in cands[:3]])
    assert any(x.startswith("loop edge ") for x in out)
    end0, end1 = _numbers(next(x for x in out if x.startswith("endpoint error")))
    mean0, mean1 = _numbers(next(x for x in out if x.startswith("mean center error")))
    assert end1 < 0.5 * end0 and mean1 < mean0, (end0, end1, mean0, mean1)


def test_stereo_slam_is_metric(capsys):
    rc, out = _run("stereo_slam", ["--frames", "4", "--device", "cpu"], capsys)
    assert rc == 0, out
    mono = _numbers(next(x for x in out if x.startswith("monocular:")))
    stereo = _numbers(next(x for x in out if x.startswith("stereo:")))
    landmarks, depth = re.search(r"stereo map: (\d+) landmarks, median depth (" + FLOAT + ")",
                                 out[-1]).groups()
    assert mono[-1] < 0.05, mono  # after the oracle scale fit
    assert stereo[0] < 0.05, stereo  # raw: metric, no fit
    assert int(landmarks) >= 50 and 3.0 < float(depth) < 12.0


def _vi_lines(out):
    return {k.strip(): v for k, v in (x.split(":", 1) for x in out if ":" in x)}


def test_vi_odometry_scene_and_bars(capsys):
    """Without visual noise the script runs tests/test_vi_ba.py's
    refine_with_imu case; with the bias walking, test_vi_ba_bias_states.py's."""
    from test_vi_ba import _make_scene

    from optical_flow_tpu_torch.examples.vi_odometry import make_scene

    mine, theirs = make_scene(), _make_scene()
    for key in mine:
        np.testing.assert_array_equal(mine[key], theirs[key], err_msg=key)
    span = np.linalg.norm(mine["centers"], axis=1).max()

    rc, out = _run("vi_odometry", ["--vis-noise", "0", "--device", "cpu"], capsys)
    assert rc == 0, out
    lines = _vi_lines(out)
    assert abs(float(lines["alignment-recovered scale"]) - 3.0) / 3.0 < 0.05
    est_bg = np.array(_numbers(lines["gyro bias  true/est"].split("/")[1]))
    np.testing.assert_allclose(est_bg, [0.01, -0.008, 0.012], atol=2e-3)
    _, joint = _numbers(lines["mean |center err| metric"])
    assert joint < 0.03 * span, (joint, span)
    assert abs(_numbers(lines["final trajectory scale"])[0] - 1.0) < 0.03

    rc, out = _run("vi_odometry", ["--vis-noise", "0", "--bias-drift", "--device", "cpu"], capsys)
    assert rc == 0, out
    lines = _vi_lines(out)
    err_f = _numbers(lines["frozen-bias (9-DOF)  err"])[0]
    err_b = _numbers(lines["bias-state (15-DOF)  err"])[0]
    assert err_f > 2.0 * err_b and err_b < 0.03 * span, (err_f, err_b, span)


def test_sfm_demo_reconstructs(capsys, tmp_path):
    rc, out = _run("sfm_demo", ["--frames", "4", "--out", str(tmp_path), "--device", "cpu"], capsys)
    assert rc == 0, out
    assert re.match(r"4 frames, \d+ map points", out[0])
    before, after = _numbers(out[1])
    assert after <= before + 1e-3 and after < 3.0, (before, after)
    txs = np.array([_numbers(x)[1] for x in out if x.startswith("cam ")])
    txs = txs * np.sign(txs[-1])
    assert len(txs) == 4 and txs[0] == 0.0 and np.all(np.diff(txs) > 0), txs
    steps = np.diff(txs)
    assert steps.max() / max(steps.min(), 1e-9) < 1.8, steps
    assert (tmp_path / "map_topdown.png").exists()


def test_scaling_report_on_cpu_slots(capsys):
    from optical_flow_tpu.ops.pyramid import max_pyramid_levels

    rc, out = _run("scaling_report", ["--size", "64", "--iters", "1", "--device", "cpu"], capsys)
    assert rc == 0, out
    assert out[0] == f"devices: 1 x cpu; 64x64, {max_pyramid_levels((64, 64))} levels"
    rows = [x.split() for x in out[2:7]]
    assert [int(r[0]) for r in rows] == [1, 2, 4, 8, 16]
    assert all(float(r[1]) > 0 for r in rows)
    assert out[-1] == "sharded pyramid over mesh (frames=1, rows=2, cols=2): OK"


def test_still_regression_against_the_reference(capsys, monkeypatch):
    from optical_flow_tpu_torch.utils.goldens import reference_dir

    if reference_dir() is None:
        pytest.skip("no reference checkout (set OPTICAL_FLOW_REFERENCE_DIR)")
    monkeypatch.setenv("OPTICAL_FLOW_REFERENCE_DIR", str(reference_dir()))
    rc, out = _run("still_regression", ["--device", "cpu"], capsys)
    assert rc == 0 and all(x.endswith("(OK vs 1e-6)") for x in out), out
