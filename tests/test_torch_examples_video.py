"""The port's example scripts on video input (optical_flow_tpu_torch/
examples/: video_gesture, trajectory, sparse_track, stabilize, pair_scrub;
live_gesture and serve_stream are in test_torch_examples_live.py), each run in process through its
``main(argv)`` with ``--device cpu`` on a small video written here with
cv2 (a smooth texture moving (+2, +1) px a frame; decoded by the native
backend where the library builds), and held to the JAX package's script on
the same file, run in process as tests/test_video_out.py runs
examples/pair_scrub.py:

  video_gesture     at 48^2, the reference-parity default: its lines are its
                    pipeline's results; those flows against the JAX
                    pipeline's on the same frames at the slice bar (median
                    < 1e-3 px, q99 < 0.02 px; they agree to q99 < 4e-6 px);
                    the JAX script's line count, detection flags and PNG
                    files (votes are not compared: the 20 px gate keeps
                    near-singular pixels, which roundoff flips); --fast
                    runs the fast preset
  trajectory,       the JAX script's printed lines, exactly (sparse LK and
  sparse_track,     the homography at the printed 2 decimals)
  stabilize
  pair_scrub        the JAX script's pairs and files (f, b, q scripted), its
                    track counts within 1% or 1 (the 3x3 window's gate)

Every script that takes ``--device`` raises without a card when asked for
``cuda`` (in process), and the modules run as ``python -m``.
"""

import os
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_examples_scenes import _run, _run_jax_script
from test_torch_native import moving_texture_frames, write_video

REPO = Path(__file__).resolve().parents[1]
FRAME = re.compile(r"frame (\d+): votes=\d+ detected=(\w+) centroid=")
TIMING = re.compile(r" host-sync [0-9.]+ ms$")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread keeps the scripts' small ops from spinning
    against the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    pytest.importorskip("cv2")
    return write_video(tmp_path_factory.mktemp("examples") / "clip.mp4",
                       moving_texture_frames(n=10, hw=(120, 160)))


def _files(d):
    return sorted(os.listdir(d))


def test_video_gesture_prints_the_jax_lines(video, tmp_path, capsys, monkeypatch):
    from optical_flow_tpu import config as j_config
    from optical_flow_tpu.pipeline.video import VideoPipeline as JVideoPipeline
    from optical_flow_tpu_torch.config import video_config_for
    from optical_flow_tpu_torch.io.video_reader import read_frames
    from optical_flow_tpu_torch.pipeline.video import VideoPipeline
    from test_torch_slice import _assert_flow_close

    args = ["--input", video, "--frames", "4", "--size", "48"]
    rc, got = _run("video_gesture", args + ["--out", str(tmp_path / "t"), "--device", "cpu"],
                   capsys)
    want = _run_jax_script("video_gesture", args + ["--out", str(tmp_path / "j")], capsys,
                           monkeypatch)
    assert rc == 0 and got[0] == f"4 frames from {video}" and got[-1] == "processed 2 flow frames"
    assert len(got) == len(want) and got[0] == want[0] and got[-1] == want[-1]
    # the script prints its pipeline's results
    frames = list(read_frames(video, max_frames=4))
    mine = list(VideoPipeline(video_config_for("faithful", (48, 48)), device="cpu").run(frames))
    theirs = list(JVideoPipeline(j_config.VideoConfig(
        preprocess=j_config.PreprocessConfig(size=(48, 48)))).run(frames))
    for i, (line, jline, r, jr) in enumerate(zip(got[1:-1], want[1:-1], mine, theirs)):
        g = r.gesture
        assert TIMING.sub("", line) == (f"frame {i}: votes={int(g.votes)} detected={bool(g.detected)} "
                                        f"centroid=({float(g.cx):.1f},{float(g.cy):.1f})")
        # the flows at the slice bar (they agree to q99 < 4e-6 px here); the
        # votes are not compared: the 20 px gate keeps a few dozen
        # near-singular pixels (flows of 10^2-10^4 px), which roundoff flips
        _assert_flow_close(jr.u, jr.v, r.u, r.v)
        assert FRAME.match(line).group(2) == FRAME.match(jline).group(2)  # detected
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    rc, fast = _run("video_gesture", ["--input", video, "--frames", "4", "--size", "48", "--fast",
                                      "--device", "cpu"], capsys)
    assert rc == 0 and sum(x.startswith("frame ") for x in fast) == 2


@pytest.mark.parametrize("name", ["trajectory", "sparse_track", "stabilize"])
def test_tracking_scripts_print_the_jax_lines(video, name, tmp_path, capsys, monkeypatch):
    args = ["--input", video, "--frames", "2"]  # one frame pair: sparse LK is eager on the CPU
    out = ["--out", str(tmp_path / "t")] if name != "trajectory" else []
    rc, got = _run(name, args + out + ["--device", "cpu"], capsys)
    jout = ["--out", str(tmp_path / "j")] if name != "trajectory" else []
    want = _run_jax_script(name, args + jout, capsys, monkeypatch)
    assert rc == 0 and len(got) >= 1
    assert got == want
    if out:
        assert _files(tmp_path / "t") == _files(tmp_path / "j")
    if name == "trajectory":  # the texture moves (+2, +1) px a frame
        dts = np.array([[float(v) for v in re.search(r"dt=\(([-+.\d]+),([-+.\d]+)\)", x).groups()]
                        for x in got])
        np.testing.assert_allclose(dts[0], [2.0, 1.0], atol=0.15)


def test_pair_scrub_prints_the_jax_lines(video, tmp_path, capsys, monkeypatch):
    """f then b: pair 1 rendered, then pair 0 again (the legacy demo's 'b')."""
    args = ["--input", video, "--script", "fbq", "--max-frames", "4"]
    rc, got = _run("pair_scrub", args + ["--outdir", str(tmp_path / "t"), "--device", "cpu"],
                   capsys)
    want = _run_jax_script("pair_scrub", args + ["--outdir", str(tmp_path / "j")], capsys,
                           monkeypatch)
    assert rc == 0
    assert _files(tmp_path / "t") == _files(tmp_path / "j") == ["pair_0000.png", "pair_0001.png"]
    # track counts at the slice bar's vote rule (within 1%, or 1): the 3x3
    # window's minimum-eigenvalue gate flips on roundoff
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        pa, na = re.match(r"(pair \d+->\d+): (\d+) tracks", a).groups()
        pb, nb = re.match(r"(pair \d+->\d+): (\d+) tracks", b).groups()
        assert pa == pb and abs(int(na) - int(nb)) <= max(1, 0.01 * int(nb)), (a, b)
    assert sum("pair 0->1" in x for x in got) == 2 and sum("pair 1->2" in x for x in got) == 1


DEVICE_SCRIPTS = {
    "loop_closure": [], "scale_drift": [], "stereo_slam": [], "vi_odometry": [], "sfm_demo": [],
    "scaling_report": [], "video_gesture": ["--input", "x.mp4"],
    "trajectory": ["--input", "x.mp4"], "sparse_track": ["--input", "x.mp4"],
    "stabilize": ["--input", "x.mp4"], "pair_scrub": ["--input", "x.mp4"],
    "live_gesture": ["--input", "x.mp4"],
}


@pytest.mark.parametrize("name", list(DEVICE_SCRIPTS))
def test_device_cuda_raises_without_a_card(name):
    """--device defaults to cuda; without a card the script raises before
    it reads or renders anything."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    mod = importlib.import_module(f"optical_flow_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(DEVICE_SCRIPTS[name])


@pytest.mark.parametrize("name", sorted(p.stem for p in (REPO / "examples").glob("*.py")))
def test_examples_run_as_modules(name, monkeypatch, capsys):
    """``python -m optical_flow_tpu_torch.examples.<name>``, run in process
    (runpy): the module's entry point parses its flags first; --help exits 0
    and lists the JAX script's flags, ``--device`` in place of ``--cpu``."""
    monkeypatch.setattr(sys, "argv", [name, "--help"])
    with pytest.raises(SystemExit) as done:
        runpy.run_module(f"optical_flow_tpu_torch.examples.{name}", run_name="__main__")
    assert done.value.code == 0
    text = capsys.readouterr().out
    jax_src = (REPO / "examples" / f"{name}.py").read_text()
    for flag in sorted(set(re.findall(r'add_argument\(\s*"(--[a-z0-9-]+)"', jax_src)) - {"--cpu"}):
        assert flag in text, (name, flag)
    assert ("--device" in text) == ("--cpu" in jax_src)
