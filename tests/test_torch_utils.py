"""The port's utils/ and io/ surfaces against the JAX package's on the same
inputs: metrics, the guard, visualisation (bit for bit), images, golden
files (saveMat bytes), checkpoints (each package reads the other's; a
resumed pipeline equals its uninterrupted run bit for bit, also after a
SIGKILL), the video writer, the MJPEG preview and the profiling helpers.
"""

import io
import json
import os
import signal
import subprocess
import sys
import textwrap
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from optical_flow_tpu import config as j_config
from optical_flow_tpu.pipeline.gesture import GestureResult as JGestureResult
from optical_flow_tpu.pipeline.video import VideoPipeline as JVideoPipeline
from optical_flow_tpu.utils import checkpoint as j_ckpt
from optical_flow_tpu.utils import goldens as j_goldens
from optical_flow_tpu.utils import images as j_images
from optical_flow_tpu.utils import metrics as j_metrics
from optical_flow_tpu.utils import profiling as j_profiling
from optical_flow_tpu.utils import viz as j_viz
from optical_flow_tpu.utils.guard import FlowGuard as JFlowGuard
from optical_flow_tpu.utils.guard import NumericalFailure as JNumericalFailure
from optical_flow_tpu_torch import config as t_config
from optical_flow_tpu_torch.io.preview import _BOUNDARY, MjpegPreview
from optical_flow_tpu_torch.io.video_writer import VideoWriter
from optical_flow_tpu_torch.pipeline.gesture import GestureResult as TGestureResult
from optical_flow_tpu_torch.pipeline.video import VideoPipeline as TVideoPipeline
from optical_flow_tpu_torch.utils import checkpoint as t_ckpt
from optical_flow_tpu_torch.utils import goldens as t_goldens
from optical_flow_tpu_torch.utils import images as t_images
from optical_flow_tpu_torch.utils import metrics as t_metrics
from optical_flow_tpu_torch.utils import profiling as t_profiling
from optical_flow_tpu_torch.utils import viz as t_viz
from optical_flow_tpu_torch.utils.guard import FlowGuard, NumericalFailure, StallFailure
from test_torch_slice import _assert_flow_close

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread keeps them from spinning against
    the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ metrics


def test_metrics_match_jax():
    snaps = []
    for mod in (j_metrics, t_metrics):
        sink = io.StringIO()
        m = mod.Metrics(sink=sink)
        m.count("frames")
        m.count("frames", 2)
        m.gauge("fps", 123.4)
        for ms in (0.5, 3.0, 30.0, 5000.0):
            m.observe_ms("step", ms)
        with m.timer("host"):
            pass
        m.emit()
        snap = json.loads(sink.getvalue())
        snap.pop("uptime_s")
        snap["histograms"]["host"].pop("mean_ms")
        snaps.append(snap)
    assert snaps[0] == snaps[1]
    h = snaps[1]["histograms"]["step"]
    assert h["counts"][h["buckets_ms"].index(5)] == 1 and h["counts"][-1] == 1
    assert t_metrics.Histogram().summary() == j_metrics.Histogram().summary()


# -------------------------------------------------------------------- guard


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf, None])
@pytest.mark.parametrize("host", [False, True], ids=["tensor", "numpy"])
def test_guard_trips_as_jax_does(bad, host):
    u = np.arange(12, dtype=np.float32).reshape(3, 4)
    v = np.ones((3, 4), np.float32)
    if bad is not None:
        u[1, 2] = bad
    args = (u, v) if host else (torch.from_numpy(u), torch.from_numpy(v))
    msgs = []
    for guard, exc, a in ((JFlowGuard(), JNumericalFailure, (jnp.asarray(u), jnp.asarray(v))),
                          (FlowGuard(), NumericalFailure, args)):
        try:
            guard.check(*a, context="frame 3")
            msgs.append(None)
        except exc as e:
            msgs.append(str(e))
        assert guard.frames_checked == 1
    assert msgs[0] == msgs[1]
    assert (msgs[1] is None) == (bad is None)
    if bad is not None:
        assert msgs[1] == "4.17% non-finite values in monitored outputs at frame 3"


def test_guard_stall_watchdog():
    g = FlowGuard(stall_timeout_s=0.01)
    time.sleep(0.05)
    with pytest.raises(StallFailure):
        g.check_stalled()
    g.heartbeat()
    g.check_stalled()  # no raise after heartbeat
    g = FlowGuard(stall_timeout_s=0.05)
    stop = g.start_watchdog(poll_s=0.05)
    try:
        with pytest.raises(KeyboardInterrupt):
            time.sleep(2.0)  # no heartbeats -> the watchdog interrupts the main thread
    finally:
        stop()
    g = FlowGuard(stall_timeout_s=60.0)
    g.start_watchdog(poll_s=0.05)()  # stops cleanly, no interrupt


# ---------------------------------------------------------------------- viz


def _flows(seed=0, hw=(32, 48)):
    r = np.random.RandomState(seed)
    return r.randn(*hw).astype(np.float32) * 3, r.randn(*hw).astype(np.float32) * 3


@pytest.mark.parametrize("max_mag", [None, 2.0])
def test_flow_to_color_matches_jax(max_mag):
    u, v = _flows()
    want = j_viz.flow_to_color(u, v, max_mag=max_mag)
    np.testing.assert_array_equal(t_viz.flow_to_color(u, v, max_mag=max_mag), want)
    np.testing.assert_array_equal(
        t_viz.flow_to_color(torch.from_numpy(u), torch.from_numpy(v), max_mag=max_mag), want)
    z = np.zeros((8, 8))
    np.testing.assert_array_equal(t_viz.flow_to_color(z, z, 1.0), j_viz.flow_to_color(z, z, 1.0))


def test_draw_circle_and_arrows_match_jax():
    img = (np.random.RandomState(1).rand(64, 80, 3) * 255).astype(np.uint8)
    for args in ((32, 30, 10), (0.5, 63.2, 20), (-5, 90, 12)):
        np.testing.assert_array_equal(t_viz.draw_circle(img, *args, color=(9, 8, 7), thickness=3),
                                      j_viz.draw_circle(img, *args, color=(9, 8, 7), thickness=3))
    pts = np.array([[10.0, 10.0], [50.0, 50.0], [78.6, 1.2], [3.0, 60.0]])
    flows = np.array([[5.0, 0.0], [-5.0, 2.0], [4.0, -3.0], [-9.0, 9.0]])  # heads past the edges
    mask = np.array([True, True, True, False])
    for kw in ({}, {"mask": mask, "scale": 2.0, "thickness": 3}):
        np.testing.assert_array_equal(t_viz.draw_arrows(img, pts, flows, **kw),
                                      j_viz.draw_arrows(img, pts, flows, **kw))


@pytest.mark.parametrize("detected", [True, False])
@pytest.mark.parametrize("gray", [False, True])
def test_annotate_gesture_frame_matches_jax(detected, gray):
    frame = (np.random.RandomState(2).rand(72, 128, 3) * 255).astype(np.uint8)
    if gray:
        frame = frame[..., 1]
    g = dict(detected=detected, cx=20.25, cy=31.5, votes=900)
    jg = JGestureResult(jnp.asarray(g["detected"]), jnp.float32(g["cx"]), jnp.float32(g["cy"]),
                        jnp.int32(g["votes"]), jnp.zeros((48, 64)))
    tg = TGestureResult(torch.tensor(g["detected"]), torch.tensor(g["cx"]),
                        torch.tensor(g["cy"]), torch.tensor(g["votes"], dtype=torch.int32),
                        torch.zeros(48, 64))
    want = j_viz.annotate_gesture_frame(frame, jg, (48, 64), 35)
    got = t_viz.annotate_gesture_frame(frame, tg, (48, 64), 35)
    np.testing.assert_array_equal(got, want)


def test_save_png_writes_what_pil_reads(tmp_path):
    from PIL import Image

    u, v = _flows()
    rgb = t_viz.flow_to_color(u, v)
    t_viz.save_png(rgb, tmp_path / "t.png")
    j_viz.save_png(rgb, tmp_path / "j.png")
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")), rgb)


# ------------------------------------------------------- images and goldens


def test_images_match_jax(tmp_path, monkeypatch):
    from PIL import Image

    rgb = (np.random.RandomState(4).rand(40, 56, 3) * 255).astype(np.uint8)
    Image.fromarray(rgb).save(tmp_path / "x.png")
    np.testing.assert_array_equal(t_images.bgr_to_gray_u8(rgb[..., ::-1]),
                                  j_images.bgr_to_gray_u8(rgb[..., ::-1]))
    got = t_images.imread_gray(tmp_path / "x.png")
    np.testing.assert_array_equal(got, j_images.imread_gray(tmp_path / "x.png"))
    # without cv2 both packages decode with PIL and convert with the 15-bit
    # weights, within 1 of cv2's conversion
    monkeypatch.setitem(sys.modules, "cv2", None)
    pil = t_images.imread_gray(tmp_path / "x.png")
    np.testing.assert_array_equal(pil, j_images.imread_gray(tmp_path / "x.png"))
    assert np.abs(pil.astype(int) - got).max() <= 1
    with pytest.raises(FileNotFoundError):
        t_images.imread_gray(tmp_path / "missing.png")


def test_save_mat_writes_jax_bytes(tmp_path):
    m = np.random.RandomState(5).randn(7, 9) * 100
    for name, mat in (("f64", m), ("f32", m.astype(np.float32))):
        j_goldens.save_mat(mat, tmp_path / f"j_{name}.txt")
        t_goldens.save_mat(mat, tmp_path / f"t_{name}.txt")
        assert (tmp_path / f"t_{name}.txt").read_bytes() == (tmp_path / f"j_{name}.txt").read_bytes()
    t_goldens.save_mat(torch.from_numpy(m), tmp_path / "t_tensor.txt")
    assert (tmp_path / "t_tensor.txt").read_bytes() == (tmp_path / "j_f64.txt").read_bytes()
    back = t_goldens.load_mat(tmp_path / "t_f64.txt")
    np.testing.assert_array_equal(back, j_goldens.load_mat(tmp_path / "j_f64.txt"))
    np.testing.assert_allclose(back, m, rtol=0, atol=5e-7)  # '%f': 6 decimals


def test_reference_dir_and_table_pair(tmp_path, monkeypatch):
    from PIL import Image

    monkeypatch.delenv(t_goldens.REFERENCE_DIR_ENV, raising=False)
    assert t_goldens.reference_dir() is None
    with pytest.raises(FileNotFoundError):
        t_goldens.load_table_pair()
    (tmp_path / "testdata").mkdir()
    r = np.random.RandomState(6)
    for name in ("table1.jpg", "table2.jpg"):
        Image.fromarray((r.rand(460, 660, 3) * 255).astype(np.uint8)).save(tmp_path / "testdata" / name)
    monkeypatch.setenv(t_goldens.REFERENCE_DIR_ENV, str(tmp_path))
    assert t_goldens.reference_dir() == tmp_path
    got, want = t_goldens.load_table_pair(), j_goldens.load_table_pair()
    for a, b in zip(got, want):
        assert a.shape == (448, 640) and a.dtype == np.float64
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------- checkpoints


def _tree(array):
    return {
        "a": array(np.arange(12, dtype=np.float32).reshape(3, 4)),
        "b": None,
        "c": [array(np.ones((2, 2))), 5, "tag"],
        "d": {"x": True, "y": (1.5, array(np.zeros(3, np.uint8)))},
        "e.f": {"[g]": array(np.full(2, 7, np.int32))},
    }


def _assert_tree_equal(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray))
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_checkpoint_format_is_the_jax_packages(tmp_path):
    """The port writes JAX's npz and metadata exactly (tensors as host
    copies); each package reads the other's file."""
    t_ckpt.save_state(tmp_path / "t.npz", _tree(torch.from_numpy))
    j_ckpt.save_state(tmp_path / "j.npz", _tree(jnp.asarray))
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        for k in t.files:
            assert t[k].dtype == j[k].dtype
            np.testing.assert_array_equal(t[k], j[k])
    want = j_ckpt.load_state(tmp_path / "j.npz")
    _assert_tree_equal(t_ckpt.load_state(tmp_path / "j.npz"), want)
    _assert_tree_equal(j_ckpt.load_state(tmp_path / "t.npz"), want)
    _assert_tree_equal(t_ckpt.load_state(tmp_path / "t.npz"), want)
    assert not list(tmp_path.glob("*.tmp"))


CKPT_SIZE = 64


def _ckpt_frames(n, seed=0):
    """tests/test_checkpoint.py's frames: noise rolled 3 px a frame."""
    r = np.random.RandomState(seed)
    base = (r.rand(96, 128, 3) * 255).astype(np.uint8)
    return [np.roll(base, 3 * i, axis=1) for i in range(n)]


def _ckpt_configs():
    """tests/test_checkpoint.py's configuration: reference parity at 64^2, plain."""
    pre = dict(size=(CKPT_SIZE, CKPT_SIZE))
    return (j_config.VideoConfig(preprocess=j_config.PreprocessConfig(**pre),
                                 flow=j_config.FlowConfig(impl="jnp")),
            t_config.VideoConfig(preprocess=t_config.PreprocessConfig(**pre),
                                 flow=t_config.FlowConfig(impl="torch")))


def _push_all(pipe, frames):
    return [r for f in frames for r in [pipe.push(f)] if r is not None]


def test_pipeline_resume_matches_uninterrupted(tmp_path):
    _, tc = _ckpt_configs()
    frames = _ckpt_frames(7)
    full = _push_all(TVideoPipeline(tc, device="cpu"), frames)
    p1 = TVideoPipeline(tc, device="cpu")
    first = _push_all(p1, frames[:4])
    t_ckpt.save_state(tmp_path / "state.npz", p1.state())
    p2 = TVideoPipeline(tc, device="cpu")
    p2.restore(t_ckpt.load_state(tmp_path / "state.npz"))
    resumed = first + _push_all(p2, frames[4:])
    assert len(resumed) == len(full) == 5
    for a, b in zip(resumed, full):
        assert torch.equal(a.u, b.u) and torch.equal(a.v, b.v)
        assert all(torch.equal(x, y) for x, y in zip(a.gesture, b.gesture))


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A JAX checkpoint resumes the port's pipeline, and a port checkpoint
    JAX's; each continuation meets the other package's uninterrupted run at
    the slice bar, and the loaded states are bit for bit the saved ones."""
    jc, tc = _ckpt_configs()
    frames = _ckpt_frames(7)
    j_full = _push_all(JVideoPipeline(jc), frames)
    t_full = _push_all(TVideoPipeline(tc, device="cpu"), frames)

    jp = JVideoPipeline(jc)
    _push_all(jp, frames[:4])
    j_ckpt.save_state(tmp_path / "jax.npz", jp.state())
    state = t_ckpt.load_state(tmp_path / "jax.npz")
    _assert_tree_equal(state, jp.state())
    tp = TVideoPipeline(tc, device="cpu")
    tp.restore(state)
    t_rest = _push_all(tp, frames[4:])

    tp = TVideoPipeline(tc, device="cpu")
    _push_all(tp, frames[:4])
    t_ckpt.save_state(tmp_path / "port.npz", tp.state())
    state = j_ckpt.load_state(tmp_path / "port.npz")
    _assert_tree_equal(state, {k: v.numpy() if isinstance(v, torch.Tensor) else v
                               for k, v in tp.state().items()})
    jp = JVideoPipeline(jc)
    jp.restore(state)
    j_rest = _push_all(jp, frames[4:])

    assert len(t_rest) == len(j_rest) == 3
    for got, want in ((t_rest, j_full[2:]), (j_rest, t_full[2:])):
        for a, b in zip(got, want):
            _assert_flow_close(np.asarray(b.u), np.asarray(b.v), np.asarray(a.u), np.asarray(a.v))
            x, y = int(a.gesture.votes), int(b.gesture.votes)
            assert abs(x - y) <= max(1, 0.01 * max(x, y)), (x, y)


# The SIGKILL-and-resume test of tests/test_chaos.py, on the port. Its worker
# (tests/_chaos_worker.py drives the JAX package) is written here.
_CHAOS_WORKER = '''
import argparse, os, sys, time

import numpy as np

N_FRAMES = 9


def make_frames():
    r = np.random.RandomState(31)
    base = (r.rand(96, 128, 3) * 255).astype(np.uint8)
    return [np.roll(base, 3 * i, axis=1) for i in range(N_FRAMES)]


def save_result(workdir, idx, result):
    path = os.path.join(workdir, f"flow_{idx:03d}.npz")
    with open(path + ".tmp", "wb") as f:
        np.savez(f, u=result.u.numpy(), v=result.v.numpy())
    os.replace(path + ".tmp", path)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--kill-after", type=int, default=None)
    args = ap.parse_args()

    import torch

    torch.set_num_threads(1)
    from optical_flow_tpu_torch.config import FlowConfig, PreprocessConfig, VideoConfig
    from optical_flow_tpu_torch.pipeline.video import VideoPipeline
    from optical_flow_tpu_torch.utils.checkpoint import load_state, save_state

    cfg = VideoConfig(preprocess=PreprocessConfig(size=(64, 64)), flow=FlowConfig(impl="torch"))
    pipe = VideoPipeline(cfg, device="cpu")
    ckpt = os.path.join(args.workdir, "state.npz")
    start = 0
    if args.resume:
        if os.path.exists(ckpt):
            pipe.restore(load_state(ckpt))
            start = pipe.state()["frame_idx"]
        print(f"RESUMED_AT {start}", flush=True)
    frames = make_frames()
    for i in range(start, len(frames)):
        result = pipe.push(frames[i])
        if result is not None:
            save_result(args.workdir, i, result)
        save_state(ckpt, pipe.state())
        print(f"FRAME {i}", flush=True)
        if args.kill_after is not None and i == args.kill_after:
            print("READY_TO_DIE", flush=True)
            time.sleep(120)
            sys.exit(7)
    assert "jax" not in sys.modules
    print("STREAM_DONE", flush=True)
    os._exit(0)  # every file is written and closed; skip the interpreter's teardown


if __name__ == "__main__":
    main()
'''


def _start_worker(worker, workdir, *extra):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, str(worker), str(workdir), *extra],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _finish_worker(p, timeout=120):
    out, err = p.communicate(timeout=timeout)
    assert p.returncode == 0, f"rc={p.returncode}\n{out}\n{err[-3000:]}"
    return out


def _kill_worker_at(p, wait_for):
    """Read the worker's lines up to ``wait_for``, then SIGKILL it: the crash
    lands at a known point and the process gets no chance to clean up."""
    lines = []
    for line in p.stdout:
        lines.append(line)
        if wait_for in line:
            os.kill(p.pid, signal.SIGKILL)
            break
    else:
        p.kill()
        pytest.fail(f"marker {wait_for!r} never appeared:\n{''.join(lines)}")
    p.wait(timeout=30)
    p.stdout.close()
    p.stderr.close()
    assert p.returncode == -signal.SIGKILL
    return "".join(lines)


def _collect(workdir):
    out = {}
    for name in sorted(os.listdir(workdir)):
        if name.startswith("flow_") and name.endswith(".npz"):
            with np.load(os.path.join(workdir, name)) as z:
                out[name] = (z["u"].copy(), z["v"].copy())
    return out


KILL_POINTS = (4, 1)  # after frame 4's checkpoint (mid-stream); after frame 1's (warm-up)


@pytest.fixture(scope="module")
def chaos(tmp_path_factory):
    """The worker script, its uninterrupted run's results and, for each kill
    point, the directory of a stream SIGKILLed there. The three runs start
    together (each is its own process)."""
    root = tmp_path_factory.mktemp("chaos")
    worker = root / "chaos_worker.py"
    worker.write_text(textwrap.dedent(_CHAOS_WORKER))
    dirs = {k: root / f"killed_after_{k}" for k in ("clean", *KILL_POINTS)}
    for d in dirs.values():
        d.mkdir()
    procs = {"clean": _start_worker(worker, dirs["clean"])}
    for k in KILL_POINTS:
        procs[k] = _start_worker(worker, dirs[k], "--kill-after", str(k))
    for k in KILL_POINTS:
        _kill_worker_at(procs[k], "READY_TO_DIE")
    assert "STREAM_DONE" in _finish_worker(procs["clean"])
    ref = _collect(dirs["clean"])
    assert len(ref) == 7  # 9 frames, 2 warm-up
    return worker, ref, dirs


@pytest.mark.parametrize("kill_after,resumed_at", [(4, 5), (1, 2)], ids=["mid-stream", "warm-up"])
def test_sigkill_resume_bit_identical(chaos, kill_after, resumed_at):
    """Resume, in a new process, from the checkpoint the killed stream left:
    the results equal the uninterrupted run's bit for bit."""
    worker, ref, dirs = chaos
    workdir = dirs[kill_after]
    partial = _collect(workdir)
    assert len(partial) == max(0, kill_after - 1)
    out = _finish_worker(_start_worker(worker, workdir, "--resume"))
    assert f"RESUMED_AT {resumed_at}" in out and "STREAM_DONE" in out
    resumed = _collect(workdir)
    assert set(resumed) == set(ref)
    for name in ref:
        np.testing.assert_array_equal(resumed[name][0], ref[name][0], err_msg=name)
        np.testing.assert_array_equal(resumed[name][1], ref[name][1], err_msg=name)


# ------------------------------------------------------------- video writer


def _rgb_frames(n=4, h=48, w=64):
    r = np.random.RandomState(3)
    return [(r.rand(h, w, 3) * 255).astype(np.uint8) for _ in range(n)]


def test_png_writer_writes_jax_files(tmp_path):
    from optical_flow_tpu.io.video_writer import VideoWriter as JVideoWriter

    for cls, name in ((VideoWriter, "port"), (JVideoWriter, "jax")):
        with cls(tmp_path / name, backend="png") as w:
            for f in _rgb_frames():
                w.write(f)
        assert w.backend == "png" and w.frames_written == 4
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == [f"frame_{i:05d}.png" for i in range(4)] == sorted(os.listdir(tmp_path / "jax"))
    from PIL import Image

    for i, name in enumerate(names):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / name)),
                                      _rgb_frames()[i])


def test_encoded_writer_roundtrip(tmp_path):
    """The backend is JAX's choice for the path (ffmpeg, else cv2, else
    PNGs); an encoded clip reads back through the port's reader."""
    from optical_flow_tpu.io.video_writer import VideoWriter as JVideoWriter

    out = tmp_path / "clip.mp4"
    frames = _rgb_frames(6)
    w = VideoWriter(out, fps=10)
    assert w.backend == JVideoWriter(tmp_path / "j.mp4", fps=10).backend
    with w:
        for f in frames:
            w.write(f)
        with pytest.raises(ValueError, match="frame size changed"):
            w.write(np.zeros((8, 8, 3), np.uint8))
        with pytest.raises(ValueError, match="RGB"):
            w.write(np.zeros((4, 4), np.uint8))
    if w.backend == "png":  # no encoder here: the PNG directory instead
        assert len(os.listdir(tmp_path / "clip")) == 6
        return
    assert out.exists() and out.stat().st_size > 0
    from optical_flow_tpu_torch.io.video_reader import read_frames

    back = list(read_frames(out))
    assert len(back) == 6 and back[0].shape == frames[0].shape


# ------------------------------------------------------------------ preview


def _frame(seed=0, h=48, w=64):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def test_preview_endpoints():
    """/frame.jpg (the latest frame, RGB and gray), / and /stream."""
    with MjpegPreview(host="127.0.0.1", port=0) as prev:
        base = f"http://127.0.0.1:{prev.address[1]}"
        prev.push(_frame(1))
        data = urllib.request.urlopen(base + "/frame.jpg", timeout=10).read()
        assert data[:2] == b"\xff\xd8"
        from PIL import Image

        assert Image.open(io.BytesIO(data)).size == (64, 48)
        assert b"/stream" in urllib.request.urlopen(base + "/", timeout=10).read()
        prev.push((np.ones((32, 40)) * 128).astype(np.uint8))
        assert urllib.request.urlopen(base + "/frame.jpg", timeout=10).read()[:2] == b"\xff\xd8"
        got = []
        resp = urllib.request.urlopen(base + "/stream", timeout=10)
        assert _BOUNDARY in resp.headers["Content-Type"]
        buf = b""
        for s in range(50):
            prev.push(_frame(s))
            buf += resp.read1(65536)
            got = [j for j in buf.split(b"--" + _BOUNDARY.encode()) if b"\xff\xd8" in j]
            if len(got) >= 3:
                break
        resp.close()
        assert len(got) >= 3
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=10)
    assert prev.closed


def test_preview_push_never_blocks_without_viewers():
    with MjpegPreview(host="127.0.0.1", port=0) as prev:
        t0 = time.perf_counter()
        for s in range(20):
            prev.push(_frame(s, h=32, w=32))
        took = time.perf_counter() - t0
    assert took < 2.0, took  # encode-only cost, no client backpressure


def test_preview_needs_an_encoder(monkeypatch):
    import importlib.util

    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None)
    with pytest.raises(RuntimeError, match="cv2.*PIL"):
        MjpegPreview(host="127.0.0.1", port=0)


# ---------------------------------------------------------------- profiling


def test_timer_matches_jax():
    timers = (j_profiling.Timer(), t_profiling.Timer())
    x = torch.ones(4)
    for t in timers:
        with t.segment("a"):
            pass
        with t.segment("a", sync=None):
            pass
        with t.segment("b"):
            pass
    with timers[1].segment("c", sync={"x": (x, [x * 2])}):  # CPU tensors: nothing to wait for
        pass
    assert timers[1].counts == {"a": 2, "b": 1, "c": 1}
    for t in timers:
        t.segments = {"a": 0.003, "b": 0.0125}
        t.counts = {"a": 2, "b": 5}
    assert timers[1].report() == timers[0].report()


def test_flow_roofline_on_h100_peaks():
    r = t_profiling.flow_roofline(1080, 1080)
    px = 1080 * 1080
    assert r["bytes"] == 16.0 * px and r["flops"] == 77.0 * px
    assert r["t_mem_us"] == pytest.approx(16.0 * px / 3.35e12 * 1e6)
    assert r["t_compute_us"] == pytest.approx(77.0 * px / 67e12 * 1e6)
    assert r["bound"] == "memory" and r["sol_us"] == r["t_mem_us"]
    assert r["sol_fps"] == pytest.approx(1e6 / r["sol_us"])
    # the bound of kernel K1 on that pair, as the kernel table counts it
    a = torch.zeros(1080, 1080)
    cost = t_profiling.kernel_cost("lk", [a, a], [a, a])
    assert t_profiling.stage_roofline(cost)["bound_ms"] * 1e3 == pytest.approx(r["sol_us"])
    slow = t_profiling.flow_roofline(8, 8, bytes_per_s=1e12, ops_per_s=1e9)
    assert slow["bound"] == "compute"


def test_trace_and_device_seconds(tmp_path):
    """A CPU trace holds no device span: no device number from the CPU. On a
    Chrome trace with kernel spans, the named kernel's spans are summed."""
    with t_profiling.trace(str(tmp_path / "cpu")) as d:
        torch.ones(64, 64).sum()
    assert (Path(d) / "trace.json").exists()
    assert t_profiling.device_seconds_from_trace(d, "", 1) is None
    events = [{"ph": "X", "cat": "kernel", "name": "lk_strip_kernel<4, 2, 1>", "dur": 10.5},
              {"ph": "X", "cat": "kernel", "name": "lk_strip_kernel<4, 2, 1>", "dur": 9.5},
              {"ph": "X", "cat": "kernel", "name": "pyrdown_kernel", "dur": 7.0},
              {"ph": "X", "cat": "cpu_op", "name": "lk_strip_kernel launch", "dur": 99.0}]
    (tmp_path / "gpu").mkdir()
    (tmp_path / "gpu" / "trace.json").write_text(json.dumps({"traceEvents": events}))
    d = str(tmp_path / "gpu")
    assert t_profiling.device_seconds_from_trace(d, "lk_strip_kernel", 2) == pytest.approx(20e-6)
    assert t_profiling.device_seconds_from_trace(d, "lk_strip_kernel", 3) is None
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "trace.json").write_text("{not json")
    assert t_profiling.device_seconds_from_trace(str(tmp_path / "bad"), "x", 0) is None


def test_device_timing_needs_a_card():
    with pytest.raises(RuntimeError, match="CUDA device"):
        t_profiling.device_loop_time(lambda x: x * 2.0, (torch.ones(16, 16),), iters=3)
