"""The port's native host runtime (optical_flow_tpu_torch/native/: the
libav decoder, V4L2 capture and golden IO, built with g++ into build/native/)
and the reader backends it serves, on the CPU: counterparts of the JAX
package's tests/test_native.py and tests/test_camera.py.

Both packages' libraries decode the same video, written here with cv2's
VideoWriter (MPEG-4 part 2 in .mp4: keyframes and predicted frames, so a
seek lands on a keyframe and decodes forward), and must give the same
bytes: BGR and gray, from the start and after a seek. The reference-golden
case skips without a reference checkout (OPTICAL_FLOW_REFERENCE_DIR), the
real-camera case without /dev/video0, as the JAX package's do.
"""

import itertools
import os
import stat
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from optical_flow_tpu import native as j_native
from optical_flow_tpu.io import video_reader as j_video_reader
from optical_flow_tpu.utils import goldens as j_goldens
from optical_flow_tpu_torch import native
from optical_flow_tpu_torch.io import video_reader as t_video_reader
from optical_flow_tpu_torch.utils import goldens as t_goldens

REPO = Path(__file__).resolve().parents[1]
VIDEO_HW = (96, 128)
VIDEO_FRAMES = 20
STEP = (2, 1)  # (dx, dy) px a frame of moving_texture_frames


def moving_texture_frames(n=VIDEO_FRAMES, hw=VIDEO_HW, step=STEP, seed=0):
    """BGR uint8 frames of a smooth random texture that moves ``step`` px a
    frame (a window sliding over a larger texture)."""
    import cv2

    h, w = hw
    dx, dy = step
    rng = np.random.RandomState(seed)
    big = rng.rand(h + abs(dy) * n + 8, w + abs(dx) * n + 8, 3).astype(np.float32)
    big = cv2.GaussianBlur(big, (0, 0), 2.0)
    big = (255 * (big - big.min()) / np.ptp(big)).astype(np.uint8)
    y0, x0 = abs(dy) * n, abs(dx) * n
    return [np.ascontiguousarray(big[y0 - dy * t : y0 - dy * t + h, x0 - dx * t : x0 - dx * t + w])
            for t in range(n)]


def write_video(path, frames, fps=10.0, fourcc="mp4v"):
    """Write BGR frames with cv2's VideoWriter; returns the path as a str."""
    import cv2

    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    if not writer.isOpened():
        pytest.skip(f"cv2 cannot write {fourcc}")
    for f in frames:
        writer.write(f)
    writer.release()
    return str(path)


def cv2_decode(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return frames


@pytest.fixture(scope="module")
def lib():
    if native.load_library() is None:
        pytest.skip(f"native toolchain unavailable: {native.unavailable_reason()}")
    if j_native.load_library() is None:
        pytest.skip("the JAX package's native library is unavailable")
    return native.load_library()


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    pytest.importorskip("cv2")
    return write_video(tmp_path_factory.mktemp("native") / "clip.mp4", moving_texture_frames())


def _decode(cls, path, **kw):
    with cls(path, **kw) as pipe:
        return list(pipe)


# ------------------------------------------------------------ golden IO


def test_golden_io_roundtrip(lib, tmp_path):
    rng = np.random.RandomState(0)
    mat = np.round(rng.randn(13, 7) * 10, 6)
    p = tmp_path / "m.txt"
    assert native.save_mat_native(mat, p)
    back = native.load_mat_native(p, 13, 7)
    np.testing.assert_allclose(back, mat, atol=1e-6)  # %f keeps 6 decimals
    # a tensor saves as its values
    assert native.save_mat_native(torch.from_numpy(mat), tmp_path / "t.txt")
    assert (tmp_path / "t.txt").read_bytes() == p.read_bytes()


def test_golden_io_matches_python_and_jax(lib, tmp_path):
    """gf_save writes the bytes of utils.goldens.save_mat, and of the JAX
    package's native writer and save_mat."""
    rng = np.random.RandomState(1)
    mat = rng.randn(5, 9)
    paths = {name: tmp_path / f"{name}.txt" for name in ("native", "python", "jax", "jax_py")}
    assert native.save_mat_native(mat, paths["native"])
    t_goldens.save_mat(mat, paths["python"])
    assert j_native.save_mat_native(mat, paths["jax"])
    j_goldens.save_mat(mat, paths["jax_py"])
    want = paths["jax"].read_bytes()
    assert all(p.read_bytes() == want for p in paths.values())
    # load_mat parses through the native loader, equal to JAX's and to numpy
    got = t_goldens.load_mat(paths["native"])
    np.testing.assert_array_equal(got, j_goldens.load_mat(paths["native"]))
    np.testing.assert_array_equal(got, np.loadtxt(paths["native"]))


def test_load_mat_uses_the_native_parser(lib, tmp_path, monkeypatch):
    calls = []
    real = native.load_mat_native
    monkeypatch.setattr(native, "load_mat_native",
                        lambda *a: calls.append(a[1:]) or real(*a))
    p = tmp_path / "m.txt"
    t_goldens.save_mat(np.arange(12.0).reshape(3, 4), p)
    np.testing.assert_array_equal(t_goldens.load_mat(p), np.arange(12.0).reshape(3, 4))
    assert calls == [(3, 4)]


def test_native_parses_reference_golden(lib):
    ref = t_goldens.reference_dir()
    if ref is None:
        pytest.skip("reference not available (set OPTICAL_FLOW_REFERENCE_DIR)")
    mat = native.load_mat_native(ref / "U2Test.txt", 448, 640)
    assert mat is not None
    np.testing.assert_array_equal(mat, np.loadtxt(ref / "U2Test.txt"))


def test_gf_load_detects_oversized_golden(lib, tmp_path):
    """A golden file with more values than rows*cols is rejected, not
    truncated: gf_load reports the total count present."""
    p = tmp_path / "bad.txt"
    p.write_text("1.0 2.0 3.0\n4.0 5.0 6.0\n7.0 8.0\n")  # 8 values
    assert native.load_mat_native(p, 2, 3) is None
    assert j_native.load_mat_native(p, 2, 3) is None
    p2 = tmp_path / "good.txt"
    p2.write_text("1.0 2.0 3.0\n4.0 5.0 6.0\n")
    np.testing.assert_array_equal(native.load_mat_native(p2, 2, 3), [[1, 2, 3], [4, 5, 6]])


# ------------------------------------------------------------ the build


def test_build_never_writes_into_the_jax_package(tmp_path, monkeypatch):
    """A fresh build goes to BUILD_DIR under a content-hashed name; the JAX
    package's native/ directory lists the same files before and after."""
    if native.load_library() is None:
        pytest.skip(f"native toolchain unavailable: {native.unavailable_reason()}")
    jax_dir = REPO / "optical_flow_tpu" / "native"
    before = sorted(os.listdir(jax_dir))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    out = native.build()
    assert out.parent == tmp_path / "native" and out.exists()
    assert out.name.startswith("libframepipe_") and out.suffix == ".so"
    assert sorted(os.listdir(tmp_path / "native")) == [out.name]  # no temporary left
    assert native.build() == out  # built once, then reused
    assert sorted(os.listdir(jax_dir)) == before
    assert native.BUILD_DIR != jax_dir and "optical_flow_tpu/native" not in str(
        native.library_path(native.av_flags()[0]))


def test_missing_libav_is_named(tmp_path, monkeypatch):
    """The reason of a failed build names the libav packages pkg-config
    does not find and carries the compiler's output; explicit backends
    raise with it, 'auto' decodes elsewhere and load_mat reads with numpy."""
    fake = tmp_path / "bin" / "pkg-config"
    fake.parent.mkdir()
    fake.write_text('#!/bin/sh\n[ "$1" = "--exists" ] && [ "$2" = "libswscale" ] && exit 1\n'
                    'exit 0\n')
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{fake.parent}{os.pathsep}{os.environ['PATH']}")
    assert native.av_flags() == (native.AV_LIBS_FALLBACK, ("libswscale",))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", "false")  # a compiler that fails
    with pytest.raises(RuntimeError, match="pkg-config did not find libswscale"):
        native.build()
    assert not list((tmp_path / "native").iterdir())
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert native.av_flags() == (native.AV_LIBS_FALLBACK, ("pkg-config not found",))

    # the state load_library keeps after such a failure
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_reason", "the native build failed (1); pkg-config did not "
                        "find libswscale: g++ ...")
    assert native.load_library() is None and "libswscale" in native.unavailable_reason()
    clip = tmp_path / "clip.avi"
    clip.write_bytes(b"\0" * 64)
    with pytest.raises(RuntimeError, match="native library unavailable: .*libswscale"):
        t_video_reader.VideoReader(str(clip), backend="native")
    with pytest.raises(RuntimeError, match="native library unavailable: .*libswscale"):
        t_video_reader.VideoReader("/dev/video0", backend="v4l2")
    with pytest.raises(RuntimeError, match="libswscale"):
        native.NativeFramePipe(str(clip))
    assert native.probe_native(clip) is None and native.load_mat_native(clip, 1, 1) is None
    assert native.save_mat_native(np.zeros((1, 1)), tmp_path / "m.txt") is False
    p = tmp_path / "g.txt"
    t_goldens.save_mat(np.eye(3), p)
    np.testing.assert_array_equal(t_goldens.load_mat(p), np.eye(3))


# ------------------------------------------------------------ decode


def test_frame_pipe_reads_video(lib, video):
    with native.NativeFramePipe(video) as pipe:
        assert (pipe.width, pipe.height) == VIDEO_HW[::-1] and pipe.fps == 10.0
        frames = list(itertools.islice(iter(pipe), 5))
    assert len(frames) == 5
    assert frames[0].shape == VIDEO_HW + (3,) and frames[0].dtype == np.uint8
    assert not np.array_equal(frames[0], frames[4])  # decode advances
    assert native.probe_native(video) == (VIDEO_HW[1], VIDEO_HW[0], 10.0)


@pytest.mark.parametrize("gray", [False, True], ids=["bgr", "gray"])
@pytest.mark.parametrize("start", [0, 7])
def test_frame_pipe_equals_jax(lib, video, gray, start):
    """The port's library gives the JAX package's bytes, BGR and gray, from
    the start and after a container seek."""
    got = _decode(native.NativeFramePipe, video, start=start, gray=gray)
    want = _decode(j_native.NativeFramePipe, video, start=start, gray=gray)
    assert len(got) == len(want) == VIDEO_FRAMES - start
    shape = VIDEO_HW if gray else VIDEO_HW + (3,)
    for a, b in zip(got, want):
        assert a.shape == shape and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def test_frame_pipe_matches_cv2(lib, video):
    """BGR against cv2's own decode of the file, at the JAX test's bar (both
    decode through libav; codec versions may round apart)."""
    got = _decode(native.NativeFramePipe, video)
    want = cv2_decode(video)
    assert len(got) == len(want) == VIDEO_FRAMES
    for a, b in zip(got, want):
        assert np.abs(a.astype(int) - b.astype(int)).mean() < 2.0


def test_frame_pipe_gray_decode(lib, video):
    """gray=True is a one-hop YUV -> luma conversion: within the JAX test's
    bar of cv2's BT.601 gray of the BGR decode (mean < 2, median <= 1)."""
    import cv2

    gray = _decode(native.NativeFramePipe, video, gray=True)
    bgr = _decode(native.NativeFramePipe, video)
    for g, b in zip(gray, bgr):
        assert g.ndim == 2 and g.dtype == np.uint8 and b.shape == g.shape + (3,)
        d = np.abs(g.astype(np.int32) - cv2.cvtColor(b, cv2.COLOR_BGR2GRAY).astype(np.int32))
        assert d.mean() < 2.0 and np.percentile(d, 50) <= 1, (d.max(), d.mean())


def test_frame_pipe_early_close(lib, video):
    """Closing mid-stream returns promptly and ends the iteration."""
    pipe = native.NativeFramePipe(video, ring=2)
    it = iter(pipe)
    next(it)
    pipe.close()
    assert list(it) == []
    pipe.close()  # twice is harmless


@pytest.mark.parametrize("gray", [False, True], ids=["bgr", "gray"])
def test_native_seek_matches_skip_decode(lib, video, gray):
    """A container seek yields the frames decode-and-skip from zero gives."""
    start = 7
    with native.NativeFramePipe(video, gray=gray) as pipe:
        skipped = list(itertools.islice(iter(pipe), start, start + 3))
    with native.NativeFramePipe(video, start=start, gray=gray) as pipe:
        seeked = list(itertools.islice(iter(pipe), 3))
    assert len(skipped) == len(seeked) == 3
    for a, b in zip(skipped, seeked):
        np.testing.assert_array_equal(a, b)
    # a start past the end is an empty stream, not a failure
    assert _decode(native.NativeFramePipe, video, start=VIDEO_FRAMES + 5, gray=gray) == []


def test_threaded_decode_bit_exact(lib, video, monkeypatch):
    """The codec's threads (OPTICAL_FLOW_DECODE_THREADS=1: one) do not
    change a byte."""
    monkeypatch.setenv("OPTICAL_FLOW_DECODE_THREADS", "1")
    single = _decode(native.NativeFramePipe, video)
    monkeypatch.delenv("OPTICAL_FLOW_DECODE_THREADS")
    multi = _decode(native.NativeFramePipe, video)
    assert len(single) == len(multi) == VIDEO_FRAMES
    for a, b in zip(single, multi):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ the reader


def test_auto_backend_is_jax_choice(lib, video, tmp_path, monkeypatch):
    """'auto' takes the backend the JAX package takes on the same file:
    native where its probe opens the file, else ffmpeg/cv2."""
    t_reader = t_video_reader.VideoReader(video)
    j_reader = j_video_reader.VideoReader(video)
    assert t_reader.backend == j_reader.backend == "native"
    assert (t_reader.width, t_reader.height, t_reader.fps) == (
        j_reader.width, j_reader.height, j_reader.fps)
    junk = tmp_path / "junk.mp4"
    junk.write_bytes(b"\0" * 256)
    for mod in (t_video_reader, j_video_reader):
        monkeypatch.setattr(mod.shutil, "which", lambda name: None)  # no ffmpeg
    assert t_video_reader.VideoReader(str(junk)).backend == "cv2"
    assert j_video_reader.VideoReader(str(junk)).backend == "cv2"


@pytest.mark.parametrize("gray", [False, True], ids=["bgr", "gray"])
def test_native_reader_equals_jax(lib, video, gray):
    got = list(t_video_reader.VideoReader(video, backend="native", gray=gray))
    want = list(j_video_reader.VideoReader(video, backend="native", gray=gray))
    assert len(got) == len(want) == VIDEO_FRAMES
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scrub", [dict(max_frames=2, start=1, stride=2),
                                   dict(max_frames=3, start=9, gray=True),
                                   dict(start=15, stride=3)])
def test_read_frames_seeks_and_equals_jax(lib, video, scrub, monkeypatch):
    """read_frames(start=) opens the native pipe at ``start`` (a container
    seek), and yields what decode-and-skip and the JAX package yield."""
    opened = []
    real = native.NativeFramePipe

    class Recording(real):
        def __init__(self, path, ring=4, start=0, gray=False):
            opened.append(start)
            super().__init__(path, ring=ring, start=start, gray=gray)

    monkeypatch.setattr(native, "NativeFramePipe", Recording)
    got = list(t_video_reader.read_frames(video, **scrub))
    assert scrub["start"] in opened
    want = list(j_video_reader.read_frames(video, **scrub))
    every = list(t_video_reader.VideoReader(video, gray=scrub.get("gray", False)))
    idx = list(range(scrub["start"], VIDEO_FRAMES, scrub.get("stride", 1)))
    idx = idx[: scrub.get("max_frames")]
    assert len(got) == len(want) == len(idx)
    for a, b, i in zip(got, want, idx):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, every[i])
    with pytest.raises(ValueError):
        next(t_video_reader.read_frames(video, stride=0))


def test_read_frames_decodes_and_skips_where_the_seek_fails(lib, video, monkeypatch):
    """A stream the pipe cannot open at ``start`` (fp_open_fmt returns NULL)
    is decoded from zero and skipped: the same frames."""
    real = native.NativeFramePipe

    def no_seek(path, ring=4, start=0, gray=False):
        if start:
            raise RuntimeError("fp_open failed (start)")
        return real(path, ring=ring, start=start, gray=gray)

    want = list(t_video_reader.read_frames(video, max_frames=3, start=11))
    monkeypatch.setattr(native, "NativeFramePipe", no_seek)
    got = list(t_video_reader.read_frames(video, max_frames=3, start=11))
    assert len(got) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_gray_decode_feeds_the_fast_head(lib, video):
    """gray=True decode goes into VideoPipeline(VideoConfig.fast()) as is
    (its fast head takes (H, W) uint8 frames; a third of the bytes) and
    gives the JAX package's results on the JAX decoder's gray frames at
    the slice bar (flow median < 1e-3 px, q99 < 0.02 px; votes within 1%)."""
    from optical_flow_tpu.pipeline.video import VideoPipeline as JVideoPipeline
    from optical_flow_tpu_torch.pipeline.video import VideoPipeline as TVideoPipeline
    from test_torch_slice import _assert_results_close, _configs

    n = 5
    jf, tf = _configs()  # the fast preset, the JAX side's warp pinned to the port's
    frames = list(t_video_reader.read_frames(video, max_frames=n, gray=True))
    assert frames[0].shape == VIDEO_HW and frames[0].dtype == np.uint8
    got = list(TVideoPipeline(tf, device="cpu").run(
        t_video_reader.read_frames(video, max_frames=n, gray=True), prefetch=2))
    pipe = TVideoPipeline(tf, device="cpu")
    pushed = [r for r in (pipe.push(f) for f in frames) if r is not None]
    want = list(JVideoPipeline(jf).run(
        j_video_reader.read_frames(video, max_frames=n, gray=True), prefetch=0))
    assert len(got) == len(pushed) == len(want) == n - 2
    for a, b in zip(got, pushed):
        assert torch.equal(a.u, b.u) and torch.equal(a.v, b.v)
    _assert_results_close(want, got)


# ------------------------------------------------------------ cameras


def test_device_and_pipe_specs_parse_as_jax():
    for spec in (0, "3", "device:1", "/dev/video2", "clip.mp4", "device:x"):
        assert t_video_reader._parse_device_spec(spec) == j_video_reader._parse_device_spec(spec)
    for spec in ("pipe:64x48@10:/tmp/f", "pipe:320x240:/tmp/fifo", "clip.mp4"):
        assert t_video_reader._parse_pipe_spec(spec) == j_video_reader._parse_pipe_spec(spec)
    with pytest.raises(ValueError):
        t_video_reader._parse_pipe_spec("pipe:badgeom:/tmp/f")


def _feed_fifo(path, frames):
    with open(path, "wb") as f:
        for fr in frames:
            f.write(fr.tobytes())


@pytest.mark.parametrize("gray", [False, True], ids=["bgr", "gray"])
def test_fifo_source_yields_frames(tmp_path, gray):
    """A FIFO of rawvideo is a virtual camera: frames arrive bit-exact, with
    the declared geometry, and read_frames scrubs over it."""
    fifo = tmp_path / "cam.fifo"
    os.mkfifo(fifo)
    rng = np.random.RandomState(7)
    shape = (48, 64) if gray else (48, 64, 3)
    frames = [rng.randint(0, 256, size=shape, dtype=np.uint8) for _ in range(6)]
    t = threading.Thread(target=_feed_fifo, args=(fifo, frames))
    t.start()
    try:
        got = list(t_video_reader.read_frames(f"pipe:64x48@10:{fifo}", max_frames=3, stride=2,
                                              gray=gray))
    finally:
        t.join(timeout=30)
    assert not t.is_alive()
    assert len(got) == 3
    for a, b in zip(got, frames[::2]):
        assert a.shape == shape
        np.testing.assert_array_equal(a, b)


def test_camera_falls_back_to_cv2(monkeypatch):
    """With no native camera, a device source lands on cv2.VideoCapture with
    the device index, as the JAX package's does."""
    import cv2

    class FakeCap:
        def __init__(self, idx):
            self.idx = idx

        def get(self, prop):
            return {cv2.CAP_PROP_FRAME_WIDTH: 640, cv2.CAP_PROP_FRAME_HEIGHT: 480,
                    cv2.CAP_PROP_FPS: 30.0}[prop]

        def release(self):
            pass

    def no_camera(*a, **k):
        raise RuntimeError("cam_open failed: no /dev/video0 here")

    monkeypatch.setattr(native, "NativeCamera", no_camera)
    monkeypatch.setattr(cv2, "VideoCapture", FakeCap)
    reader = t_video_reader.VideoReader("device:0")
    assert reader.backend == "cv2" and reader.path == 0
    assert (reader.width, reader.height, reader.fps) == (640, 480, 30.0)


def test_native_camera_missing_device_fails_cleanly(lib):
    """cam_open on a missing device returns NULL -> RuntimeError, no crash;
    an explicit v4l2 backend raises it rather than fall back to cv2."""
    with pytest.raises(RuntimeError, match="cam_open failed"):
        native.NativeCamera("/dev/video99")
    with pytest.raises(RuntimeError, match="cam_open failed"):
        t_video_reader.VideoReader("/dev/video99", backend="v4l2")


def test_camera_reiteration_raises(lib):
    """A closed NativeCamera raises on re-iteration instead of yielding no
    frames (cameras are single-iteration)."""
    cam = native.NativeCamera.__new__(native.NativeCamera)
    cam._lib, cam._h = lib, None
    with pytest.raises(RuntimeError, match="single-iteration"):
        next(iter(cam))


def test_native_v4l2_capture_real_device(lib):
    """Real webcam: a few BGR frames with the negotiated geometry."""
    if not os.path.exists("/dev/video0"):
        pytest.skip("no camera (/dev/video0)")
    with native.NativeCamera("/dev/video0") as cam:
        it = iter(cam)
        for _ in range(3):
            frame = next(it)
            assert frame.shape == (cam.height, cam.width, 3) and frame.dtype == np.uint8
