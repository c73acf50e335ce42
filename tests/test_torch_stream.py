"""The port's per-frame host path against the JAX package: the prefetcher
(io/prefetch.py), the rawvideo reader (io/video_reader.py),
``VideoPipeline.run(prefetch=)``, ``run_chunked`` with its carry and
``replay_video``; and, on the card (``cuda``-marked, skipped here), the
steady steps replayed as CUDA graphs against the eager steps.

Both sides take identical numpy inputs made from a seed; the JAX side runs
on the CPU as its own tests do. Tolerances:

- the port against itself (prefetch on and off, chunked and streaming, a
  CPU mesh and none): bit for bit, the same operations on the same inputs;
- the port against the JAX package: the slice bar, median |dflow| < 1e-3 px
  and q99 < 0.02 px over the interior, votes within 1%
  (tests/test_torch_slice.py);
- decoded frames: bit for bit.
"""

import dataclasses
import os
import threading
import time

import numpy as np
import pytest

import jax  # noqa: F401  (the JAX side runs on the CPU, as its tests do)
import torch

from optical_flow_tpu import config as j_config
from optical_flow_tpu.io.video_reader import VideoReader as JVideoReader
from optical_flow_tpu.io.video_reader import read_frames as j_read_frames
from optical_flow_tpu.pipeline.video import VideoPipeline as JVideoPipeline
from optical_flow_tpu.pipeline.video import replay_video as j_replay_video
from optical_flow_tpu_torch import config as t_config
from optical_flow_tpu_torch import kernels
from optical_flow_tpu_torch.io import video_reader as t_video_reader
from optical_flow_tpu_torch.io.prefetch import (
    pinned_copy,
    prefetch_chunks_to_device,
    prefetch_to_device,
)
from optical_flow_tpu_torch.io.video_reader import VideoReader as TVideoReader
from optical_flow_tpu_torch.io.video_reader import read_frames as t_read_frames
from optical_flow_tpu_torch.kernels import _lib
from optical_flow_tpu_torch.parallel.mesh import flow_mesh
from optical_flow_tpu_torch.pipeline.video import VideoPipeline as TVideoPipeline
from optical_flow_tpu_torch.pipeline.video import replay_video as t_replay_video
from test_torch_slice import _assert_flow_close, _assert_results_close, _configs, _frames

CHUNK_SIZE = 5  # 13 frames: two chunks of 5 and a 3-frame tail


# ------------------------------------------------------------------ helpers


def _chunked_configs(kind, size=96):
    """(JAX, port) configurations for the chunked path. "fast": the fast
    preset with the production warp on both sides; "uint8": the JAX suite's
    chunked configuration (reference mode, faithful uint8 head) without the
    warped-diff feedback. Reference mode's flow is not a displacement: at
    96^2 it reaches 100 px and more, and float32 roundoff between XLA and
    PyTorch then moves q99 past the slice bar on the streaming path too
    (the grays are equal), so the JAX comparison of that mode runs at 48^2,
    as tests/test_torch_reference.py does."""
    gesture = dict(mag_thresh=2.0)
    if kind == "fast":
        jf = j_config.VideoConfig.fast(size=(size, size))
        jf = dataclasses.replace(jf, flow=dataclasses.replace(jf.flow, warp_impl="shift_sep"),
                                 gesture=j_config.GestureConfig(**gesture))
        tf = t_config.VideoConfig.fast(size=(size, size))
        tf = dataclasses.replace(
            tf, flow=dataclasses.replace(tf.flow, impl="cuda", pyr_impl="cuda",
                                         warp_impl="shift_sep"),
            gesture=t_config.GestureConfig(**gesture))
        return jf, tf
    jf = j_config.VideoConfig(preprocess=j_config.PreprocessConfig(size=(size, size)),
                              flow=j_config.FlowConfig(impl="jnp"), faithful_prev_diff=False,
                              gesture=j_config.GestureConfig(**gesture))
    tf = t_config.VideoConfig(preprocess=t_config.PreprocessConfig(size=(size, size)),
                              flow=t_config.FlowConfig(impl="cuda"), faithful_prev_diff=False,
                              gesture=t_config.GestureConfig(**gesture))
    return jf, tf


def _flatten(results):
    """Chunked results (a leading batch axis, or one frame for the tail) as
    one list of (u, v, votes) in numpy, one entry a frame pair."""
    out = []
    for r in results:
        u, v, votes = (np.asarray(x) for x in (r.u, r.v, r.gesture.votes))
        if u.ndim == 3:
            out += [(u[k], v[k], int(votes[k])) for k in range(u.shape[0])]
        else:
            out.append((u, v, int(votes)))
    return out


def _assert_equal_flat(a, b):
    assert len(a) == len(b)
    for (ua, va, na), (ub, vb, nb) in zip(a, b):
        np.testing.assert_array_equal(ua, ub)
        np.testing.assert_array_equal(va, vb)
        assert na == nb


def _assert_close_flat(j, t):
    assert len(j) == len(t)
    for (ju, jv, jn), (tu, tv, tn) in zip(j, t):
        _assert_flow_close(ju, jv, tu, tv)
        assert abs(jn - tn) <= max(1, 0.01 * max(jn, tn)), (jn, tn)


def _write_raw(path, frames):
    with open(path, "wb") as f:
        for fr in frames:
            f.write(np.ascontiguousarray(fr).tobytes())


# ------------------------------------------------------------------ prefetch


def test_prefetch_yields_the_frames_on_the_device_named():
    frames = [np.full((8, 10, 3), i, np.uint8) for i in range(5)]
    got = list(prefetch_to_device(iter(frames), device="cpu"))
    assert len(got) == 5
    for g, f in zip(got, frames):
        assert isinstance(g, torch.Tensor) and g.device == torch.device("cpu")
        np.testing.assert_array_equal(g.numpy(), f)
    got[0][0, 0, 0] = 99  # a copy the consumer owns, not the decoder's buffer
    assert frames[0][0, 0, 0] == 0


def test_prefetch_chunk_timings_tap():
    """Per-chunk producer spans (decode pull, staging and copy) land in the
    caller's list, and the staged chunks are unchanged."""
    frames = [np.full((8, 10), i, np.uint8) for i in range(10)]
    timings = []
    chunks = list(prefetch_chunks_to_device(iter(frames), chunk_size=4, device="cpu",
                                            timings=timings))
    assert [tuple(c.shape) for c in chunks] == [(4, 8, 10), (4, 8, 10), (2, 8, 10)]
    np.testing.assert_array_equal(chunks[1][0].numpy(), frames[4])
    assert len(timings) == 3
    for t in timings:
        assert set(t) == {"decode_s", "put_s"}
        assert t["decode_s"] >= 0 and t["put_s"] >= 0
    # the untimed path stages the same chunks
    chunks2 = list(prefetch_chunks_to_device(iter(frames), chunk_size=4, device="cpu"))
    for a, b in zip(chunks, chunks2):
        assert torch.equal(a, b)


def test_prefetch_forwards_upstream_errors():
    """A decode failure inside the worker re-raises in the consumer, never
    reads as a clean truncated end of stream."""

    def bad_frames():
        yield np.zeros((8, 10), np.uint8)
        raise IOError("decoder exploded mid-stream")

    got = []
    with pytest.raises(IOError, match="decoder exploded"):
        for f in prefetch_to_device(bad_frames(), device="cpu"):
            got.append(f)
    assert len(got) == 1  # the good frame still arrived first

    with pytest.raises(IOError, match="decoder exploded"):
        list(prefetch_chunks_to_device(bad_frames(), chunk_size=4, device="cpu"))

    def instant_fail():
        raise FileNotFoundError("no such video")
        yield  # pragma: no cover

    with pytest.raises(FileNotFoundError):
        list(prefetch_to_device(instant_fail(), device="cpu"))


def test_prefetch_early_consumer_exit_unblocks_worker():
    """Leaving the consumer loop early lets the worker thread exit."""
    released = threading.Event()

    def frames():
        try:
            for i in range(100):
                yield np.full((8, 10), i, np.uint8)
        finally:
            released.set()  # generator closed => worker exited its loop

    before = threading.active_count()
    it = prefetch_to_device(frames(), depth=2, device="cpu")
    next(it)
    it.close()  # early exit (what a consumer `break` does)
    assert released.wait(5.0), "prefetch worker did not unblock"
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before  # no leaked worker


@pytest.mark.parametrize("chunked", [False, True])
def test_prefetch_worker_starts_on_first_next(chunked):
    """Making the generator starts no thread and pulls nothing upstream: a
    generator abandoned before iteration can never be signalled."""
    pulled = threading.Event()

    def frames():
        pulled.set()
        for i in range(4):
            yield np.full((8, 10), i, np.uint8)

    before = threading.active_count()
    it = (prefetch_chunks_to_device(frames(), chunk_size=2, device="cpu") if chunked
          else prefetch_to_device(frames(), device="cpu"))
    time.sleep(0.2)
    assert not pulled.is_set() and threading.active_count() == before
    first = next(it)
    assert pulled.is_set()
    assert int(first.flatten()[0]) == 0
    it.close()


# ------------------------------------------------------------------ run(prefetch=)


def test_run_prefetch_equals_inline_and_matches_jax():
    jf, tf = _configs()
    frames = _frames()
    inline = list(TVideoPipeline(tf, device="cpu").run(frames, prefetch=0))
    staged = list(TVideoPipeline(tf, device="cpu").run(frames, prefetch=2))
    assert len(inline) == len(staged) == len(frames) - 2
    for a, b in zip(inline, staged):
        assert torch.equal(a.u, b.u) and torch.equal(a.v, b.v)
        assert torch.equal(a.gesture.magnitude, b.gesture.magnitude)
        assert int(a.gesture.votes) == int(b.gesture.votes)
    _assert_results_close(list(JVideoPipeline(jf).run(frames, prefetch=0)), staged)


def test_run_early_exit_closes_the_prefetcher():
    _, tf = _configs()
    released = threading.Event()

    def frames():
        try:
            yield from _frames(6)
        finally:
            released.set()

    run = TVideoPipeline(tf, device="cpu").run(frames(), prefetch=2)
    next(run)
    run.close()
    assert released.wait(5.0)


# ------------------------------------------------------------------ run_chunked


@pytest.mark.parametrize("kind,size", [("fast", 96), ("uint8", 48)])
def test_run_chunked_equals_streaming_and_matches_jax(kind, size):
    """Two chunks of 5 and a 3-frame tail: the port's chunked pairs equal its
    streaming ones bit for bit, and JAX's chunked ones at the slice bar."""
    jf, tf = _chunked_configs(kind, size)
    frames = _frames(13)
    stream = list(TVideoPipeline(tf, device="cpu").run(frames, prefetch=0))
    chunked = list(TVideoPipeline(tf, device="cpu").run_chunked(frames, chunk_size=CHUNK_SIZE,
                                                                prefetch=2))
    shapes = [(3, size, size), (5, size, size)] + [(size, size)] * 3
    assert [tuple(r.u.shape) for r in chunked] == shapes
    flat = _flatten(chunked)
    assert len(flat) == len(frames) - 2
    _assert_equal_flat(flat, _flatten(stream))
    jchunked = JVideoPipeline(jf).run_chunked(frames, chunk_size=CHUNK_SIZE, prefetch=1)
    _assert_close_flat(_flatten(jchunked), flat)


def test_run_chunked_inline_equals_prefetched():
    _, tf = _chunked_configs("fast")
    frames = _frames(13)
    a = _flatten(TVideoPipeline(tf, device="cpu").run_chunked(frames, CHUNK_SIZE, prefetch=0))
    b = _flatten(TVideoPipeline(tf, device="cpu").run_chunked(frames, CHUNK_SIZE, prefetch=2))
    _assert_equal_flat(a, b)


def test_run_chunked_exact_multiple_and_short_input():
    """No tail (a multiple of chunk_size) and an input shorter than one
    chunk both give the full count of results."""
    _, tf = _chunked_configs("fast", size=64)
    frames = _frames(8)
    n = len(_flatten(TVideoPipeline(tf, device="cpu").run_chunked(frames, chunk_size=4)))
    assert n == 6
    short = TVideoPipeline(tf, device="cpu").run_chunked(frames[:3], chunk_size=8)
    assert len(_flatten(short)) == 1


def test_run_chunked_requires_batchable_state():
    pipe = TVideoPipeline(t_config.VideoConfig(
        preprocess=t_config.PreprocessConfig(size=(48, 48))), device="cpu")
    assert pipe.config.faithful_prev_diff
    with pytest.raises(ValueError, match="faithful_prev_diff"):
        list(pipe.run_chunked(_frames(6), chunk_size=4))


def test_run_chunked_leaves_resumable_state():
    """After run_chunked over an exact multiple, state() holds the consumed
    frames and push() continues the pair sequence with no second warm-up;
    the state also resumes in a new pipeline."""
    _, tf = _chunked_configs("fast")
    frames = _frames(10)
    pipe = TVideoPipeline(tf, device="cpu")
    list(pipe.run_chunked(frames[:8], chunk_size=4))
    st = pipe.state()
    assert st["frame_idx"] == 8
    assert st["prev_gray"] is not None and st["prev_diff"] is not None
    cont = [pipe.push(f) for f in frames[8:]]
    assert all(r is not None for r in cont)  # no warm-up re-entry at the seam
    full = list(TVideoPipeline(tf, device="cpu").run(frames, prefetch=0))
    for got, want in zip(cont, full[-2:]):
        assert torch.equal(got.u, want.u) and torch.equal(got.v, want.v)
    resumed = TVideoPipeline(tf, device="cpu")
    resumed.restore(st)
    again = [resumed.push(f) for f in frames[8:]]
    for got, want in zip(again, cont):
        assert torch.equal(got.u, want.u) and torch.equal(got.v, want.v)


def test_run_chunked_early_exit_seeds_state():
    """A consumer that leaves after the first chunk finds the state seeded
    from that chunk's carry: push() continues the same pair sequence."""
    _, tf = _chunked_configs("fast")
    frames = _frames(8)
    pipe = TVideoPipeline(tf, device="cpu")
    gen = pipe.run_chunked(frames, chunk_size=4, prefetch=2)
    first = next(gen)
    gen.close()
    assert first.u.shape[0] == 2 and pipe.state()["frame_idx"] == 4
    cont = [pipe.push(f) for f in frames[4:]]
    full = list(TVideoPipeline(tf, device="cpu").run(frames, prefetch=0))
    assert all(r is not None for r in cont)
    for got, want in zip(cont, full[2:]):
        assert torch.equal(got.u, want.u) and torch.equal(got.v, want.v)


def test_run_chunked_on_a_cpu_mesh_equals_unsharded():
    _, tf = _chunked_configs("fast", size=128)
    frames = _frames(13)
    mesh = flow_mesh(1, 2, 2, devices=["cpu"] * 4)
    sharded = _flatten(TVideoPipeline(tf, device="cpu", mesh=mesh).run_chunked(
        frames, chunk_size=CHUNK_SIZE))
    plain = _flatten(TVideoPipeline(tf, device="cpu").run_chunked(frames, chunk_size=CHUNK_SIZE))
    _assert_equal_flat(sharded, plain)


# ------------------------------------------------------------------ reader and replay_video


@pytest.mark.parametrize("gray", [False, True])
def test_pipe_reader_matches_jax(tmp_path, gray):
    rng = np.random.RandomState(7)
    shape = (48, 64) if gray else (48, 64, 3)
    frames = [rng.randint(0, 256, size=shape, dtype=np.uint8) for _ in range(5)]
    path = tmp_path / "frames.raw"
    _write_raw(path, frames)
    spec = f"pipe:64x48@10:{path}"
    reader = TVideoReader(spec, gray=gray)
    assert reader.backend == "pipe"
    assert (reader.width, reader.height, reader.fps) == (64, 48, 10.0)
    got, want = list(reader), list(JVideoReader(spec, gray=gray))
    assert len(got) == len(want) == 5
    for g, w, f in zip(got, want, frames):
        assert g.shape == shape
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, f)


@pytest.mark.parametrize("scrub", [dict(max_frames=2, stride=2), dict(start=3),
                                   dict(start=1, stride=3, max_frames=2)])
def test_read_frames_scrubbing_matches_jax(tmp_path, scrub):
    frames = [np.full((8, 16, 3), i, np.uint8) for i in range(8)]
    path = tmp_path / "frames.raw"
    _write_raw(path, frames)
    spec = f"pipe:16x8:{path}"
    got = [int(f[0, 0, 0]) for f in t_read_frames(spec, **scrub)]
    assert got == [int(f[0, 0, 0]) for f in j_read_frames(spec, **scrub)]
    with pytest.raises(ValueError):
        list(t_read_frames(spec, stride=0))


def test_reader_backends(tmp_path, monkeypatch):
    """'native' and 'v4l2' go through the native host runtime: asked for by
    name they raise where it cannot serve (a file its probe cannot open, a
    missing camera) or, where libav is absent, with the library's reason;
    they never decode elsewhere. 'auto' takes cv2 when neither the native
    probe nor ffmpeg opens the file, and cameras go through cv2 with the
    device index when there is no native camera."""
    from optical_flow_tpu_torch import native

    path = tmp_path / "clip.avi"
    path.write_bytes(b"")
    found = native.load_library() is not None
    with pytest.raises(RuntimeError, match="native probe failed" if found else
                       "native library unavailable: .*libav|native build failed"):
        TVideoReader(str(path), backend="native")
    with pytest.raises(RuntimeError, match="cam_open failed" if found else
                       "native library unavailable"):
        TVideoReader("/dev/video99", backend="v4l2")
    with pytest.raises(FileNotFoundError):
        TVideoReader(str(tmp_path / "missing.avi"))

    import cv2

    class FakeCap:
        def __init__(self, source):
            self.source = source

        def get(self, prop):
            return {cv2.CAP_PROP_FRAME_WIDTH: 640, cv2.CAP_PROP_FRAME_HEIGHT: 480,
                    cv2.CAP_PROP_FPS: 30.0}[prop]

        def release(self):
            pass

    def no_camera(*args, **kwargs):
        raise RuntimeError("cam_open failed: no camera here")

    monkeypatch.setattr(cv2, "VideoCapture", FakeCap)
    monkeypatch.setattr(t_video_reader.shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "NativeCamera", no_camera)
    reader = TVideoReader(str(path))
    assert reader.backend == "cv2" and (reader.width, reader.height) == (640, 480)
    camera = TVideoReader("device:0")
    assert camera.backend == "cv2" and camera.path == 0


@pytest.mark.parametrize("gray", [False, True])
def test_cv2_reader_matches_jax(tmp_path, gray):
    import cv2

    path = str(tmp_path / "clip.avi")
    rng = np.random.RandomState(5)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (64, 48))
    if not writer.isOpened():
        pytest.fail("cv2 cannot write an MJPG clip here")
    for _ in range(4):
        writer.write(rng.randint(0, 256, size=(48, 64, 3), dtype=np.uint8))
    writer.release()
    got = list(TVideoReader(path, backend="cv2", gray=gray))
    want = list(JVideoReader(path, backend="cv2", gray=gray))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_replay_video_matches_jax(tmp_path):
    jf, tf = _configs()
    frames = _frames(7)
    path = tmp_path / "frames.raw"
    _write_raw(path, frames)
    spec = f"pipe:128x72:{path}"
    got = t_replay_video(spec, tf, max_frames=6, device="cpu")
    want = j_replay_video(spec, jf, max_frames=6)
    assert len(got) == len(want) == 4
    _assert_results_close(want, got)
    inline = list(TVideoPipeline(tf, device="cpu").run(frames[:6], prefetch=0))
    for a, b in zip(got, inline):
        assert torch.equal(a.u, b.u) and torch.equal(a.v, b.v)


# ------------------------------------------------------------------ launch counts


def test_captured_launches_are_tallied_apart():
    """Launches captured into a graph go to the graph's tally, and each
    replay adds that tally to the counters."""
    kernels.reset_launch_counts()
    with _lib.captured_launches() as tally:
        assert _lib._capture.tally is tally and set(tally) == set(_lib.launches)
    assert _lib._capture.tally is None
    _lib.add_launches({"oft_lk": 1, "oft_pyramid": 2})
    _lib.add_launches({"oft_lk": 1, "oft_pyramid": 2})
    counts = kernels.launch_counts()
    assert counts["oft_lk"] == 2 and counts["oft_pyramid"] == 4
    kernels.reset_launch_counts()


# ---------------------------------------------------- on the card (marked)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _card_configs(size=270):
    fast = t_config.VideoConfig.fast(size=(size, size))
    ref = t_config.VideoConfig(preprocess=t_config.PreprocessConfig(size=(size, size)))
    return {"fast": fast, "reference": ref}


def _card_frames(n=8):
    return list(_frames(n, hw=(180, 320)))


def _assert_same(a, b):
    assert torch.equal(a.u, b.u) and torch.equal(a.v, b.v)
    assert torch.equal(a.gesture.magnitude, b.gesture.magnitude)
    assert torch.equal(a.gesture.votes, b.gesture.votes)
    assert torch.equal(a.gesture.cx, b.gesture.cx) and torch.equal(a.gesture.cy, b.gesture.cy)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fast", "reference"])
def test_graph_push_equals_eager_on_card(cuda_device, kind):
    """Frames 1-2 warm up, frame 3 runs eagerly and is captured, 4-8 replay:
    bit for bit with graph=False, and the same launch counts."""
    cfg, frames = _card_configs()[kind], _card_frames()
    counts, results = {}, {}
    for graph in (False, True):
        kernels.reset_launch_counts()
        pipe = TVideoPipeline(cfg, device=cuda_device, graph=graph)
        results[graph] = [pipe.push(f) for f in frames][2:]
        torch.cuda.synchronize()
        counts[graph] = kernels.launch_counts()
        assert pipe.graph == graph and len(pipe._graphs) == int(graph)
    assert counts[True] == counts[False]
    assert counts[True]["oft_lk"] > 0
    for a, b in zip(results[True], results[False]):
        _assert_same(a, b)


@pytest.mark.cuda
def test_graph_results_kept_across_frames_do_not_change(cuda_device):
    cfg, frames = _card_configs()["fast"], _card_frames()
    pipe = TVideoPipeline(cfg, device=cuda_device)
    kept = [pipe.push(f) for f in frames][2:]
    copies = [(r.u.clone(), r.v.clone(), r.gesture.magnitude.clone()) for r in kept]
    for f in frames:  # more replays over the same buffers
        pipe.push(f)
    torch.cuda.synchronize()
    for r, (u, v, m) in zip(kept, copies):
        assert torch.equal(r.u, u) and torch.equal(r.v, v) and torch.equal(r.gesture.magnitude, m)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fast", "reference"])
def test_graph_state_restore_mid_stream_on_card(cuda_device, kind):
    cfg, frames = _card_configs()[kind], _card_frames()
    pipe = TVideoPipeline(cfg, device=cuda_device)
    for f in frames[:5]:
        pipe.push(f)
    st = pipe.state()
    rest = [pipe.push(f) for f in frames[5:]]
    fresh = TVideoPipeline(cfg, device=cuda_device)
    fresh.restore(st)
    again = [fresh.push(f) for f in frames[5:]]
    pipe.restore(st)  # and back into the pipeline whose graph holds other state
    third = [pipe.push(f) for f in frames[5:]]
    for a, b, c in zip(rest, again, third):
        _assert_same(a, b)
        _assert_same(a, c)


@pytest.mark.cuda
def test_run_chunked_on_card(cuda_device):
    """The chunk step eagerly (first run, captured) and replayed (second
    run) give the same results bit for bit; against streaming, the slice
    bar (cuBLAS may pick another GEMM for a batch)."""
    cfg, frames = _card_configs()["fast"], _card_frames(12)
    pipe = TVideoPipeline(cfg, device=cuda_device)
    first = _flatten_card(pipe.run_chunked(frames, chunk_size=CHUNK_SIZE))
    second = _flatten_card(pipe.run_chunked(frames, chunk_size=CHUNK_SIZE))
    stream = list(TVideoPipeline(cfg, device=cuda_device, graph=False).run(frames))
    assert len(first) == len(second) == len(stream) == 10
    for a, b, s in zip(first, second, stream):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        _assert_flow_close(s.u.cpu(), s.v.cpu(), a[0].cpu(), a[1].cpu())


def _flatten_card(results):
    out = []
    for r in results:
        out += list(zip(r.u, r.v)) if r.u.ndim == 3 else [(r.u, r.v)]
    return out


@pytest.mark.cuda
def test_prefetch_to_card(cuda_device):
    frames = [np.random.RandomState(k).randint(0, 256, (36, 64, 3), dtype=np.uint8)
              for k in range(6)]
    assert pinned_copy(frames[0]).is_pinned()
    got = list(prefetch_to_device(iter(frames), device=cuda_device))
    chunks = list(prefetch_chunks_to_device(iter(frames), chunk_size=4, device=cuda_device))
    torch.cuda.synchronize()
    assert all(g.device == cuda_device for g in got + chunks)
    for g, f in zip(got, frames):
        np.testing.assert_array_equal(g.cpu().numpy(), f)
    np.testing.assert_array_equal(torch.cat(chunks).cpu().numpy(), np.stack(frames))


@pytest.mark.cuda
def test_run_prefetch_on_card_equals_inline(cuda_device):
    cfg, frames = _card_configs()["fast"], _card_frames()
    a = list(TVideoPipeline(cfg, device=cuda_device).run(frames, prefetch=2))
    b = list(TVideoPipeline(cfg, device=cuda_device).run(frames, prefetch=0))
    for x, y in zip(a, b):
        _assert_same(x, y)


def test_pipe_reader_reads_a_fifo(tmp_path):
    fifo = tmp_path / "cam.fifo"
    os.mkfifo(fifo)
    frames = [np.full((8, 16, 3), i, np.uint8) for i in range(4)]
    t = threading.Thread(target=_write_raw, args=(fifo, frames))
    t.start()
    try:
        got = list(t_read_frames(f"pipe:16x8:{fifo}"))
    finally:
        t.join(timeout=10)
    assert not t.is_alive()
    assert [int(f[0, 0, 0]) for f in got] == [0, 1, 2, 3]
