"""The port's serving layer (optical_flow_tpu_torch/pipeline/serve.py)
against its direct pipeline and against the JAX package's server.

Counterparts of tests/test_serve.py at its sizes (60x80 BGR frames, 48x64
processing), run against the port's server with ``device="cpu"``: every
served result equals the port's ``VideoPipeline`` pushed directly on the
same frames bit for bit (flows as float32 bits, votes, detected, cx, cy).
The fast and faithful streams also meet JAX's direct pipeline at the slice
bar (median |dflow| < 1e-3 px, q99 < 0.02 px over the interior, votes
within 1%; tests/test_torch_slice.py), and so do a JAX ``FlowClient``
against the port's server and the port's client against JAX's server:
wire protocol version 1 is the same bytes in both packages.

Frames: tests/test_serve.py's own (uniform noise rolled 2 px a frame)
where its tests are ported, and the slice tests' textured frames (a patch
moving (+3, +2) px over a textured background, tests/test_torch_slice.py).
The fast stream is held to JAX on both. On noise the bar is held over the
pixels whose 2x2 LK system is well conditioned: there the two packages'
diff pyramids, which differ by their preprocessing's float32 roundoff,
give flows that part past the bar at weakly conditioned pixels, in
float64 as in float32 (test_noise_stream_meets_jax_where_well_conditioned
shows both). The faithful stream is held to JAX on test_serve's frames:
reference mode feeds its warped diff back, and on the textured frames at
48x64 the packages' roundoff grows through that feedback past the bar
(ROADMAP Queue 3, reference mode).
"""

import dataclasses
import json
import os
import socket
import struct
import threading
import warnings

import numpy as np
import pytest
import torch

from optical_flow_tpu import config as j_config
from optical_flow_tpu.pipeline import serve as j_serve
from optical_flow_tpu.pipeline.video import VideoPipeline as JVideoPipeline
from optical_flow_tpu_torch import config as t_config
from optical_flow_tpu_torch.flow.coarse_to_fine import coarse_to_fine_pyramids
from optical_flow_tpu_torch.ops.gradients import spatio_temporal_gradients
from optical_flow_tpu_torch.ops.window import sum3x3_interior
from optical_flow_tpu_torch.parallel import sharded_flow
from optical_flow_tpu_torch.parallel.mesh import flow_mesh
from optical_flow_tpu_torch.pipeline.serve import (
    MAX_PROC_DIM,
    FlowClient,
    FlowServer,
    _make_config,
    _PipelinePool,
)
from optical_flow_tpu_torch.pipeline.video import VideoPipeline as TVideoPipeline
from optical_flow_tpu_torch.utils.device import host_array
from test_torch_slice import _assert_flow_close
from test_torch_slice import _frames as _textured

H, W = 60, 80  # capture shape
PROC = (48, 64)  # processing shape


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread keeps them from spinning against
    the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n, seed=3):
    """tests/test_serve.py's frames: uniform noise rolled 2 px a frame."""
    r = np.random.RandomState(seed)
    base = (r.rand(H, W, 3) * 255).astype(np.uint8)
    return [np.roll(base, shift=2 * i, axis=1) for i in range(n)]


def _textured_frames(n, seed=3, hw=(H, W)):
    return list(_textured(n, seed=seed, hw=hw))


def _port_config(preset):
    if preset == "fast":
        return t_config.VideoConfig.fast(size=PROC)
    return t_config.VideoConfig(preprocess=t_config.PreprocessConfig(size=PROC))


def _jax_config(preset):
    if preset == "fast":
        return j_config.VideoConfig.fast(size=PROC)
    return j_config.VideoConfig(preprocess=j_config.PreprocessConfig(size=PROC),
                                flow=j_config.FlowConfig())


def _direct(frames, preset="fast"):
    pipe = TVideoPipeline(_port_config(preset), device="cpu")
    return [r for f in frames for r in [pipe.push(f)] if r is not None]


def _jax_direct(frames, preset="fast"):
    pipe = JVideoPipeline(_jax_config(preset))
    return [r for f in frames for r in [pipe.push(f)] if r is not None]


@pytest.fixture(scope="module")
def server():
    srv = FlowServer(port=0, device="cpu")
    srv.start_background()
    yield srv
    srv.shutdown()


def _stream(client, frames, **kw):
    hello = client.start_stream(H, W, proc_size=PROC, **kw)
    assert hello["ok"], hello
    replies = [client.push(f) for f in frames]
    tail = client.end_stream()
    return hello, replies, tail


def _assert_reply_is(reply, res, flow=True):
    """A served reply equals a direct result bit for bit."""
    g = res.gesture
    assert reply["votes"] == int(g.votes)
    assert reply["detected"] == bool(g.detected)
    assert reply["cx"] == float(g.cx) and reply["cy"] == float(g.cy)
    if flow:
        for name, got in (("u", reply["u"]), ("v", reply["v"])):
            want = np.asarray(host_array(getattr(res, name)), np.float32)
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32), err_msg=name)


def _assert_replies_meet_jax(replies, jres):
    """Served flows and votes against JAX's direct results at the slice bar."""
    assert len(replies) == len(jres)
    for reply, jr in zip(replies, jres):
        _assert_flow_close(jr.u, jr.v, reply["u"], reply["v"])
        a, b = int(jr.gesture.votes), reply["votes"]
        assert abs(a - b) <= max(1, 0.01 * max(a, b)), (a, b)


def test_roundtrip_matches_direct_pipeline(server):
    frames = _textured_frames(6)
    with FlowClient(server.address) as c:
        _, replies, tail = _stream(c, frames, preset="fast", return_flow=True)
    assert [r.get("warmup", False) for r in replies] == [True, True] + [False] * 4
    assert [r["frame"] for r in replies] == list(range(6))
    assert tail == {"end": True, "frames": 6}
    direct = _direct(frames, preset="fast")
    assert len(direct) == 4
    for reply, res in zip(replies[2:], direct):
        _assert_reply_is(reply, res)
    _assert_replies_meet_jax(replies[2:], _jax_direct(frames, preset="fast"))


def test_second_stream_reuses_pooled_pipeline(server):
    frames = _frames(5, seed=11)
    with FlowClient(server.address) as c:
        hello1, replies1, _ = _stream(c, frames, preset="fast")
        # same connection, new handshake: state must reset (warmups again)
        hello2, replies2, _ = _stream(c, frames, preset="fast")
    assert hello2["pooled"]  # the built pipeline came back from the pool
    assert [r.get("warmup", False) for r in replies2] == [
        r.get("warmup", False) for r in replies1
    ]
    for a, b in zip(replies1, replies2):
        assert a == b  # identical stream -> identical replies
    for reply, res in zip(replies1[2:], _direct(frames)):
        _assert_reply_is(reply, res, flow=False)


def test_concurrent_connections_are_isolated(server):
    frames_a = _frames(6, seed=21)
    frames_b = _frames(6, seed=22)
    results = {}

    def run(name, frames):
        with FlowClient(server.address) as c:
            _, replies, _ = _stream(c, frames, preset="fast", return_flow=True)
        results[name] = replies

    ta = threading.Thread(target=run, args=("a", frames_a))
    tb = threading.Thread(target=run, args=("b", frames_b))
    ta.start(), tb.start()
    ta.join(120), tb.join(120)
    assert not ta.is_alive() and not tb.is_alive()
    assert set(results) == {"a", "b"}
    for name, frames in (("a", frames_a), ("b", frames_b)):
        direct = _direct(frames, preset="fast")
        assert len(results[name][2:]) == len(direct) == 4
        for reply, res in zip(results[name][2:], direct):
            _assert_reply_is(reply, res)


def test_faithful_preset_matches_direct(server):
    frames = _frames(5, seed=31)
    with FlowClient(server.address) as c:
        _, replies, _ = _stream(c, frames, preset="faithful", return_flow=True)
    direct = _direct(frames, preset="faithful")
    assert len(direct) == 3
    for reply, res in zip(replies[2:], direct):
        _assert_reply_is(reply, res)
    _assert_replies_meet_jax(replies[2:], _jax_direct(frames, preset="faithful"))


def test_bad_handshake_is_reported(server):
    with socket.create_connection(server.address, timeout=30) as s:
        s.sendall(b'{"height": "nope"}\n')
        line = s.makefile("rb").readline()
    resp = json.loads(line)
    assert resp["ok"] is False and "error" in resp


def test_wrong_frame_length_is_reported(server):
    with FlowClient(server.address) as c:
        hello = c.start_stream(H, W, proc_size=PROC)
        assert hello["ok"]
        resp = c.push(np.zeros((H, W + 2, 3), np.uint8))  # wrong width
    assert resp["ok"] is False and "expected" in resp["error"]


def test_wrong_frame_length_closes_connection_cleanly(server):
    """After the error reply the server closes the connection instead of
    re-entering the handshake loop on the closed socket."""
    with socket.create_connection(server.address, timeout=30) as s:
        hs = {"v": 1, "height": H, "width": W, "channels": 3,
              "proc_height": PROC[0], "proc_width": PROC[1]}
        s.sendall(json.dumps(hs).encode() + b"\n")
        f = s.makefile("rb")
        assert json.loads(f.readline())["ok"]
        s.sendall(struct.pack(">I", 12) + b"x" * 12)  # wrong length
        assert json.loads(f.readline())["ok"] is False
        # connection is done: reads drain to EOF, no further handshake
        assert f.read() == b""


def test_negative_dims_rejected_in_handshake(server):
    """-2 x -2 x 1 multiplies to a positive frame size; each dimension is
    validated alone so the reply is the normal error JSON."""
    for hs in (
        {"v": 1, "height": -2, "width": -2, "channels": 1},
        {"v": 1, "height": H, "width": W, "proc_height": -4, "proc_width": 4},
    ):
        with socket.create_connection(server.address, timeout=30) as s:
            s.sendall(json.dumps(hs).encode() + b"\n")
            resp = json.loads(s.makefile("rb").readline())
        assert resp["ok"] is False and "error" in resp


def test_unix_socket_roundtrip(tmp_path):
    if not hasattr(socket, "AF_UNIX"):
        pytest.skip("no AF_UNIX on this platform")
    path = os.path.join(tmp_path, "flow.sock")
    srv = FlowServer(unix_path=path, device="cpu")
    srv.start_background()
    try:
        frames = _frames(4, seed=41)
        with FlowClient(path) as c:
            _, replies, tail = _stream(c, frames, preset="fast")
        assert tail["frames"] == 4
        assert not replies[-1].get("warmup", False)
        for reply, res in zip(replies[2:], _direct(frames)):
            _assert_reply_is(reply, res, flow=False)
    finally:
        srv.shutdown()


def test_huge_proc_dims_rejected(server):
    """Handshake proc dims are bounded: an unbounded client value would
    exhaust the server's memory through the dense resize matrices."""
    hs = {"v": 1, "height": 16, "width": 16, "channels": 1,
          "proc_height": MAX_PROC_DIM + 1, "proc_width": 65536}
    with socket.create_connection(server.address, timeout=30) as s:
        s.sendall(json.dumps(hs).encode() + b"\n")
        resp = json.loads(s.makefile("rb").readline())
    assert resp["ok"] is False and "proc dims" in resp["error"]


# ------------------------------------------------ across the two packages


def test_jax_client_against_port_server(server):
    """JAX's FlowClient speaks to the port's server: its flows and votes
    meet JAX's own direct pipeline at the slice bar, and equal the port's
    direct pipeline bit for bit."""
    frames = _textured_frames(5, seed=3)
    with j_serve.FlowClient(server.address) as c:
        hello = c.start_stream(H, W, proc_size=PROC, preset="fast", return_flow=True)
        assert hello == {"ok": True, "pooled": hello["pooled"]}
        replies = [c.push(f) for f in frames]
        assert c.end_stream() == {"end": True, "frames": 5}
    for reply, res in zip(replies[2:], _direct(frames)):
        _assert_reply_is(reply, res)
    _assert_replies_meet_jax(replies[2:], _jax_direct(frames))


def test_port_client_against_jax_server():
    """The port's FlowClient speaks to JAX's server: what it receives
    equals JAX's direct pipeline bit for bit and meets the port's direct
    pipeline at the slice bar."""
    srv = j_serve.FlowServer(port=0)
    srv.start_background()
    try:
        frames = _textured_frames(5, seed=3)
        with FlowClient(srv.address) as c:
            _, replies, tail = _stream(c, frames, preset="fast", return_flow=True)
    finally:
        srv.shutdown()
    assert tail == {"end": True, "frames": 5}
    jres = _jax_direct(frames)
    for reply, jr in zip(replies[2:], jres):
        assert reply["votes"] == int(jr.gesture.votes)
        np.testing.assert_array_equal(reply["u"], np.asarray(jr.u, np.float32))
        np.testing.assert_array_equal(reply["v"], np.asarray(jr.v, np.float32))
    tres = _direct(frames)
    for reply, tr in zip(replies[2:], tres):
        _assert_flow_close(tr.u, tr.v, reply["u"], reply["v"])


def test_jax_impl_names_in_the_handshake(server):
    """The JAX package's impl names are read as the port's: "pallas" is
    "cuda" and "jnp" is "torch", so a stream named either way shares the
    other's pooled pipeline; an unknown name is refused."""
    assert _make_config("fast", PROC, "pallas") == _make_config("fast", PROC, "cuda")
    assert _make_config("fast", PROC, "jnp") == t_config.video_config_for("fast", PROC, "torch")
    assert _make_config("fast", PROC, "pallas").flow.impl == "cuda"
    assert _make_config("faithful", PROC, "jnp").flow.impl == "torch"
    # only impl differs from the preset
    fast = t_config.VideoConfig.fast(size=PROC)
    got = _make_config("fast", PROC, "jnp")
    assert got.flow.impl == "torch" and got.preprocess == fast.preprocess
    assert (got.flow.mode, got.flow.pyr_impl, got.flow.warp_clamp) == (
        fast.flow.mode, fast.flow.pyr_impl, fast.flow.warp_clamp)
    frames = _frames(3, seed=51)
    for first, second in (("pallas", "cuda"), ("jnp", "torch")):
        with FlowClient(server.address) as c:
            h1, r1, _ = _stream(c, frames, preset="fast", impl=first)
            h2, r2, _ = _stream(c, frames, preset="fast", impl=second)
        assert h2["pooled"] and r1 == r2, (first, second)
    with FlowClient(server.address) as c:
        resp = c.start_stream(H, W, proc_size=PROC, impl="mxu")
    assert resp["ok"] is False and "impl" in resp["error"]


def _conditioning(img1, img2):
    """lambda_min / lambda_max of the 2x2 LK system (the 3x3 window sums of
    fx^2, fy^2, fx fy) of the pair, per pixel, in float64."""
    fx, fy, _ = spatio_temporal_gradients(img1.double(), img2.double())
    a, b, c = sum3x3_interior(torch.stack([fx * fx, fy * fy, fx * fy])).numpy()
    half_tr, disc = (a + b) / 2, np.sqrt((a - b) ** 2 / 4 + c * c)
    return (half_tr - disc) / np.maximum(half_tr + disc, 1e-30)


def _q99(d):
    return float(np.quantile(d, 0.99))


def test_noise_stream_meets_jax_where_well_conditioned(server):
    """test_serve's noise frames through the fast preset, served: equal to
    the port's direct pipeline bit for bit, and to JAX's at the slice bar
    over the interior pixels whose 2x2 LK system at the finest level is
    well conditioned (lambda_min / lambda_max >= 1e-2). Why not over all
    of them: the two packages' diff pyramids differ by their
    preprocessing's float32 roundoff (nonzero, below 1e-3), and where the
    system is weak the flow parts past the bar; it does in float64 too
    (the port's plain controller on each package's pyramids), so the
    parting comes from the inputs, not from float32 arithmetic alone."""
    frames = _frames(6)
    with FlowClient(server.address) as c:
        _, replies, _ = _stream(c, frames, preset="fast", return_flow=True)
    tpipe = TVideoPipeline(_port_config("fast"), device="cpu")
    jpipe = JVideoPipeline(_jax_config("fast"))
    plain64 = dataclasses.replace(_port_config("fast").flow, impl="torch")
    inner = (slice(8, -8), slice(8, -8))
    n, q99_all, q99_f64, pyr_diff = 0, [], [], []
    for reply, f in zip(replies, frames):
        tprev, jprev = tpipe._prev_pyr, jpipe._prev_pyr
        res, jres = tpipe.push(f), jpipe.push(f)
        if res is None:
            continue
        n += 1
        _assert_reply_is(reply, res)
        jcur = [torch.from_numpy(np.array(p)) for p in jpipe._prev_pyr]
        pyr_diff.append(max(float((a - b).abs().max()) for a, b in zip(tpipe._prev_pyr, jcur)))
        d = np.hypot(reply["u"] - np.asarray(jres.u), reply["v"] - np.asarray(jres.v))[inner]
        well = (_conditioning(tprev[0], tpipe._prev_pyr[0]) >= 1e-2)[inner]
        assert well.mean() > 0.8, well.mean()
        assert np.median(d[well]) < 1e-3, np.median(d[well])
        assert _q99(d[well]) < 0.02, _q99(d[well])
        q99_all.append(_q99(d))
        # float64 from each package's own diff pyramids
        jprev = [torch.from_numpy(np.array(p)) for p in jprev]
        (tu, tv), (ju, jv) = (
            coarse_to_fine_pyramids(tuple(p.double() for p in prev), tuple(p.double() for p in cur),
                                    config=plain64)[:2]
            for prev, cur in ((tprev, tpipe._prev_pyr), (jprev, jcur)))
        q99_f64.append(_q99(torch.hypot(tu - ju, tv - jv).numpy()[inner]))
    assert n == 4
    assert 0 < max(pyr_diff) < 1e-3, pyr_diff
    # over every interior pixel the packages part past the bar on a frame,
    # and in float64 from their pyramids they part too
    assert max(q99_all) > 0.02 and max(q99_f64) > 1e-3, (q99_all, q99_f64)


def test_mesh_server_equals_unsharded_server(server, monkeypatch):
    """FlowServer(mesh=): each stream's flow tiled over a 2x2 mesh of the
    CPU (the 128^2 and 64^2 levels tile) equals the unsharded server's bit
    for bit, reply for reply."""
    tiled = []
    solve = sharded_flow.sharded_lucas_kanade
    monkeypatch.setattr(sharded_flow, "sharded_lucas_kanade",
                        lambda *a, **kw: tiled.append(1) or solve(*a, **kw))
    proc = (128, 128)
    frames = _frames(5, seed=71)
    mesh = flow_mesh(1, 2, 2, devices=["cpu"] * 4)
    msrv = FlowServer(port=0, device="cpu", mesh=mesh)
    msrv.start_background()
    try:
        with FlowClient(msrv.address) as c:
            hello = c.start_stream(H, W, proc_size=proc, return_flow=True)
            got = [c.push(f) for f in frames]
            assert c.end_stream() == {"end": True, "frames": 5}
        ((pipe,),) = msrv.pool._free.values()
    finally:
        msrv.shutdown()
    assert hello == {"ok": True, "pooled": False} and pipe.mesh is mesh and tiled
    with FlowClient(server.address) as c:
        c.start_stream(H, W, proc_size=proc, return_flow=True)
        want = [c.push(f) for f in frames]
        c.end_stream()
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if k in ("u", "v"):
                np.testing.assert_array_equal(g[k].view(np.uint32), w[k].view(np.uint32))
            else:
                assert g[k] == w[k], k


def test_pool_caps_its_free_list():
    pool = _PipelinePool()
    made = []

    class _Pipe:
        def reset(self):
            pass

    pipes = [pool.acquire("k", lambda: made.append(1) or _Pipe()) for _ in range(6)]
    assert [p[1] for p in pipes] == [False] * 6 and len(made) == 6
    for p, _ in pipes:
        pool.release("k", p)
    assert len(pool._free["k"]) == _PipelinePool.MAX_FREE_PER_KEY == 4
    assert pool.acquire("k", _Pipe)[1] is True


def test_read_only_frames_are_copied_not_wrapped():
    """The server hands the pipeline a read-only view of the socket
    payload; the upload copies it (no warning, the payload untouched)."""
    frames = _frames(3, seed=61)
    payloads = [f.tobytes() for f in frames]
    pipe = TVideoPipeline(_port_config("fast"), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = [pipe.push(np.frombuffer(p, np.uint8).reshape(H, W, 3)) for p in payloads]
    assert got[-1] is not None
    assert [p == f.tobytes() for p, f in zip(payloads, frames)] == [True] * 3
    want = _direct(frames)
    np.testing.assert_array_equal(got[-1].u.numpy(), want[0].u.numpy())


# ----------------------------------------------------- on the card (marked)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("preset,proc", [("fast", (1080, 1080)), ("faithful", (256, 256))])
def test_served_stream_on_card_equals_direct_push(cuda_device, preset, proc):
    """A served stream of 720x1280 frames on the card (fast at full width,
    faithful at the protocol's default size; the steady step captured as a
    CUDA graph at the third frame) equals the port's pipeline pushed
    directly on the card, bit for bit; a second stream is pooled, replays
    the first one's graph (no new capture) and launches what the direct
    run launches."""
    from optical_flow_tpu_torch import kernels

    frames = _textured_frames(6, seed=7, hw=(720, 1280))
    hs = dict(preset=preset, proc_size=proc, return_flow=True)
    srv = FlowServer(port=0)
    srv.start_background()
    try:
        with FlowClient(srv.address) as c:
            assert c.start_stream(720, 1280, **hs) == {"ok": True, "pooled": False}
            first = [c.push(f) for f in frames]
            c.end_stream()
            (pipe,) = [p for free in srv.pool._free.values() for p in free]
            graphs = dict(pipe._graphs)
            kernels.reset_launch_counts()
            assert c.start_stream(720, 1280, **hs) == {"ok": True, "pooled": True}
            second = [c.push(f) for f in frames]
            served = kernels.launch_counts()
            assert c.end_stream() == {"end": True, "frames": 6}
    finally:
        srv.shutdown()
    assert len(graphs) == 1 and all(pipe._graphs[k] is g for k, g in graphs.items())
    assert pipe._graphs.keys() == graphs.keys()
    kernels.reset_launch_counts()
    direct = TVideoPipeline(_make_config(preset, proc, "auto"), device=cuda_device)
    want = [r for f in frames for r in [direct.push(f)] if r is not None]
    assert kernels.launch_counts() == served and served["oft_lk"] == 4 * (7 if preset == "faithful" else 1)
    for replies in (first, second):
        assert [r.get("warmup", False) for r in replies] == [True, True, False, False, False, False]
        for reply, res in zip(replies[2:], want):
            _assert_reply_is(reply, res)
