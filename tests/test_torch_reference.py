"""The reference-parity configuration ``VideoConfig()`` of the port against
the JAX package: the faithful uint8 preprocess chain stage by stage, the
reference-mode controller (``pyr_up`` between levels, S1 on the kernel
route), the pipeline end to end with the warped diff fed back, and the
streaming state carried over. Also the entry points' default device.

Both sides take identical numpy inputs made from a seed. Tolerances:

- uint8 stages: max |diff| <= 1 with at most ``U8_SHARE`` of the values
  differing. XLA's CPU matmul and PyTorch's sum the resize in different
  orders, so a value at a rounding tie may land one apart; the other
  stages are elementwise in the same order and agree exactly on the same
  input.
- flows: median < 1e-3 px and q99 < 0.02 px over the interior, votes
  within 1% (tests/test_torch_slice.py).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from optical_flow_tpu import config as j_config
from optical_flow_tpu.flow.coarse_to_fine import coarse_to_fine_with_images as j_c2f_images
from optical_flow_tpu.ops.pyramid import pyr_up as j_pyr_up
from optical_flow_tpu.pipeline import preprocess as j_pre
from optical_flow_tpu.pipeline.video import VideoPipeline as JVideoPipeline
from optical_flow_tpu_torch import config as t_config
from optical_flow_tpu_torch import kernels
from optical_flow_tpu_torch.convert import pipeline_state_from_jax, video_config_from_jax
from optical_flow_tpu_torch.flow.coarse_to_fine import coarse_to_fine_with_images as t_c2f_images
from optical_flow_tpu_torch.kernels.pyrup_kernel import pyr_up_pair_cuda, pyr_up_pair_plain
from optical_flow_tpu_torch.parallel.mesh import flow_mesh
from optical_flow_tpu_torch.pipeline import preprocess as t_pre
from optical_flow_tpu_torch.io.prefetch import prefetch_chunks_to_device, prefetch_to_device
from optical_flow_tpu_torch.pipeline.video import VideoPipeline as TVideoPipeline
from optical_flow_tpu_torch.pipeline.video import replay_video
from test_torch_slice import _assert_flow_close, _assert_results_close, _frames, _np, _t

U8_SHARE = 1e-3  # share of uint8 values allowed one apart (resize: 0 at 48^2, 2.6e-6 at 1080^2)
SIZE = 48


def _u8(x):
    return np.asarray(x).astype(np.int32)


def _assert_u8_close(got, want):
    d = np.abs(_u8(got) - _u8(want))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= U8_SHARE, (d > 0).mean()


def _big_frame():
    return _frames(1, seed=11, hw=(720, 1280))[0]


def _configs(size=SIZE, **flow):
    jc = j_config.VideoConfig(preprocess=j_config.PreprocessConfig(size=(size, size)))
    tc = t_config.VideoConfig(preprocess=t_config.PreprocessConfig(size=(size, size)),
                              flow=t_config.FlowConfig(**flow))
    return jc, tc


# --------------------------------------------------- the faithful uint8 chain


@pytest.mark.parametrize("frame", ["72x128", "720x1280"])
def test_faithful_chain_stages_match_jax(frame):
    """Each stage fed JAX's own input of that stage."""
    f = _frames(2)[1] if frame == "72x128" else _big_frame()
    size = (SIZE, SIZE) if frame == "72x128" else (1080, 1080)
    jr = j_pre.resize_cubic(jnp.asarray(f), size)
    tr = t_pre.resize_cubic(torch.from_numpy(f), size)
    assert tr.dtype == torch.uint8 and tuple(tr.shape) == size + (3,)
    _assert_u8_close(tr.numpy(), jr)
    jr = np.array(jr)
    jb = j_pre.gaussian_blur(jnp.asarray(jr), 9, 1.5)
    tb = t_pre.gaussian_blur(torch.from_numpy(jr), 9, 1.5)
    assert tb.dtype == torch.uint8
    _assert_u8_close(tb.numpy(), jb)
    jb = np.array(jb)
    np.testing.assert_array_equal(t_pre.bgr_to_gray(torch.from_numpy(jb)).numpy(),
                                  np.asarray(j_pre.bgr_to_gray(jnp.asarray(jb))))
    cfg_j = j_config.PreprocessConfig(size=size)
    cfg_t = t_config.PreprocessConfig(size=size)
    tg = t_pre.preprocess_frame(torch.from_numpy(f), cfg_t)
    assert tg.dtype == torch.uint8 and tuple(tg.shape) == size
    _assert_u8_close(tg.numpy(), j_pre.preprocess_frame(jnp.asarray(f), cfg_j))


def test_faithful_chain_float_and_batched_frames():
    """A float frame stays float through the faithful head, and a batch of
    frames gives the frames' grays one by one."""
    frames = _frames(3)
    cfg_j, cfg_t = j_config.PreprocessConfig(size=(SIZE, SIZE)), t_config.PreprocessConfig(
        size=(SIZE, SIZE))
    batch = t_pre.preprocess_frame(torch.from_numpy(frames), cfg_t)
    for k, f in enumerate(frames):
        np.testing.assert_array_equal(batch[k].numpy(),
                                      t_pre.preprocess_frame(torch.from_numpy(f), cfg_t).numpy())
    ff = frames[0].astype(np.float32)
    got = t_pre.preprocess_frame(torch.from_numpy(ff), cfg_t)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(j_pre.preprocess_frame(jnp.asarray(ff), cfg_j)),
                               rtol=1e-5, atol=2e-3)


def test_saturating_temporal_diff_and_features_match_jax():
    jc, tc = _configs()
    grays = [np.array(j_pre.preprocess_frame(jnp.asarray(f), jc.preprocess)) for f in _frames(3)]
    for cur, prev in zip(grays[1:], grays[:-1]):
        want = j_pre.temporal_diff(jnp.asarray(cur), jnp.asarray(prev), 0.3)
        got = t_pre.temporal_diff(torch.from_numpy(cur), torch.from_numpy(prev), 0.3)
        assert got.dtype == torch.uint8
        _assert_u8_close(got.numpy(), want)
        jd = j_pre.diff_features(jnp.asarray(cur), jnp.asarray(prev), jc.preprocess)
        td = t_pre.diff_features(torch.from_numpy(cur), torch.from_numpy(prev), tc.preprocess)
        np.testing.assert_array_equal(td.numpy(), _np(jd))
    # saturation at both ends, and halves round to even
    cur = torch.tensor([0, 255, 3, 10], dtype=torch.uint8)
    prev = torch.tensor([255, 0, 5, 15], dtype=torch.uint8)
    np.testing.assert_array_equal(
        t_pre.temporal_diff(cur, prev, 0.3).numpy(),
        np.asarray(j_pre.temporal_diff(jnp.asarray(cur.numpy()), jnp.asarray(prev.numpy()), 0.3)))
    np.testing.assert_array_equal(t_pre._saturate_u8(torch.tensor([0.5, 1.5, 2.5, -3.0, 300.0])).numpy(),
                                  [0, 2, 2, 0, 255])


# ----------------------------------------------------------------- S1 plain


@pytest.mark.parametrize(
    "shape",
    [pytest.param(s, id=f"shape{i}")
     for i, s in enumerate([(17, 23), (2, 8, 6), (1, 5), (5, 1), (1, 1), (135, 135)])]
    # odd and even coarse widths: the CUDA kernel's 8-byte and 16-byte stores,
    # at 1 coarse row a thread and (the last two) at 2
    + [pytest.param(s, id="x".join(map(str, s)))
       for s in [(2, 135, 135), (270, 271), (1, 9), (9, 1), (2, 7, 5), (33, 64), (2, 17, 66),
                 (540, 541), (8, 135, 136)]],
)
def test_pyrup_pair_plain_matches_jax(shape):
    rng = np.random.RandomState(4)
    u = (rng.randn(*shape) * 3).astype(np.float32)
    v = (rng.randn(*shape) * 3).astype(np.float32)
    before = kernels.launch_counts()
    got = pyr_up_pair_cuda(_t(u), _t(v))  # CPU tensors: the plain version
    assert kernels.launch_counts() == before
    for g, x in zip(got, (u, v)):
        assert tuple(g.shape) == shape[:-2] + (2 * shape[-2], 2 * shape[-1])
        np.testing.assert_array_equal(g.numpy(), _np(j_pyr_up(jnp.asarray(x))))
    with pytest.raises(ValueError):
        pyr_up_pair_cuda(_t(u), _t(v)[..., :-1])


# ------------------------------------------------- the reference-mode controller


def _diffs(n=3):
    """Feature maps of consecutive 48^2 grays, made by the JAX package."""
    jc, _ = _configs()
    grays = [j_pre.preprocess_frame(jnp.asarray(f), jc.preprocess) for f in _frames(n)]
    return [np.array(j_pre.diff_features(grays[k + 1], grays[k], jc.preprocess), np.float32)
            for k in range(n - 1)]


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_reference_controller_matches_jax(impl):
    a, b = _diffs()
    ju, jv, jw1, jw2 = jax.jit(lambda p, q: j_c2f_images(p, q, config=j_config.FlowConfig()))(
        jnp.asarray(a), jnp.asarray(b))
    tu, tv, tw1, tw2 = t_c2f_images(_t(a), _t(b), config=t_config.FlowConfig(impl=impl))
    _assert_flow_close(ju, jv, tu, tv)
    # the warped finest frames, the reference's in-place contract
    for j, t in ((jw1, tw1), (jw2, tw2)):
        d = np.abs(_np(j) - t.numpy())
        assert np.median(d) < 1e-3 and np.quantile(d, 0.99) < 0.05, (np.median(d), np.quantile(d, 0.99))


def test_reference_controller_kernel_route_equals_plain():
    """On CPU tensors the kernel route (S1, K1 wrappers) runs their plain
    versions: the flows equal the plain route's to the bit."""
    a, b = _diffs()
    want = t_c2f_images(_t(a), _t(b), config=t_config.FlowConfig(impl="torch"))
    got = t_c2f_images(_t(a), _t(b), config=t_config.FlowConfig(impl="cuda"))
    for x, y in zip(got, want):
        assert torch.equal(x, y)


# ------------------------------------------------------------ the pipeline


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_reference_pipeline_matches_jax(impl):
    """VideoPipeline(VideoConfig()) at 48^2 over 5 frames: faithful uint8
    head, reference mode, gather warp, warped diff fed back."""
    jc, tc = _configs(impl=impl)
    frames = _frames(5)
    jres = list(JVideoPipeline(jc).run(frames, prefetch=0))
    tres = list(TVideoPipeline(tc, device="cpu").run(frames))
    assert len(tres) == len(frames) - 2
    _assert_results_close(jres, tres)


def test_reference_pipeline_with_mag_thresh_votes():
    """The same run with a 2 px gesture threshold, where votes count the
    moving patch (hundreds) rather than a few outliers."""
    jc, tc = _configs()
    jc = dataclasses.replace(jc, gesture=j_config.GestureConfig(mag_thresh=2.0))
    tc = dataclasses.replace(tc, gesture=t_config.GestureConfig(mag_thresh=2.0))
    frames = _frames(5)
    jres = list(JVideoPipeline(jc).run(frames, prefetch=0))
    tres = list(TVideoPipeline(tc, device="cpu").run(frames))
    assert max(int(r.gesture.votes) for r in tres) > 50
    _assert_results_close(jres, tres)


def test_reference_state_carried_over_from_jax():
    jc, tc = _configs()
    assert video_config_from_jax(jc) == tc
    frames = _frames(6)
    jpipe = JVideoPipeline(jc)
    for f in frames[:3]:
        jpipe.push(f)
    state = pipeline_state_from_jax(jpipe.state())
    assert state["prev_gray"].dtype == torch.uint8 and state["prev_gray"].device.type == "cpu"
    tpipe = TVideoPipeline(tc, device="cpu")
    tpipe.restore(state)
    jres = [jpipe.push(f) for f in frames[3:]]
    tres = [tpipe.push(f) for f in frames[3:]]
    assert all(r is not None for r in tres)
    _assert_results_close(jres, tres)


def test_reference_pipeline_on_a_cpu_mesh_equals_unsharded():
    """The mesh controller takes the same reference-mode branch (the
    upsample is injected into both controllers)."""
    _, tc = _configs(impl="cuda")
    frames = _frames(5)
    want = list(TVideoPipeline(tc, device="cpu").run(frames))
    got = list(TVideoPipeline(tc, device="cpu", mesh=flow_mesh(1, 2, 2, devices=["cpu"] * 4))
               .run(frames))
    for g, w in zip(got, want):
        assert torch.equal(g.u, w.u) and torch.equal(g.v, w.v)


# --------------------------------------------------------- the default device


def test_entry_points_default_to_the_card(monkeypatch):
    """No card and no device named: raise, never carry on on the CPU; the
    CPU runs when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TVideoPipeline(t_config.VideoConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TVideoPipeline(t_config.VideoConfig.fast(), device="cuda:0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flow_mesh(1, 2, 2)
    # the host path's entry points raise when called, before any frame is read
    frames = _frames(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prefetch_to_device(iter(frames))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prefetch_chunks_to_device(iter(frames), chunk_size=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replay_video("pipe:128x72:no-such-file", t_config.VideoConfig.fast(size=(SIZE, SIZE)))
    # the structure-from-motion entry points: host arrays need a card
    from optical_flow_tpu_torch import slam

    pts = np.random.RandomState(0).rand(12, 2).astype(np.float32)
    X = np.random.RandomState(1).rand(12, 3).astype(np.float32) + 2.0
    P = np.eye(3, 4, dtype=np.float32)
    prob = slam.BAProblem(np.zeros((2, 6)), X.astype(np.float64), np.zeros(12, np.int32),
                          np.arange(12, dtype=np.int32), pts.astype(np.float64))
    gray = np.zeros((24, 32), np.uint8)
    calls = [
        lambda **kw: slam.estimate_essential(pts, pts, **kw),
        lambda **kw: slam.ransac_essential_5pt(pts, pts, n_samples=4, **kw),
        lambda **kw: slam.recover_pose(np.eye(3, dtype=np.float32), pts, pts, **kw),
        lambda **kw: slam.refine_pose(np.eye(3), np.ones(3), pts, pts, iters=1, **kw),
        lambda **kw: slam.triangulate(P, P, pts, pts, **kw),
        lambda **kw: slam.normalize_pixels(pts, 100.0, 1.0, 1.0, **kw),
        lambda **kw: slam.pnp_dlt(X, pts, **kw),
        lambda **kw: slam.pnp_ransac(X, pts, n_hypotheses=4, **kw),
        lambda **kw: slam.bundle_adjust(prob, iters=1, **kw),
        lambda **kw: slam.reprojection_rmse(prob, **kw),
        lambda **kw: slam.WindowedBA(**kw),
        lambda **kw: slam.two_view_reconstruct(gray, gray, 100.0, **kw),
        lambda **kw: slam.frontend.multi_view_reconstruct([gray] * 3, 100.0, **kw),
        # the mapper: frames, images and graphs given as host data
        lambda **kw: slam.incremental_slam([gray] * 3, 100.0, **kw),
        lambda **kw: slam.dense_disparity(gray, gray, **kw),
        lambda **kw: slam.stereo_match(gray, gray, pts, **kw),
        lambda **kw: slam.verify_loop_closure(gray, gray, 100.0, 16.0, 12.0, **kw),
        lambda **kw: slam.relocalize(gray, [gray], [pts], X, 100.0, 16.0, 12.0, **kw),
        lambda **kw: slam.PoseGraph.from_odometry(np.stack([np.eye(3)] * 2),
                                                  np.zeros((2, 3))).optimize(iters=1, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")  # runs (the flat frames find no corners: None)
    assert slam.WindowedBA(device="cpu").device == torch.device("cpu")
    assert len(list(prefetch_to_device(iter(frames), device="cpu"))) == 3
    assert [c.shape[0] for c in prefetch_chunks_to_device(iter(frames), 2, device="cpu")] == [2, 1]
    mesh = flow_mesh(1, 2, 2, devices=["cpu"] * 4)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    _, tc = _configs()
    pipe = TVideoPipeline(tc, device="cpu")
    assert pipe.device == torch.device("cpu")
    assert [pipe.push(f) for f in _frames(3)][-1] is not None
    # the server and the CLI's flow, video and serve: the card by default,
    # raising before any file, frame or socket is touched
    from optical_flow_tpu_torch.__main__ import main as cli
    from optical_flow_tpu_torch.pipeline.serve import FlowServer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        FlowServer(port=0)
    for argv in (["flow", "no-such-a.png", "no-such-b.png"],
                 ["video", "--input", "pipe:8x8:no-such-file"], ["serve", "--port", "0"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli(argv)
    srv = FlowServer(port=0, device="cpu")
    assert srv.device == torch.device("cpu")
    srv.shutdown()


# ---------------------------------------------------- on the card (marked)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_pyrup_kernel_on_card_equals_plain(cuda_device):
    """Odd and even coarse widths on both sides of the launcher's strip rule
    (1 coarse row a thread; 2 from a 540^2-sized grid: the last five)."""
    rng = np.random.RandomState(6)
    for shape in [(135, 135), (2, 7, 5), (1, 1), (1, 9), (2, 135, 135), (270, 271), (9, 1),
                  (33, 64), (2, 17, 66), (540, 540), (540, 541), (537, 530), (543, 511),
                  (8, 135, 136)]:
        u, v = (_t(rng.randn(*shape) * 3).to(cuda_device) for _ in range(2))
        want = pyr_up_pair_plain(u, v)
        before = kernels.launch_counts()["oft_pyrup"]
        got = pyr_up_pair_cuda(u, v)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["oft_pyrup"] == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_faithful_gray_on_card_within_one_of_cpu(cuda_device):
    f = _big_frame()
    cfg = t_config.PreprocessConfig()
    got = t_pre.preprocess_frame(torch.from_numpy(f).to(cuda_device), cfg).cpu()
    _assert_u8_close(got.numpy(), t_pre.preprocess_frame(torch.from_numpy(f), cfg).numpy())


@pytest.mark.cuda
def test_reference_pipeline_on_card_kernels_equal_plain(cuda_device):
    frames = _frames(5, hw=(144, 256))
    _, tk = _configs(size=96)
    _, tp = _configs(size=96, impl="torch")
    kernels.reset_launch_counts()
    got = list(TVideoPipeline(tk, device=cuda_device).run(frames))
    counts = kernels.launch_counts()
    want = list(TVideoPipeline(tp, device=cuda_device).run(frames))
    levels = 6  # 96 = 2^5 * 3
    assert counts["oft_lk"] == levels * len(got) and counts["oft_pyrup"] == (levels - 1) * len(got)
    assert counts["oft_remap"] == (levels - 1) * len(got)  # W1: the warp of each finer level
    for g, w in zip(got, want):
        assert torch.equal(g.u, w.u) and torch.equal(g.v, w.v)
