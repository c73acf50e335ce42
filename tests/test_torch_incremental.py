"""The port's incremental SLAM (optical_flow_tpu_torch/slam/incremental.py)
on the scenes of tests/test_incremental_slam.py and tests/test_stereo_slam.py
at their size (320x416), rendered with numpy/scipy (no cv2), on the CPU.

A whole run is not bit-equal to the JAX package's: the port's 8-point and
PnP RANSAC sets come from its own CPU sampler (its modules are held to JAX
on JAX's own sets in tests/test_torch_epipolar.py, test_torch_pose_graph.py
and test_torch_slam.py). So each run is held to the truth at the JAX tests'
own bars:

  monocular loop           mean centre error < 0.05, max < 0.10 (loop radius
                           0.12) after one global scale; a loop edge between
                           keyframes >= 6 apart with >= 30 inliers; rmse < 5 px
  generator input          bit-equal to the list input
  stereo loop (metric)     mean < 0.05, max < 0.10 with no scale fit; median
                           landmark depth in the rendered [3, 12]
  blackout                 no keyframe in the blackout; the poses after it
                           within 0.12

The test marked ``cuda`` holds the card against the CPU and skips where
there is no card.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from optical_flow_tpu_torch import convert
from optical_flow_tpu_torch.slam import SlamResult, incremental_slam
from test_torch_stereo import one_thread, smooth_scene, stereo_loop  # noqa: F401 (one_thread: a fixture)


def render_loop(n_frames=10, h=320, w=416, focal=400.0, radius=1.0, seed=11):
    """tests/test_incremental_slam.py::_render_loop: a camera on a loop of
    radii (0.12, 0.08) x radius over a textured plane with a depth field of
    [3, 12] (cubic zooms, bilinear REFLECT_101 parallax). Returns (uint8
    frames, true centres)."""
    base, depth, _ = smooth_scene(h, w, seed)
    base = base.astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    inv = focal / depth
    frames, centers = [], []
    for k in range(n_frames):
        th = 2 * np.pi * k / n_frames
        cx_w = 0.12 * radius * np.sin(th)
        cy_w = 0.08 * radius * (1 - np.cos(th))
        img = ndimage.map_coordinates(base, [ys + cy_w * inv, xs + cx_w * inv], order=1,
                                      mode="mirror")
        frames.append(np.clip(np.rint(img), 0, 255).astype(np.uint8))
        centers.append((cx_w, cy_w, 0.0))
    return frames, np.asarray(centers)


def centre_errors(res, centers, scale_fit=True):
    est = res.centers()
    true = np.asarray([centers[i] for i in res.keyframes])
    scale = np.linalg.norm(true[1]) / max(np.linalg.norm(est[1]), 1e-9) if scale_fit else 1.0
    return np.linalg.norm(est * scale - true, axis=1)


LOOP_KW = dict(loop_min_separation=6, loop_min_inliers=30, min_tracks=40, window=8)


def test_incremental_slam_on_loop():
    frames, centers = render_loop()
    res = incremental_slam(frames, 400.0, device="cpu", **LOOP_KW)
    assert isinstance(res, SlamResult) and res.keyframes[-1] == len(frames) - 1
    assert 2 <= len(res.keyframes) <= len(frames)
    assert res.points.shape[0] >= 50 and res.rmse is not None and res.rmse < 5.0
    err = centre_errors(res, centers)
    assert err.mean() < 0.05 and err.max() < 0.10, err
    assert res.loop_edges, "no loop closure found"
    i, j, n = res.loop_edges[0]
    assert j - i >= 6 and n >= 30
    # the observations behind the map, in BAProblem layout
    M = len(res.cam_idx)
    assert M == len(res.pt_idx) == len(res.obs) == len(res.obs_baseline) > 0
    assert res.cam_idx.max() < len(res.keyframes) and res.pt_idx.max() < len(res.points)
    assert not res.obs_baseline.any()  # monocular
    for a in (res.poses, res.trans, res.points):
        assert isinstance(a, np.ndarray) and np.isfinite(a).all()


def test_incremental_slam_streams_from_generator():
    frames, _ = render_loop(n_frames=12)
    # adaptive keyframes; no loop closure (test_incremental_slam_on_loop
    # holds it), which would double the test's time and add nothing here
    kw = dict(LOOP_KW, kf_min_disparity=3.0, loop_min_separation=20)
    res_list = incremental_slam(frames, 400.0, device="cpu", **kw)
    res_gen = incremental_slam((f for f in frames), 400.0, device="cpu", **kw)
    assert res_list.keyframes == res_gen.keyframes and len(res_list.keyframes) < 12
    for a, b in ((res_list.poses, res_gen.poses), (res_list.trans, res_gen.trans),
                 (res_list.points, res_gen.points)):
        np.testing.assert_array_equal(a, b)


def test_incremental_slam_input_errors():
    frames, _ = render_loop(n_frames=2, h=64, w=80)
    with pytest.raises(ValueError, match=">= 2 frames"):
        incremental_slam(frames[:1], 400.0, device="cpu")
    with pytest.raises(ValueError, match=">= 2 frames"):
        incremental_slam(iter([]), 400.0, device="cpu")
    with pytest.raises(ValueError, match="stereo frames"):
        incremental_slam([np.stack(frames * 3)] * 2, 400.0, stereo_baseline=0.3, device="cpu")


def test_stereo_incremental_slam_metric_trajectory():
    pairs, centers = stereo_loop(n_frames=10, baseline=0.3)
    # (2, H, W) stacks, as split side-by-side video gives them
    res = incremental_slam([np.stack(p) for p in pairs], 400.0, stereo_baseline=0.3,
                           loop_min_separation=20, min_tracks=40, window=8, device="cpu")
    assert res.keyframes[0] == 0 and res.keyframes[-1] == 9
    assert res.points.shape[0] >= 50 and res.rmse < 5.0
    err = centre_errors(res, centers, scale_fit=False)  # metric: no scale fit
    assert err.mean() < 0.05 and err.max() < 0.10, err
    assert 3.0 < np.median(res.points[:, 2]) < 12.0
    assert (res.obs_baseline == 0.3).any()  # the right-eye measurements are exported


def test_incremental_slam_relocalizes_after_blackout():
    frames, centers = render_loop(n_frames=12)
    rng = np.random.RandomState(99)
    for bad in (6, 7):
        frames[bad] = (rng.rand(*frames[bad].shape) * 255).astype(np.uint8)
    res = incremental_slam(frames, 400.0, loop_min_separation=20, min_tracks=40, window=8,
                           device="cpu")
    assert any(i < 6 for i in res.keyframes) and any(i > 7 for i in res.keyframes)
    assert not any(i in (6, 7) for i in res.keyframes), res.keyframes
    err = centre_errors(res, centers)
    post = [e for i, e in zip(res.keyframes, err) if i > 7]
    assert post and max(post) < 0.12, (res.keyframes, err)


def test_slam_result_from_jax():
    from optical_flow_tpu.slam.incremental import SlamResult as JSlamResult

    rng = np.random.RandomState(0)
    R = np.stack([np.eye(3, dtype=np.float32)] * 3)
    j = JSlamResult(poses=R, trans=rng.randn(3, 3).astype(np.float32), points=rng.randn(5, 3),
                    keyframes=[0, 2, 3], loop_edges=[(0, 2, 41)], rmse=0.5,
                    cam_idx=np.arange(4, dtype=np.int32) % 3,
                    pt_idx=np.arange(4, dtype=np.int32), obs=rng.randn(4, 2),
                    obs_baseline=np.zeros(4))
    t = convert.slam_result_from_jax(j)
    np.testing.assert_array_equal(t.centers(), j.centers())
    assert t.keyframes == j.keyframes and t.loop_edges == j.loop_edges and t.rmse == j.rmse
    for name in ("poses", "trans", "points", "cam_idx", "pt_idx", "obs", "obs_baseline"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))


@pytest.mark.cuda
def test_incremental_slam_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from optical_flow_tpu_torch import kernels

    frames, centers = render_loop()
    kernels.reset_launch_counts()
    card = incremental_slam(frames, 400.0, **LOOP_KW)
    assert kernels.launch_counts()["oft_pyramid"] >= len(frames)
    cpu = incremental_slam(frames, 400.0, device="cpu", **LOOP_KW)
    assert card.keyframes == cpu.keyframes
    assert [e[:2] for e in card.loop_edges] == [e[:2] for e in cpu.loop_edges]
    # centres in the truth's units (the CPU run's global scale), relative to
    # the loop radius
    true = np.asarray([centers[i] for i in cpu.keyframes])
    scale = np.linalg.norm(true[1]) / np.linalg.norm(cpu.centers()[1])
    assert np.abs(card.centers() - cpu.centers()).max() * scale < 1e-3 * 0.12
    err = centre_errors(card, centers)
    assert err.mean() < 0.05 and err.max() < 0.10
