"""The port's stereo (optical_flow_tpu_torch/slam/stereo.py) against the JAX
package's (optical_flow_tpu/slam/stereo.py) on identical numpy inputs made
from a seed, on the CPU. The scenes are tests/test_stereo_slam.py's rigs,
rendered exactly (fixed-point inverse map) with numpy/scipy, no cv2.
Tolerances:

  stereo_match            the sparse LK bars of tests/test_torch_track.py:
                          median |d| < 1e-4 px, max < 0.03 px (one Newton
                          step of up to eps = 0.03 px may differ where float32
                          roundoff moves a feature across the freeze); the
                          same ok masks
  stereo_backproject      equal (the same numpy)
  dense_disparity, CPU    the port's plain path against JAX's: median |d|
                          <= 1e-3 px and q99 <= 0.02 px (observed: bit for
                          bit), valid masks equal on >= 99.9% of pixels; and
                          tests/test_stereo_slam.py's truth bars
  dense_depth             <= 1e-6 relative
  split_sbs               equal

The test marked ``cuda`` holds the card (K2; K1 and K3 at C = 12 for the
dense path) against the CPU and skips where there is no card.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from optical_flow_tpu.slam import stereo as js
from optical_flow_tpu.track.features import good_features_to_track as j_corners
from optical_flow_tpu_torch.slam import stereo as ts


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The mapper issues many small ops: one intra-op thread each keeps them
    from spinning against the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _zoom(a, h, w):
    return ndimage.zoom(a, (h / a.shape[0], w / a.shape[1]), order=3)


def _depth(rng, h, w):
    return np.clip(4.0 + 6.0 * _zoom(rng.rand(10, 13).astype(np.float32), h, w), 3.0, 12.0)


def view(base, depth, focal, cx_w, cy_w):
    """tests/test_stereo_slam.py::_view: the exact render of the textured
    surface from camera centre (cx_w, cy_w, 0), R = I (the inverse map
    solved by fixed-point iteration). Returns (image, source u, source v)."""
    h, w = base.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    u, v = xs.copy(), ys.copy()
    for _ in range(8):
        d = ndimage.map_coordinates(depth.astype(np.float32), [v, u], order=1, mode="nearest")
        u = (xs + focal * float(cx_w) / d).astype(np.float32)
        v = (ys + focal * float(cy_w) / d).astype(np.float32)
    img = ndimage.map_coordinates(base.astype(np.float32), [v, u], order=1, mode="mirror")
    return np.clip(np.rint(img), 0, 255).astype(np.uint8), u, v


def smooth_scene(h=320, w=416, seed=11):
    """tests/test_stereo_slam.py::_make_scene (and the scene of
    tests/test_incremental_slam.py and tests/test_pose_graph.py): a smooth
    uint8 texture and a depth field of [3, 12]. Returns (base, depth, the
    generator, for draws that follow the scene's)."""
    rng = np.random.RandomState(seed)
    base = _zoom(rng.rand(80, 104).astype(np.float32), h, w)
    base = (255 * (base - base.min()) / np.ptp(base)).astype(np.uint8)
    return base, _depth(rng, h, w), rng


def stereo_loop(n_frames=10, baseline=0.3, h=320, w=416, focal=400.0, radius=1.0, seed=11):
    """tests/test_stereo_slam.py::_render_stereo_loop: (left, right) pairs of
    a camera on a loop of radii (0.12, 0.08) x radius; returns (pairs, true
    centres)."""
    base, depth, _ = smooth_scene(h, w, seed)
    pairs, centers = [], []
    for k in range(n_frames):
        th = 2 * np.pi * k / n_frames
        cx_w = 0.12 * radius * np.sin(th)
        cy_w = 0.08 * radius * (1 - np.cos(th))
        pairs.append((view(base, depth, focal, cx_w, cy_w)[0],
                      view(base, depth, focal, cx_w + baseline, cy_w)[0]))
        centers.append((cx_w, cy_w, 0.0))
    return pairs, np.asarray(centers)


def textured_rig(baseline, h=320, w=416, focal=400.0, seed=4):
    """tests/test_stereo_slam.py::_textured_rig: per-pixel noise under a
    light blur. Returns (left, right, true disparity, true depth)."""
    rng = np.random.RandomState(seed)
    base = ndimage.gaussian_filter((rng.rand(h, w) * 255).astype(np.float32), 1.2,
                                   truncate=2 / 1.2, mode="mirror")
    base = (255 * (base - base.min()) / np.ptp(base)).astype(np.uint8)
    depth = _depth(rng, h, w)
    left, ul, vl = view(base, depth, focal, 0.0, 0.0)
    right = view(base, depth, focal, baseline, 0.0)[0]
    d_src = ndimage.map_coordinates(depth.astype(np.float32), [vl, ul], order=1, mode="nearest")
    return left, right, focal * baseline / d_src, d_src


def _interior(shape):
    m = np.zeros(shape, bool)
    m[20:-20, 20:-60] = True  # outside the warp's boundary band
    return m


@pytest.mark.parametrize("scene", ["plane", "varying"])
def test_stereo_match_matches_jax(scene):
    focal = 400.0
    if scene == "plane":
        base, _, _ = smooth_scene()
        depth = np.full(base.shape, 6.0, np.float32)  # a uniform 20 px disparity
        left, right = view(base, depth, focal, 0.0, 0.0)[0], view(base, depth, focal, 0.3, 0.0)[0]
    else:
        (left, right), = stereo_loop(n_frames=1)[0]
    pts, valid = j_corners(left, 200, 0.01, 8)
    pts = np.asarray(pts, np.float32)[np.asarray(valid)]
    want = js.stereo_match(left, right, pts)
    got = ts.stereo_match(left, right, pts, device="cpu")
    np.testing.assert_array_equal(got[1], want[1])
    for a, b in ((got[0], want[0]), (got[2], want[2])):
        d = np.abs(a - b)
        assert np.median(d) < 1e-4 and d.max() < 0.03, (np.median(d), d.max())
    assert got[1].sum() >= 50
    if scene == "plane":  # tests/test_stereo_slam.py's bar
        assert np.median(np.abs(got[0][got[1]] - focal * 0.3 / 6.0)) < 0.1
    gate = ts.stereo_match(left, right, pts, max_disparity=15.0, device="cpu")[1]
    np.testing.assert_array_equal(gate, js.stereo_match(left, right, pts, max_disparity=15.0)[1])


def test_stereo_backproject_matches_jax():
    rng = np.random.RandomState(0)
    pts = rng.uniform(0, 400, (30, 2)).astype(np.float32)
    disp = rng.uniform(-1, 40, 30).astype(np.float32)
    np.testing.assert_array_equal(ts.stereo_backproject(pts, disp, 400.0, 208.0, 160.0, 0.3),
                                  js.stereo_backproject(pts, disp, 400.0, 208.0, 160.0, 0.3))


@pytest.mark.parametrize("baseline", [0.1, 0.3])
def test_dense_disparity_matches_jax(baseline):
    left, right, true_disp, d_src = textured_rig(baseline)
    jd, jv = (np.asarray(x) for x in js.dense_disparity(left, right))
    td, tv = ts.dense_disparity(left, right, device="cpu")
    assert td.dtype == torch.float32 and tv.dtype == torch.bool
    td, tv = td.numpy(), tv.numpy()
    d = np.abs(td - jd)
    assert np.median(d) <= 1e-3 and np.quantile(d, 0.99) <= 0.02, (np.median(d), d.max())
    assert (tv == jv).mean() >= 0.999
    # the truth bars of tests/test_stereo_slam.py
    m = _interior(tv.shape)
    err = np.abs(td - true_disp)[tv & m]
    valid_bar, err_bar = (0.95, 0.25) if baseline == 0.1 else (0.85, 1.5)
    assert tv[m].mean() > valid_bar and np.median(err) < err_bar, (tv[m].mean(), np.median(err))
    if baseline == 0.1:
        z = ts.dense_depth(td, 400.0, baseline, torch.from_numpy(tv), device="cpu").numpy()
        zj = np.asarray(js.dense_depth(jd, 400.0, baseline, jv))
        np.testing.assert_allclose(z, zj, rtol=1e-6, atol=0)
        sel = tv & m & (z > 0)
        assert np.median(np.abs(z - d_src)[sel] / d_src[sel]) < 0.05
    else:
        # the envelope is real: clamp 8 loses most pixels (as in JAX)
        from optical_flow_tpu_torch.config import FlowConfig

        tight = FlowConfig(mode="corrected", warp_clamp=8.0)
        assert ts.dense_disparity(left, right, config=tight, device="cpu")[1].numpy()[m].mean() < 0.6


def test_split_sbs_matches_jax():
    gray = np.arange(2 * 6 * 8, dtype=np.uint8).reshape(2, 6, 8)
    color = np.arange(6 * 9 * 3, dtype=np.uint8).reshape(6, 9, 3)
    for f in (gray, color, gray[..., :7]):
        for got, want in zip(ts.split_sbs(f), js.split_sbs(f)):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(ts.split_sbs(torch.from_numpy(f)), js.split_sbs(f)):
            assert isinstance(got, torch.Tensor)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.cuda
def test_stereo_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from optical_flow_tpu_torch import kernels
    from optical_flow_tpu_torch.config import FlowConfig

    left, right, _, _ = textured_rig(0.3)
    kernels.reset_launch_counts()
    card, card_valid = ts.dense_disparity(left, right)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert card.is_cuda and counts["oft_lk"] > 0 and counts["oft_pyrup_warp_lk"] > 0, counts
    plain, _ = ts.dense_disparity(left, right, config=FlowConfig(mode="corrected", warp_clamp=24.0,
                                                                 impl="torch"))
    d = (card - plain).abs()
    assert float(d.median()) < 1e-3 and float(torch.quantile(d.flatten(), 0.99)) < 0.02
    pts = np.stack(np.meshgrid(np.arange(40, 380, 23), np.arange(40, 280, 23)), -1)
    pts = pts.reshape(-1, 2).astype(np.float32)
    got, cpu = ts.stereo_match(left, right, pts), ts.stereo_match(left, right, pts, device="cpu")
    assert (got[1] == cpu[1]).mean() >= 0.99
    d = np.abs(got[0] - cpu[0])[got[1] & cpu[1]]
    assert np.median(d) < 1e-4 and d.max() < 0.03
