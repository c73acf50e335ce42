"""The port's mesh-sharded flow path (optical_flow_tpu_torch/parallel/) and
the tile mode of kernels K3/K4 (K5) against the JAX package.

Both sides take identical numpy inputs made from a seed. The JAX side runs
under ``shard_map`` on the 8 virtual CPU devices of tests/conftest.py; the
port's mesh is a grid of ``torch.device('cpu')`` entries, driven by one
process as the JAX controller drives its mesh. Tolerances:

  halo exchange, split/merge      bit for bit (copies only)
  sharded LK and warps            bit for bit in float32, against JAX's
                                  sharded ops (impl 'jnp') and the unsharded port
  K5 plain tile mode vs JAX       atol 2e-5 on well-conditioned pixels
                                  (tests/test_warp_lk_kernel.py:61-106), against
                                  the Pallas tile mode in interpret mode
  K5 plain tile mode vs full      bit for bit over the tile's region
  sharded controller, pipeline    bit for bit against the unsharded port; the
                                  pipeline against JAX's mesh pipeline by flow
                                  quantiles (median < 1e-3, q99 < 0.02 px)

The tests marked ``cuda`` hold K5 and P1 against their plain versions on a
card and skip where there is none.
"""

import dataclasses
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from optical_flow_tpu import config as j_config
from optical_flow_tpu import parallel as j_par
from optical_flow_tpu.ops.warp import symmetric_warp as j_symmetric_warp
from optical_flow_tpu.parallel import halo as j_halo
from optical_flow_tpu.pipeline.video import VideoPipeline as JVideoPipeline
from optical_flow_tpu_torch import config as t_config
from optical_flow_tpu_torch import convert, kernels
from optical_flow_tpu_torch.flow.coarse_to_fine import coarse_to_fine
from optical_flow_tpu_torch.flow.lk import lucas_kanade_torch
from optical_flow_tpu_torch.kernels.warp_lk_kernel import (
    pyrup_coarse_halo,
    pyrup_warp_lk_cuda,
    pyrup_warp_lk_plain,
    warp_lk_cuda,
    warp_lk_plain,
)
from optical_flow_tpu_torch.ops.warp import symmetric_warp
from optical_flow_tpu_torch.parallel import halo as t_halo
from optical_flow_tpu_torch.parallel import (
    flow_mesh,
    mesh_factorization,
    sharded_coarse_to_fine,
    sharded_lucas_kanade,
    sharded_pyrup_warp_lk,
    sharded_symmetric_warp,
    sharded_warp_lk,
)
from optical_flow_tpu_torch.parallel.mesh import merge, split
from optical_flow_tpu_torch.parallel.vma_compat import mesh_probe
from optical_flow_tpu_torch.pipeline.video import VideoPipeline as TVideoPipeline
from test_torch_kernels import _close_where, _flow, _interpret, _np, _ok_mask, _t, _well_conditioned
from test_torch_slice import _frames

AX = (j_par.mesh.AXIS_FRAMES, j_par.mesh.AXIS_ROWS, j_par.mesh.AXIS_COLS)
# (frames, rows, cols) grids and the shapes each is tested at
GRIDS = {"2x2x2": ((2, 2, 2), (2, 64, 128)), "1x2x4": ((1, 2, 4), (64, 128))}
sharded_flow = importlib.import_module("optical_flow_tpu_torch.parallel.sharded_flow")
vma_compat = importlib.import_module("optical_flow_tpu_torch.parallel.vma_compat")


def _jmesh(grid):
    f, r, c = grid
    return j_par.flow_mesh(frames=f, rows=r, cols=c, devices=jax.devices()[: f * r * c])


def _tmesh(grid, device="cpu"):
    f, r, c = grid
    return flow_mesh(f, r, c, devices=[device] * (f * r * c))


def _j_tiles(jmesh, x, body):
    """``body`` on every tile of ``x`` under shard_map -> a numpy array
    indexed [frame, row, col] of the per-tile results."""
    lead = [AX[0]] if x.ndim == 3 else []
    fn = jax.shard_map(
        lambda t: body(t)[None, None, None], mesh=jmesh,
        in_specs=P(*lead, AX[1], AX[2]), out_specs=P(*AX, *([None] * x.ndim)),
    )
    return np.asarray(fn(jnp.asarray(x)))


# ------------------------------------------------------------------- mesh


@pytest.mark.parametrize("n", range(1, 17))
def test_mesh_factorization_matches_jax(n):
    assert mesh_factorization(n) == j_par.mesh_factorization(n)


def test_flow_mesh_shape_and_devices():
    m = flow_mesh(2, 1, 3, devices=["cpu"] * 6)
    assert m.shape == {"frames": 2, "rows": 1, "cols": 3}
    assert m.shape == dict(_jmesh((2, 1, 3)).shape)
    assert m.home == torch.device("cpu") and m.devices.shape == (2, 1, 3)
    with pytest.raises(ValueError):  # a list shorter than the grid
        flow_mesh(2, 2, 2, devices=["cpu"] * 7)


@pytest.mark.parametrize("grid", GRIDS)
def test_split_merge_round_trip(grid):
    dims, shape = GRIDS[grid]
    mesh = _tmesh(dims)
    x = _t(np.random.RandomState(0).rand(*shape))
    tiles = split(x, mesh)
    assert tiles.shape == (dims[0] if x.ndim == 3 else 1,) + dims[1:]
    assert torch.equal(merge(tiles, mesh), x)
    with pytest.raises(ValueError):  # rows that do not divide
        split(x[..., :-1, :], mesh)


# ------------------------------------------------------------------- halo

HALO_CASES = [
    ("halo", "reflect", 2),
    ("halo", "zero", 6),
    ("rows", "zero", 4),
    ("rows", "reflect", 3),
    ("pyrup", "pyrup", (5, 2)),
]


def _halo_fns(kind, border, k):
    if kind == "halo":
        return (lambda t, n: j_halo.exchange_halo(t, k, rows_n=n[1], cols_n=n[2], border=border),
                lambda g: t_halo.exchange_halo(g, k, border=border))
    if kind == "rows":
        return (lambda t, n: j_halo.exchange_halo_rows(t, k, rows_n=n[1], border=border),
                lambda g: t_halo.exchange_halo_rows(g, k, border=border))
    return (lambda t, n: j_halo.exchange_halo_pyrup(t, k[0], k[1], rows_n=n[1], cols_n=n[2]),
            lambda g: t_halo.exchange_halo_pyrup(g, k[0], k[1]))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("kind,border,k", HALO_CASES)
def test_halo_matches_jax_shard_map(grid, kind, border, k):
    """Every extended tile, corners included, equals JAX's ppermute
    exchange under shard_map bit for bit."""
    dims, shape = GRIDS[grid]
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    j_fn, t_fn = _halo_fns(kind, border, k)
    want = _j_tiles(_jmesh(dims), x, lambda t: j_fn(t, dims))
    got = t_fn(split(_t(x), _tmesh(dims)))
    assert got.shape == want.shape[: got.ndim]
    for idx in np.ndindex(got.shape):
        np.testing.assert_array_equal(got[idx].numpy(), want[idx])


def test_halo_rejects_oversized_halo():
    g = split(torch.zeros(32, 64), _tmesh((1, 2, 4)))  # 16x16 tiles
    with pytest.raises(ValueError):
        t_halo.exchange_halo(g, 17, border="zero")
    with pytest.raises(ValueError):  # reflect reads k+1 samples of the tile
        t_halo.exchange_halo(g, 16)


# ------------------------------------------------------ sharded LK and warp


@pytest.mark.parametrize("grid", GRIDS)
def test_sharded_lk_matches_jax_and_unsharded(grid):
    dims, shape = GRIDS[grid]
    rng = np.random.RandomState(2)
    a, b = (rng.rand(*shape).astype(np.float32) for _ in range(2))
    u, v = sharded_lucas_kanade(_t(a), _t(b), _tmesh(dims), impl="torch")
    ju, jv = j_par.sharded_lucas_kanade(a, b, _jmesh(dims), impl="jnp")
    np.testing.assert_array_equal(u.numpy(), _np(ju))
    np.testing.assert_array_equal(v.numpy(), _np(jv))
    u0, v0 = lucas_kanade_torch(_t(a), _t(b))
    assert torch.equal(u, u0) and torch.equal(v, v0)
    # impl 'cuda' on CPU tiles: K1's plain version on each extended tile
    u1, v1 = sharded_lucas_kanade(_t(a), _t(b), _tmesh(dims), impl="cuda")
    assert torch.equal(u1, u0) and torch.equal(v1, v0)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("impl", ["shift_sep", "gather", "shift"])
def test_sharded_warp_matches_jax_and_unsharded(grid, impl):
    dims, shape = GRIDS[grid]
    rng = np.random.RandomState(3)
    a, b = (rng.rand(*shape).astype(np.float32) for _ in range(2))
    clamp = 6.0
    u, v = (np.clip(rng.randn(*shape) * 3, -clamp, clamp).astype(np.float32) for _ in range(2))
    w1, w2 = sharded_symmetric_warp(_t(a), _t(b), _t(u), _t(v), _tmesh(dims), clamp, impl=impl)
    j1, j2 = j_par.sharded_symmetric_warp(a, b, u, v, _jmesh(dims), clamp, impl=impl)
    np.testing.assert_array_equal(w1.numpy(), _np(j1))
    np.testing.assert_array_equal(w2.numpy(), _np(j2))
    md = {"shift_sep": 3, "shift": 4, "gather": 0}[impl]  # resolve_warp_impl's reach
    o1, o2 = symmetric_warp(_t(a), _t(b), _t(u), _t(v), impl=impl, max_disp=md)
    assert torch.equal(w1, o1) and torch.equal(w2, o2)


# ------------------------------------------------------ K5: plain tile mode


def _zero_ext(x, halo, r0, c0, th, tw):
    """The tile at (r0, c0) of x extended by `halo`, zero beyond the frame:
    what exchange_halo(border='zero') hands each tile."""
    p = np.zeros(x.shape[:-2] + (x.shape[-2] + 2 * halo, x.shape[-1] + 2 * halo), np.float32)
    p[..., halo:-halo, halo:-halo] = x
    return p[..., r0 : r0 + th + 2 * halo, c0 : c0 + tw + 2 * halo]


def _pyrup_ext(x, ocr):
    """The full-frame coarse flow with cv::pyrUp's border one sample deep
    and zeros beyond (tests/test_pyrup_warp_lk.py:130-140)."""
    Hc, Wc = x.shape[-2:]
    buf = np.zeros(x.shape[:-2] + (Hc + 2 * ocr, Wc + 4), np.float32)
    buf[..., ocr : ocr + Hc, 2 : 2 + Wc] = x
    buf[..., ocr - 1, 2 : 2 + Wc] = x[..., 1, :]
    buf[..., ocr + Hc, 2 : 2 + Wc] = x[..., Hc - 1, :]
    strip = buf[..., ocr - 1 : ocr + Hc + 1, 2 : 2 + Wc].copy()
    buf[..., ocr - 1 : ocr + Hc + 1, 1] = strip[..., 1]
    buf[..., ocr - 1 : ocr + Hc + 1, 2 + Wc] = strip[..., Wc - 1]
    return buf


# (H, W, tile h, tile w, C, clamp, seed, tile origins): the geometries of
# tests/test_warp_lk_kernel.py:261-363
K4_TILE_GEOMS = {
    "grid_2x2": (32, 256, 16, 128, 2, 4.0, 11, "grid"),
    "odd_rows_40x192": (40, 192, 20, 96, 3, 6.0, 13, "corners"),
    "narrow_48x256": (48, 256, 24, 128, 3, 6.0, 13, "corners"),
}


def _origins(H, W, th, tw, how):
    rs, cs = ((0, th), (0, tw)) if how == "grid" else ((0, H - th), (0, W - tw))
    return [(r, c) for r in rs for c in cs]


@pytest.mark.parametrize("geom", K4_TILE_GEOMS)
def test_warp_lk_tile_mode_plain_matches_jax_and_full_frame(geom):
    from optical_flow_tpu.kernels.warp_lk_kernel import warp_lk_pallas

    H, W, th, tw, C, clamp, seed, how = K4_TILE_GEOMS[geom]
    rng = np.random.RandomState(seed)
    img1, img2 = (rng.rand(H, W).astype(np.float32) for _ in range(2))
    u, v = _flow(rng, (H, W), 2.0)
    wu, wv = np.clip(u, -clamp, clamp), np.clip(v, -clamp, clamp)
    halo = C + 2
    kw = dict(max_disp=C, clamp=clamp, negate=False)
    du0, dv0 = warp_lk_plain(*(_t(x) for x in (img1, img2, wu, wv)), **kw)
    ok = _well_conditioned(*j_symmetric_warp(
        jnp.asarray(img1), jnp.asarray(img2), jnp.asarray(wu), jnp.asarray(wv),
        quantize=True, impl="shift_sep", max_disp=C))
    for r0, c0 in _origins(H, W, th, tw, how):
        ext = [_zero_ext(x, halo, r0, c0, th, tw) for x in (img1, img2, wu, wv)]
        tile = dict(halo=halo, origin=(r0, c0), global_hw=(H, W))
        du, dv = warp_lk_cuda(*(_t(x) for x in ext), **kw, **tile)
        region = (slice(r0, r0 + th), slice(c0, c0 + tw))
        assert torch.equal(du, du0[region]) and torch.equal(dv, dv0[region])
        ju, jv = _interpret(warp_lk_pallas, *(jnp.asarray(x) for x in ext), **kw, **tile)
        _close_where(ok[region], du, ju, 2e-5)
        _close_where(ok[region], dv, jv, 2e-5)


def _pyrup_inputs(rng, shape):
    H, W = shape[-2:]
    img1, img2 = (rng.rand(*shape).astype(np.float32) for _ in range(2))
    cshape = shape[:-2] + (H // 2, W // 2)
    uc, vc = ((rng.randn(*cshape) * 2.0).astype(np.float32) for _ in range(2))
    return img1, img2, uc, vc


def _pyrup_tiles(img1, img2, uc, vc, th, tw, C):
    """Each tile's (origin, extended frames, extended coarse flow) on the
    2x2 grid, cut from the zero-extended frames and the pyrUp-bordered
    coarse flow."""
    H, W = img1.shape[-2:]
    halo, ocr = C + 2, pyrup_coarse_halo(C)
    ue, ve = _pyrup_ext(uc, ocr), _pyrup_ext(vc, ocr)
    hc, wc = th // 2, tw // 2
    for r0, c0 in _origins(H, W, th, tw, "grid"):
        cs = (Ellipsis, slice(r0 // 2, r0 // 2 + hc + 2 * ocr), slice(c0 // 2, c0 // 2 + wc + 4))
        yield (r0, c0), [_zero_ext(x, halo, r0, c0, th, tw) for x in (img1, img2)] + [ue[cs], ve[cs]]


def test_pyrup_warp_lk_tile_mode_plain_matches_jax_and_full_frame():
    """tests/test_pyrup_warp_lk.py:107's geometry: 32x256 in 16x128 tiles."""
    from optical_flow_tpu.kernels.warp_lk_kernel import pyrup_warp_lk_pallas
    from optical_flow_tpu.ops.pyramid import pyr_up_cols_first

    C, clamp, (H, W, th, tw) = 4, 8.0, (32, 256, 16, 128)
    img1, img2, uc, vc = _pyrup_inputs(np.random.RandomState(5), (H, W))
    kw = dict(max_disp=C, clamp=clamp)
    u0, v0 = pyrup_warp_lk_plain(*(_t(x) for x in (img1, img2, uc, vc)), **kw)
    upu, upv = (2.0 * pyr_up_cols_first(jnp.asarray(x)) for x in (uc, vc))
    ok = _well_conditioned(*j_symmetric_warp(
        jnp.asarray(img1), jnp.asarray(img2), -jnp.clip(upu, -clamp, clamp),
        -jnp.clip(upv, -clamp, clamp), quantize=True, impl="shift_sep", max_disp=C))
    for (r0, c0), ext in _pyrup_tiles(img1, img2, uc, vc, th, tw, C):
        tile = dict(halo=C + 2, origin=(r0, c0), global_hw=(H, W))
        u, v = pyrup_warp_lk_cuda(*(_t(x) for x in ext), **kw, **tile)
        region = (slice(r0, r0 + th), slice(c0, c0 + tw))
        assert torch.equal(u, u0[region]) and torch.equal(v, v0[region])
        ju, jv = _interpret(pyrup_warp_lk_pallas, *(jnp.asarray(x) for x in ext), **kw, **tile)
        _close_where(ok[region], u, ju, 2e-5)
        _close_where(ok[region], v, jv, 2e-5)


@pytest.mark.parametrize("shape,tile", [((52, 76), (26, 38)), ((2, 40, 64), (20, 32)),
                                        ((64, 48), (32, 24))])
def test_pyrup_warp_lk_tile_mode_plain_equals_full_frame(shape, tile):
    """Tiles whose height is no multiple of 8 and batched tiles (outside
    the TPU tile mode's layout rules): the plain tile mode still equals the
    full-frame region bit for bit."""
    C, clamp = 4, 8.0
    img1, img2, uc, vc = _pyrup_inputs(np.random.RandomState(7), shape)
    kw = dict(max_disp=C, clamp=clamp)
    u0, v0 = pyrup_warp_lk_plain(*(_t(x) for x in (img1, img2, uc, vc)), **kw)
    th, tw = tile
    for (r0, c0), ext in _pyrup_tiles(img1, img2, uc, vc, th, tw, C):
        u, v = pyrup_warp_lk_cuda(*(_t(x) for x in ext), **kw, halo=C + 2, origin=(r0, c0),
                                  global_hw=shape[-2:])
        region = (Ellipsis, slice(r0, r0 + th), slice(c0, c0 + tw))
        assert torch.equal(u, u0[region]) and torch.equal(v, v0[region])


def test_tile_mode_rejects_bad_arguments():
    z = torch.zeros(20, 20)
    with pytest.raises(ValueError):  # halo below C + 2
        warp_lk_cuda(z, z, z, z, max_disp=4, clamp=8.0, halo=5, origin=(0, 0), global_hw=(8, 8))
    with pytest.raises(ValueError):  # tile outside the frame
        warp_lk_cuda(z, z, z, z, max_disp=4, clamp=8.0, halo=6, origin=(4, 0), global_hw=(8, 8))
    with pytest.raises(ValueError):  # an origin without a halo
        warp_lk_cuda(z, z, z, z, max_disp=4, clamp=8.0, origin=(0, 0))
    with pytest.raises(ValueError):  # coarse flow without its halo
        pyrup_warp_lk_cuda(z, z, torch.zeros(4, 4), torch.zeros(4, 4), max_disp=4, clamp=8.0,
                           halo=6, origin=(0, 0), global_hw=(8, 8))


# ------------------------------------------------ sharded K3/K4 and controller


def _counting(monkeypatch, name):
    calls = []
    fn = getattr(sharded_flow, name)

    def wrapped(*args, **kw):
        calls.append(args[0].shape)
        return fn(*args, **kw)

    monkeypatch.setattr(sharded_flow, name, wrapped)
    return calls


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("level_iters", [1, 2])
def test_sharded_controller_kernel_route_equals_unsharded(grid, level_iters, monkeypatch):
    """impl='cuda' with the shift_sep warp on CPU tensors takes the kernel
    route through the plain versions (K5 tile mode per tile), and equals
    the unsharded port bit for bit."""
    dims, shape = GRIDS[grid]
    rng = np.random.RandomState(4)
    a = rng.rand(*shape).astype(np.float32)
    b = np.roll(a, (1, 2), (-2, -1)) + 0.05 * rng.rand(*shape).astype(np.float32)
    cfg = t_config.FlowConfig(impl="cuda", mode="corrected", warp_clamp=8.0,
                              warp_impl="shift_sep", level_iters=level_iters)
    tiled_k3 = _counting(monkeypatch, "sharded_pyrup_warp_lk")
    tiled_k4 = _counting(monkeypatch, "sharded_warp_lk")
    u0, v0 = coarse_to_fine(_t(a), _t(b), 3, config=cfg)
    u, v = sharded_coarse_to_fine(_t(a), _t(b), _tmesh(dims), 3, config=cfg, min_tile=16)
    assert torch.equal(u, u0) and torch.equal(v, v0)
    assert len(tiled_k3) == 2  # levels 1 and 0 tile; level 2 is the coarsest
    assert len(tiled_k4) == (2 if level_iters == 2 else 0)  # the coarsest does not tile


def test_sharded_warp_lk_wrappers_equal_full_frame():
    mesh = _tmesh((2, 2, 2))
    rng = np.random.RandomState(6)
    a, b = (_t(rng.rand(2, 64, 96)) for _ in range(2))
    u, v = (_t(np.clip(rng.randn(2, 64, 96) * 3, -8, 8)) for _ in range(2))
    kw = dict(max_disp=4, clamp=8.0)
    du, dv = sharded_warp_lk(a, b, u, v, mesh, **kw)
    du0, dv0 = warp_lk_cuda(a, b, u, v, negate=False, **kw)
    assert torch.equal(du, du0) and torch.equal(dv, dv0)
    uc, vc = (_t(rng.randn(2, 32, 48) * 2) for _ in range(2))
    pu, pv = sharded_pyrup_warp_lk(a, b, uc, vc, mesh, **kw)
    pu0, pv0 = pyrup_warp_lk_cuda(a, b, uc, vc, **kw)
    assert torch.equal(pu, pu0) and torch.equal(pv, pv0)


# --------------------------------------------------------------- pipeline

SIZE = 128


def _video_configs():
    # 2 px gesture threshold: the moving patch's votes, a stable comparison
    # (tests/test_torch_slice.py:125-137)
    jf = j_config.VideoConfig.fast(size=(SIZE, SIZE))
    jf = dataclasses.replace(jf, flow=dataclasses.replace(jf.flow, warp_impl="shift_sep"),
                             gesture=j_config.GestureConfig(mag_thresh=2.0))
    tf = t_config.VideoConfig.fast(size=(SIZE, SIZE))
    tf = dataclasses.replace(
        tf, flow=dataclasses.replace(tf.flow, impl="cuda", pyr_impl="cuda", warp_impl="shift_sep"),
        gesture=t_config.GestureConfig(mag_thresh=2.0),
    )
    return jf, tf


def test_mesh_pipeline_equals_unsharded_and_matches_jax():
    jf, tf = _video_configs()
    frames = _frames()
    tres = list(TVideoPipeline(tf, device="cpu", mesh=_tmesh((1, 2, 2))).run(frames))
    tres0 = list(TVideoPipeline(tf, device="cpu").run(frames))
    jres = list(JVideoPipeline(jf, mesh=_jmesh((1, 2, 2))).run(frames, prefetch=0))
    assert len(tres) == len(tres0) == len(jres) == len(frames) - 2
    inner = (slice(8, -8), slice(8, -8))
    for t, t0, j in zip(tres, tres0, jres):
        assert torch.equal(t.u, t0.u) and torch.equal(t.v, t0.v)
        assert int(t.gesture.votes) == int(t0.gesture.votes)
        d = np.hypot(_np(j.u)[inner] - t.u.numpy()[inner], _np(j.v)[inner] - t.v.numpy()[inner])
        assert np.median(d) < 1e-3 and np.quantile(d, 0.99) < 0.02, (np.median(d), np.quantile(d, 0.99))
        a, b = int(j.gesture.votes), int(t.gesture.votes)
        assert abs(a - b) <= max(1, 0.01 * max(a, b)), (a, b)


def test_mesh_pipeline_batched_equals_streaming():
    """run_batched with the pairs split over the frames axis."""
    _, tf = _video_configs()
    frames = _frames()
    pipe = TVideoPipeline(tf, device="cpu", mesh=_tmesh((2, 2, 2)))
    batched = pipe.run_batched(torch.from_numpy(frames))
    stream = list(TVideoPipeline(tf, device="cpu").run(frames))
    for k, r in enumerate(stream):
        assert torch.equal(batched.u[k], r.u) and torch.equal(batched.v[k], r.v)
        assert int(batched.gesture.votes[k]) == int(r.gesture.votes)


def test_mesh_carried_over_from_jax():
    jmesh = _jmesh((2, 2, 2))
    m = convert.flow_mesh_from_jax(jmesh, ["cpu"] * 8)
    assert m.shape == dict(jmesh.shape)
    jcfg = j_config.MeshConfig(rows=2, cols=4, frames=1)
    assert convert.mesh_config_from_jax(jcfg) == t_config.MeshConfig(rows=2, cols=4, frames=1)


# ------------------------------------------------------------- rejections


def test_rejects_bad_tiling():
    mesh = _tmesh((2, 2, 2))
    z = torch.zeros(31, 64)  # 31 rows do not divide by 2
    with pytest.raises(ValueError):
        sharded_lucas_kanade(z, z, mesh)
    with pytest.raises(ValueError):
        sharded_warp_lk(z, z, z, z, mesh, max_disp=4, clamp=8.0)


def test_rejects_oversized_halo():
    mesh = _tmesh((1, 2, 4))
    z = torch.zeros(32, 64)  # 16x16 tiles
    with pytest.raises(ValueError):  # gather halo ceil(40/2)+1 = 21 > 16
        sharded_symmetric_warp(z, z, z, z, mesh, 40.0)
    with pytest.raises(ValueError):  # K4 halo C+2 = 18 > 16
        sharded_warp_lk(z, z, z, z, mesh, max_disp=16, clamp=32.0)
    with pytest.raises(ValueError):  # K3 coarse row halo 5 > 8 / 2
        sharded_pyrup_warp_lk(torch.zeros(16, 64), torch.zeros(16, 64), torch.zeros(8, 32),
                              torch.zeros(8, 32), mesh, max_disp=4, clamp=8.0)


def test_rejects_a_mesh_off_the_pipeline_device():
    _, tf = _video_configs()
    mesh = flow_mesh(1, 2, 2, devices=["meta"] * 4)
    with pytest.raises(ValueError):
        TVideoPipeline(tf, device="cpu", mesh=mesh)
    z = torch.zeros(64, 64)
    with pytest.raises(ValueError):  # inputs off the mesh's home device
        sharded_coarse_to_fine(z, z, mesh, 2, config=tf.flow)


def test_rejects_shift_warp():
    """The exact 'shift' tile warp is ported; it still refuses a reach its
    halo cannot ship, a configuration without warp_clamp and an unknown
    form."""
    mesh = _tmesh((1, 2, 2))
    z = torch.zeros(64, 64)  # 32x32 tiles
    with pytest.raises(ValueError):  # halo ceil(80/2)+1 = 41 > 32
        sharded_symmetric_warp(z, z, z, z, mesh, 80.0, impl="shift")
    with pytest.raises(ValueError):
        sharded_symmetric_warp(z, z, z, z, mesh, 8.0, impl="nearest")
    cfg = t_config.FlowConfig(mode="corrected", warp_impl="shift")
    with pytest.raises(ValueError):
        sharded_coarse_to_fine(z, z, mesh, 2, config=cfg)


@pytest.mark.parametrize("level_iters", [1, 2])
def test_sharded_controller_shift_equals_unsharded(level_iters):
    """The mesh controller with warp_impl='shift' on a CPU 2x2 mesh: the
    tiled exact shift warp and the tiled LK equal the unsharded controller
    bit for bit."""
    rng = np.random.RandomState(7)
    a = rng.rand(64, 128).astype(np.float32)
    b = np.roll(a, (1, 2), (-2, -1)) + 0.05 * rng.rand(64, 128).astype(np.float32)
    cfg = t_config.FlowConfig(mode="corrected", warp_clamp=6.0, warp_impl="shift",
                              level_iters=level_iters)
    u0, v0 = coarse_to_fine(_t(a), _t(b), 3, config=cfg)
    u, v = sharded_coarse_to_fine(_t(a), _t(b), _tmesh((1, 2, 2)), 3, config=cfg, min_tile=16)
    assert torch.equal(u, u0) and torch.equal(v, v0)


# ------------------------------------------------------------------- P1


def test_mesh_probe_on_cpu_mesh_launches_nothing():
    before = kernels.launch_counts()
    assert mesh_probe(_tmesh((2, 2, 2))) is True
    assert mesh_probe(_tmesh((1, 2, 4))) is True
    assert kernels.launch_counts() == before


def test_sharded_ops_raise_when_the_probe_fails(monkeypatch):
    monkeypatch.setattr(vma_compat, "mesh_probe", lambda mesh: False)
    z = torch.zeros(64, 64)
    with pytest.raises(RuntimeError):
        sharded_lucas_kanade(z, z, _tmesh((1, 2, 2)))
    with pytest.raises(RuntimeError):
        sharded_warp_lk(z, z, z, z, _tmesh((1, 2, 2)), max_disp=4, clamp=8.0)


# ---------------------------------------------------- on the card (marked)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _counted(name, fn, n=1):
    before = kernels.launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + n
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("size", [1080, 540])
def test_k5_on_card_equals_plain_and_full_frame(cuda_device, size):
    """K3/K4 tile mode on the 2x2 grid against the plain tile mode (phase
    3's tolerance) and against the full-frame kernel's region (bit for bit)."""
    from optical_flow_tpu_torch.ops.pyramid import pyr_up_cols_first

    mesh = _tmesh((1, 2, 2), cuda_device)
    C, clamp = 4, 8.0
    rng = np.random.RandomState(size)
    a, b = (_t(rng.rand(size, size)).to(cuda_device) for _ in range(2))
    uc, vc = (_t(rng.randn(size // 2, size // 2) * 2).to(cuda_device) for _ in range(2))
    full = pyrup_warp_lk_cuda(a, b, uc, vc, max_disp=C, clamp=clamp)
    tiled = _counted("oft_pyrup_warp_lk_tile",
                     lambda: sharded_pyrup_warp_lk(a, b, uc, vc, mesh, max_disp=C, clamp=clamp), 4)
    for x, y in zip(full, tiled):
        assert torch.equal(x, y)
    upu, upv = 2.0 * pyr_up_cols_first(uc), 2.0 * pyr_up_cols_first(vc)
    wu, wv = -upu.clamp(-clamp, clamp), -upv.clamp(-clamp, clamp)
    full = warp_lk_cuda(a, b, wu, wv, max_disp=C, clamp=clamp, negate=False)
    tiled = _counted("oft_warp_lk_tile",
                     lambda: sharded_warp_lk(a, b, wu, wv, mesh, max_disp=C, clamp=clamp), 4)
    for x, y in zip(full, tiled):
        assert torch.equal(x, y)
    # each tile against the plain tile mode on the same extended tile
    h = size // 2
    ext = [t_halo.exchange_halo(split(x, mesh), C + 2, border="zero") for x in (a, b, wu, wv)]
    ok = _ok_mask(*symmetric_warp(a, b, wu, wv, impl="shift_sep", max_disp=C))
    for idx in np.ndindex(ext[0].shape):
        tile = dict(halo=C + 2, origin=(idx[1] * h, idx[2] * h), global_hw=(size, size))
        got = warp_lk_cuda(*(e[idx] for e in ext), max_disp=C, clamp=clamp, negate=False, **tile)
        want = warp_lk_plain(*(e[idx] for e in ext), max_disp=C, clamp=clamp, negate=False, **tile)
        region = (slice(idx[1] * h, idx[1] * h + h), slice(idx[2] * h, idx[2] * h + h))
        z = torch.zeros((), device=cuda_device)
        for g, w in zip(got, want):
            torch.testing.assert_close(torch.where(ok[region], g, z), torch.where(ok[region], w, z),
                                       atol=2e-5, rtol=0)


@pytest.mark.cuda
def test_mesh_probe_on_card_launches_once_per_tile(cuda_device):
    mesh = _tmesh((1, 2, 2), cuda_device)
    assert _counted("oft_tile_copy", lambda: mesh_probe(mesh), 4) is True
    assert _counted("oft_tile_copy", lambda: mesh_probe(mesh), 0) is True  # cached


@pytest.mark.cuda
def test_sharded_controller_on_card_equals_unsharded(cuda_device):
    rng = np.random.RandomState(8)
    a = _t(rng.rand(540, 540)).to(cuda_device)
    b = torch.roll(a, (1, 2), (-2, -1))
    cfg = t_config.FlowConfig(mode="corrected", warp_clamp=8.0, warp_impl="shift_sep",
                              level_iters=2, pyr_impl="auto")
    u0, v0 = coarse_to_fine(a, b, 3, config=cfg)
    u, v = sharded_coarse_to_fine(a, b, _tmesh((1, 2, 2), cuda_device), 3, config=cfg)
    assert torch.equal(u, u0) and torch.equal(v, v0)
