"""The port's mesh across processes (optical_flow_tpu_torch/parallel/
distributed.py, the rank-aware mesh of parallel/mesh.py and halo.py) and
dryrun_multichip, on the CPU.

  global_flow_mesh        the axis sizes of JAX's global_flow_mesh on the 8
                          virtual CPU devices of tests/conftest.py, case by
                          case, and the same ValueErrors
  host_local_frames       tests/test_distributed.py:25-28
  make_global_batch       one process: the local frames stacked, on the mesh
  two processes           this file run as its own worker (``python
                          tests/test_torch_distributed.py PORT RANK``): two
                          ranks of 4 CPU slots each joined over gloo on a
                          localhost port, the checks of the JAX package's
                          tests/_distributed_worker.py held against the
                          port's single-process results: sharded LK bit for
                          bit, a global mean across ranks within 1e-9,
                          sharded_coarse_to_fine on a (1, 2, 4) mesh whose
                          rows lie on different ranks bit for bit, both
                          sharded solvers within 1e-6
  dryrun_multichip        its three legs on 4 and 8 CPU slots
  the backend choice      initialize_distributed in two threads (two ranks)
                          with the card count and each rank's hostname
                          patched and the group's creation recorded: a
                          host's ranks counted at the coordinator's store
"""

import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from optical_flow_tpu_torch.parallel import distributed as tdist
from optical_flow_tpu_torch.parallel.mesh import Remote, split

WORKER_TIMEOUT_S = 120
MESH_CASES = [
    dict(),
    dict(frames=4),
    dict(frames=4, rows=2),
    dict(rows=2),
    dict(cols=8),
    dict(frames=1, rows=2, cols=4),
    dict(frames=2, rows=2, cols=2),
    dict(frames=8, rows=1, cols=1),
]
MESH_ERRORS = [dict(frames=0), dict(rows=-1), dict(frames=3), dict(rows=3, cols=1),
               dict(frames=2, rows=2, cols=1), dict(frames=1, rows=1, cols=16)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops: one intra-op thread each keeps them from spinning against
    the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _axes_id(axes):
    return "-".join(f"{k}{v}" for k, v in axes.items()) or "free"


@pytest.mark.parametrize("axes", MESH_CASES, ids=_axes_id)
def test_global_flow_mesh_matches_jax(axes):
    from optical_flow_tpu.parallel.distributed import global_flow_mesh as j_global_flow_mesh

    mesh = tdist.global_flow_mesh(**axes, devices=["cpu"] * 8)
    assert mesh.shape == dict(j_global_flow_mesh(**axes).shape)
    assert mesh.size == 8 and not mesh.across_processes and mesh.home == torch.device("cpu")


@pytest.mark.parametrize("axes", MESH_ERRORS, ids=_axes_id)
def test_global_flow_mesh_raises_as_jax(axes):
    from optical_flow_tpu.parallel.distributed import global_flow_mesh as j_global_flow_mesh

    with pytest.raises(ValueError) as jerr:
        j_global_flow_mesh(**axes)
    with pytest.raises(ValueError) as terr:
        tdist.global_flow_mesh(**axes, devices=["cpu"] * 8)
    assert str(terr.value) == str(jerr.value)


def test_host_local_frames_partition():
    frames = [np.full((2, 2), i) for i in range(10)]
    mine = list(tdist.host_local_frames(frames, process_id=1, process_count=3))
    assert [int(f[0, 0]) for f in mine] == [1, 4, 7]
    # without a group: rank 0 of 1 takes every frame
    assert len(list(tdist.host_local_frames(frames))) == 10


def test_make_global_batch_over_frames():
    mesh = tdist.global_flow_mesh(frames=4, rows=2, cols=1, devices=["cpu"] * 8)
    local = [np.random.RandomState(i).rand(16, 16).astype(np.float32) for i in range(4)]
    batch = tdist.make_global_batch(local, mesh)
    assert batch.shape == (4, 16, 16) and batch.device == mesh.home
    assert torch.equal(batch, torch.from_numpy(np.stack(local)))


def test_initialize_distributed_is_a_no_op_without_a_launch(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert tdist.initialize_distributed() is None
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tdist.initialize_distributed() is None
    # a launch that claims two processes names its rank, or fails loudly
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError):
        tdist.initialize_distributed()
    assert not torch.distributed.is_initialized()
    assert tdist.choose_backend(1) == ("nccl" if torch.cuda.is_available() else "gloo")
    assert tdist.choose_backend(torch.cuda.device_count() + 1) == "gloo"


LAUNCHES = {  # rank hostnames, boot ids, cards a host, coordinator?, LOCAL_WORLD_SIZE
    #              -> backend, cards bound
    "one-host-2-cards": (("a", "a"), ("1", "1"), 2, True, None, "nccl", [0, 1]),
    "two-hosts-1-card-each": (("a", "b"), ("1", "2"), 1, True, None, "nccl", [0, 0]),
    # two sandboxed machines that report one hostname
    "two-hosts-one-hostname": (("runsc", "runsc"), ("1", "2"), 1, True, None, "nccl", [0, 0]),
    "one-card-2-ranks": (("a", "a"), ("1", "1"), 1, True, None, "gloo", [0, 0]),
    "env-local-world-1": (("a", "b"), ("1", "2"), 1, False, "1", "nccl", [0, 0]),
}


@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_backend_choice_counts_each_hosts_ranks(monkeypatch, launch):
    """Two ranks launched as the JAX package's tests/_distributed_worker.py
    launches them (coordinator_address, num_processes, process_id; no
    torchrun variables): NCCL wherever each rank bound a card of its own,
    gloo where two ranks share one, whatever the hostnames say; without a
    coordinator LOCAL_WORLD_SIZE counts the host's ranks."""
    hosts, boots, cards, coordinator, local_world, want, want_cards = LAUNCHES[launch]
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                 "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    if local_world is not None:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local_world)
    bound, made, errors = {}, {}, []

    def rank_of_thread():
        return int(threading.current_thread().name)

    def card_id():  # a card is its machine's (hostname, boot id) and its index
        r = rank_of_thread()
        return f"{hosts[r]}/{boots[r]}/gpu{bound[r]}"

    def init_process_group(backend, store=None, world_size=None, rank=None, timeout=None):
        # the group keeps its store: rank 0 serves it until every rank is done
        made[rank] = (backend, store, world_size)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: bound.__setitem__(rank_of_thread(), i))
    monkeypatch.setattr(tdist, "_hostname", lambda: hosts[rank_of_thread()])
    monkeypatch.setattr(tdist, "_boot_id", lambda: boots[rank_of_thread()])
    monkeypatch.setattr(tdist, "_card_id", card_id)
    monkeypatch.setattr(tdist.dist, "init_process_group", init_process_group)
    monkeypatch.setattr(tdist.dist, "get_world_size", lambda: 2)

    got = {}

    def run(r):
        try:
            got[r] = tdist.initialize_distributed(
                f"127.0.0.1:{port}" if coordinator else None, 2, r)
        except Exception as e:  # reported below, with the rank
            errors.append((r, repr(e)))

    threads = [threading.Thread(target=run, args=(r,), name=str(r)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert got == {0: want, 1: want}
    assert {r: (b, store is not None, w) for r, (b, store, w) in made.items()} == {
        r: (want, coordinator, 2) for r in range(2)}
    assert [bound[r] for r in range(2)] == want_cards


def test_split_keeps_this_process_tiles():
    """A mesh whose slots name another rank: split keeps this process's
    tiles and marks the others ``Remote``."""
    from optical_flow_tpu_torch.parallel.mesh import FlowMesh

    devices = np.array([torch.device("cpu")] * 4, dtype=object).reshape(1, 2, 2)
    mesh = FlowMesh(devices, np.array([0, 0, 1, 1]), rank=1)
    assert mesh.across_processes and mesh.local_slots() == [2, 3]
    grid = split(torch.arange(32.0).reshape(4, 8), mesh)
    assert grid[0, 0, 0] == Remote(0) and grid[0, 0, 1] == Remote(0)
    assert torch.equal(grid[0, 1, 1], torch.arange(32.0).reshape(4, 8)[2:, 4:])
    with pytest.raises(ValueError):  # a rank that holds no slot
        FlowMesh(devices, np.zeros(4), rank=1)


def test_two_processes_match_one():
    """Two ranks over gloo on localhost run the JAX worker's legs; each
    checks its results against the port's single-process ones."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(port), str(rank)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S))
    except subprocess.TimeoutExpired:
        pytest.fail(f"distributed workers timed out; partial: {outs}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} rc={p.returncode}\n{out}\n{err[-4000:]}"
        assert f"WORKER_OK {rank} backend=gloo" in out, (out, err[-4000:])


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_on_cpu_slots(n):
    from optical_flow_tpu_torch.dryrun import dryrun_multichip

    r = dryrun_multichip(n, devices=["cpu"] * n)
    assert r["mesh"]["frames"] == 2 and r["flow_shape"] == (4, 64, 64)
    assert r["vi_states"] == (4, 15) and r["tracked"] > 0
    hist = np.asarray(r["vi_history"])
    assert np.isfinite(hist).all() and hist[-1, 0] < hist[0, 0]


# ----------------------------------------------------------------- worker


def ba_scene(C=4, P=32, seed=7, focal=400.0):
    """tests/_distributed_worker.py's BA scene: every point seen by every
    camera, observations noisy, cameras and points perturbed (float64)."""
    rng = np.random.RandomState(seed)
    pts = np.stack([rng.randn(P) * 1.5, rng.randn(P), rng.uniform(4, 9, P)], axis=1)
    cams = np.zeros((C, 6))
    cams[:, 3] = np.arange(C) * 0.3
    ci, pi = np.repeat(np.arange(C), P), np.tile(np.arange(P), C)
    Xc = pts[pi] + cams[ci, 3:]
    obs = focal * Xc[:, :2] / Xc[:, 2:3] + rng.randn(C * P, 2) * 0.1
    return (cams, cams + rng.randn(C, 6) * 0.01, pts + rng.randn(P, 3) * 0.05, ci, pi, obs, focal,
            rng)


def shard_by_point(ci, pi, obs, n):
    """Observations grouped by owning shard, pt_idx local to it."""
    order = np.argsort(pi, kind="stable")
    return ci[order], pi[order] % (len(np.unique(pi)) // n), obs[order]


def _worker(port: int, rank: int) -> None:
    from optical_flow_tpu_torch.config import FlowConfig
    from optical_flow_tpu_torch.flow.coarse_to_fine import coarse_to_fine
    from optical_flow_tpu_torch.flow.lk import lucas_kanade
    from optical_flow_tpu_torch.parallel import (
        flow_mesh,
        sharded_coarse_to_fine,
        sharded_lucas_kanade,
    )
    from optical_flow_tpu_torch.parallel.mesh import local_indices, psum, wire_counts
    from optical_flow_tpu_torch.slam.ba import BAProblem, bundle_adjust, sharded_bundle_adjust
    from optical_flow_tpu_torch.slam.vi_ba import (
        VIBAProblem,
        sharded_vi_bundle_adjust,
        vi_bundle_adjust,
    )

    torch.set_num_threads(1)
    world = 2
    backend = tdist.initialize_distributed(f"localhost:{port}", world, rank)
    assert backend == "gloo" and torch.distributed.get_rank() == rank
    assert tdist.initialize_distributed(f"localhost:{port}", world, rank) == "gloo"  # a no-op
    cpu = ["cpu"] * 4

    # frames ride the cross-process axis: rank r holds frame indices 2r, 2r+1
    mesh = tdist.global_flow_mesh(frames=2 * world, rows=2, cols=1, devices=cpu)
    assert mesh.ranks.reshape(-1).tolist() == [0] * 4 + [1] * 4 and mesh.rank == rank
    rng = np.random.RandomState(42)
    all_frames = [rng.rand(64, 128).astype(np.float32) for _ in range(4 * world)]
    local = list(tdist.host_local_frames(all_frames))
    assert len(local) == 4 and np.array_equal(local[0], all_frames[rank])
    img1, img2 = tdist.make_global_batch(local[:2], mesh), tdist.make_global_batch(local[2:], mesh)
    want1 = np.stack([all_frames[p + world * i] for p in range(world) for i in range(2)])
    assert img1.shape == (2 * world, 64, 128) and np.array_equal(img1.numpy(), want1)

    u, v = sharded_lucas_kanade(img1, img2, mesh)
    ou, ov = lucas_kanade(img1, img2)
    assert torch.equal(u, ou) and torch.equal(v, ov), "sharded LK across ranks"
    one = flow_mesh(2 * world, 2, 1, devices=["cpu"] * 8)
    su, sv = sharded_lucas_kanade(img1, img2, one)
    assert torch.equal(u, su) and torch.equal(v, sv)

    # a global mean across ranks: this rank's tiles summed, then all_reduce
    tiles = split(u.double(), mesh)
    total = psum([tiles[idx].sum() for idx in local_indices(tiles)], mesh)
    gm = float(total) / u.numel()
    assert abs(gm - float(ou.double().mean())) < 1e-9, (gm, float(ou.double().mean()))

    # the sharded pyramid with tiled warps: rows on different ranks, so every
    # row halo (LK stencils, shift_sep warps) crosses the process boundary
    mesh_sp = tdist.global_flow_mesh(frames=1, rows=2, cols=2 * world, devices=cpu)
    assert mesh_sp.ranks[0, 0].tolist() == [0] * 4 and mesh_sp.ranks[0, 1].tolist() == [1] * 4
    ia, ib = torch.from_numpy(all_frames[0]), torch.from_numpy(all_frames[1])
    cfg = FlowConfig(warp_clamp=4.0, warp_impl="shift_sep")
    sent = wire_counts()["bytes"]
    u2, v2 = sharded_coarse_to_fine(ia, ib, mesh_sp, 2, config=cfg, min_tile=8)
    assert wire_counts()["bytes"] > sent
    ou2, ov2 = coarse_to_fine(ia, ib, 2, config=cfg)
    assert torch.equal(u2, ou2) and torch.equal(v2, ov2), "sharded_coarse_to_fine across ranks"

    # bundle adjustment: points and observations over the 8 slots of both
    # ranks, the camera system summed across them every iteration
    cams, cams_n, pts_n, ci, pi, obs, focal, rngb = ba_scene()
    n = mesh.size
    ci_s, pi_s, obs_s = shard_by_point(ci, pi, obs, n)
    t = torch.from_numpy
    prob_s = BAProblem(t(cams_n), t(pts_n), t(ci_s), t(pi_s), t(obs_s), focal)
    out, hist = sharded_bundle_adjust(prob_s, mesh, iters=3, lam=1e-3)
    flat, flat_hist = bundle_adjust(BAProblem(t(cams_n), t(pts_n), t(ci), t(pi), t(obs), focal),
                                    iters=3, lam=1e-3)
    assert float((out.cams - flat.cams).abs().max()) < 1e-6
    assert float((out.points - flat.points).abs().max()) < 1e-6
    assert float((hist - flat_hist).abs().max()) < 1e-6

    # visual-inertial BA: the same sharding, the IMU factors added once
    C, T_int, g_w = cams_n.shape[0], 0.5, np.array([0.0, -9.81, 0.0])
    centers = -cams[:, 3:]
    v_true = np.tile((centers[1] - centers[0]) / T_int, (C, 1))
    dp = np.stack([centers[i + 1] - centers[i] - v_true[i] * T_int - 0.5 * g_w * T_int ** 2
                   for i in range(C - 1)])
    states = np.concatenate([cams_n, v_true + rngb.randn(C, 3) * 0.02], -1)
    imu = dict(dR=t(np.tile(np.eye(3), (C - 1, 1, 1))), dv=t(np.tile(-g_w * T_int, (C - 1, 1))),
               dp=t(dp), interval_T=t(np.full(C - 1, T_int)), gravity=t(g_w), focal=focal)
    vi_s = VIBAProblem(states=t(states), points=t(pts_n), cam_idx=t(ci_s), pt_idx=t(pi_s),
                       obs=t(obs_s), **imu)
    vout, vhist = sharded_vi_bundle_adjust(vi_s, mesh, iters=3, lam=1e-3)
    vref, vref_hist = vi_bundle_adjust(vi_s._replace(cam_idx=t(ci), pt_idx=t(pi), obs=t(obs)),
                                       iters=3, lam=1e-3)
    assert float((vout.states - vref.states).abs().max()) < 1e-6
    assert float((vout.points - vref.points).abs().max()) < 1e-6
    assert float((vhist - vref_hist).abs().max()) < 1e-6 * float(vref_hist.abs().max())
    torch.distributed.destroy_process_group()
    print(f"WORKER_OK {rank} backend={backend}", flush=True)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]))
