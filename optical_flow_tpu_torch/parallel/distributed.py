"""Several processes as one mesh (port of
optical_flow_tpu/parallel/distributed.py).

A flow job across processes maps onto:
  - one process per card, joined by ``torch.distributed`` (the JAX package
    calls ``jax.distributed.initialize``);
  - a global (frames, rows, cols) mesh over every device of every process,
    in rank order (``global_flow_mesh``): each slot is held by its process,
    halo strips cross processes point to point and ``merge`` gathers
    (parallel/mesh.py);
  - frame input partitioned by process: process p takes frames p, p+P,
    p+2P, ... (``host_local_frames``) and hands them to
    ``make_global_batch``.

The backend follows from where the ranks run: NCCL where every rank of a
host has a card of its own, gloo on the CPU and where ranks share a card
(NCCL refuses two ranks on one GPU); under gloo, CUDA tensors cross through
pinned host memory. With a coordinator, the choice is made at the
rendezvous: each rank posts its host (hostname and boot id) to the
coordinator's store, binds a card by its index among its host's ranks, and
posts that card's UUID; two ranks that bound the same card get gloo, so two
hosts of one card each get NCCL without torchrun's variables. One process
works through the same entry points: without a group every slot is this
process's.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from optical_flow_tpu_torch.parallel.mesh import (
    AXIS_FRAMES,
    FlowMesh,
    gather_slots,
    mesh_factorization,
)
from optical_flow_tpu_torch.utils.device import canonical_device

# how long a rank waits for its peers, at the start and in every collective
TIMEOUT = datetime.timedelta(seconds=300)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def choose_backend(local_ranks: int) -> str:
    """'nccl' where each of a host's ``local_ranks`` ranks has a card of its
    own; 'gloo' on the CPU and where ranks would share a card."""
    if torch.cuda.is_available() and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _hostname() -> str:
    return socket.gethostname()


def _boot_id() -> str:
    """The kernel's boot id ('' where it cannot be read): sandboxes on two
    machines may share a hostname, not this."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            return f.read().strip()
    except OSError:
        return ""


def _card_id() -> str:
    """The UUID of the card this process has bound ('' without a card)."""
    if not torch.cuda.is_available():
        return ""
    i = torch.cuda.current_device()
    uuid = getattr(torch.cuda.get_device_properties(i), "uuid", None)
    return f"{_hostname()}/{_boot_id()}/{i}" if uuid is None else str(uuid)


def _exchange(store, tag: str, rank: int, world: int, value: str) -> list:
    """Every rank's ``value``, in rank order: each posts its own to
    ``store`` and reads the others'."""
    store.set(f"oft_{tag}/{rank}", value)
    keys = [f"oft_{tag}/{r}" for r in range(world)]
    store.wait(keys)
    return [store.get(k).decode() for k in keys]


def _host_ranks(store, rank: int, world: int) -> tuple:
    """(ranks on this host, this rank's index among them): a host is a
    hostname and a boot id."""
    hosts = _exchange(store, "host", rank, world, f"{_hostname()}/{_boot_id()}")
    mine = [r for r, h in enumerate(hosts) if h == hosts[rank]]
    return len(mine), mine.index(rank)


def _cards_backend(store, rank: int, world: int) -> str:
    """'nccl' where every rank has bound a card and no two the same one,
    else 'gloo': the UUIDs of the bound cards decide, not the hosts."""
    cards = _exchange(store, "card", rank, world, _card_id())
    return "nccl" if all(cards) and len(set(cards)) == world else "gloo"


def _coordinator_store(address: str, rank: int, world: int):
    """The rendezvous store on ``address`` ('host:port'): rank 0 serves it."""
    host, port = address.rsplit(":", 1)
    return dist.TCPStore(host.strip("[]"), int(port), world, is_master=rank == 0,
                         timeout=TIMEOUT)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Optional[str]:
    """Join this process to the group; returns the backend ('nccl' or
    'gloo'), or None where nothing was asked.

    A no-op when a group already exists (its backend is returned) or when
    nothing asks for more than one process (no arguments and no
    ``WORLD_SIZE`` above 1). ``coordinator_address`` ('host:port') is the
    rendezvous, a TCP store that rank 0 serves; without it torch's
    ``env://`` variables apply (``MASTER_ADDR``, ``MASTER_PORT``;
    ``WORLD_SIZE`` and ``RANK`` where the arguments leave them out). Each
    rank binds its card (``LOCAL_RANK``, else its index among its host's
    ranks, modulo the cards) before the group is made. With a coordinator,
    the ranks post to its store their host (hostname and boot id), to count
    a host's ranks, and then the UUID of the card each bound: NCCL where
    every rank bound a card of its own, gloo where two share one. Without
    one, ``LOCAL_WORLD_SIZE`` (else the world) counts a host's ranks against
    its cards. A launch that claims several processes and comes up with
    another count raises."""
    if dist.is_initialized():
        return dist.get_backend()
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    if coordinator_address is None and (world is None or world <= 1):
        return None  # one process; nothing to do
    rank = process_id if process_id is not None else _env_int("RANK")
    if world is None or rank is None:
        raise ValueError("a group needs num_processes and process_id (or WORLD_SIZE and RANK)")
    if coordinator_address is None:
        store = None
        local_ranks, host_index = _env_int("LOCAL_WORLD_SIZE") or world, rank
    else:
        store = _coordinator_store(coordinator_address, rank, world)
        local_ranks, host_index = _host_ranks(store, rank, world)
    local_rank = _env_int("LOCAL_RANK")
    local_rank = host_index if local_rank is None else local_rank
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    if store is None:
        backend = choose_backend(local_ranks)
    else:
        backend = _cards_backend(store, rank, world)
    # without a store, torch reads the env:// variables
    dist.init_process_group(backend, store=store, world_size=world, rank=rank, timeout=TIMEOUT)
    if dist.get_world_size() != world:
        got = dist.get_world_size()
        dist.destroy_process_group()
        raise RuntimeError(f"the launch claims {world} processes but the group has {got}")
    return backend


def _process() -> tuple:
    """(rank, world size) of this process: (0, 1) without a group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local_devices(devices: Optional[Sequence]) -> list:
    if devices is not None:
        return [canonical_device(d) for d in devices]
    if dist.is_initialized():
        return [canonical_device("cuda")]  # this rank's card
    if not torch.cuda.is_available():
        canonical_device("cuda")  # raises: no card, and none asked for
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def global_flow_mesh(
    frames: Optional[int] = None,
    rows: Optional[int] = None,
    cols: Optional[int] = None,
    *,
    devices: Optional[Sequence] = None,
) -> FlowMesh:
    """A mesh over every device of every process, in rank order.

    ``devices`` lists this process's devices (repeats allowed, as in
    ``flow_mesh``); the default is this rank's card in a group, else every
    card of this process. The lists are gathered with ``all_gather_object``.
    Unspecified axes are factorized from the remaining device count; an
    explicit axis is always honoured. Raises ValueError for an axis < 1, for
    axes that do not divide the device count and for full axes that do not
    cover it."""
    mine = _local_devices(devices)
    rank, world = _process()
    if world > 1:
        lists = [None] * world
        dist.all_gather_object(lists, [str(d) for d in mine])
    else:
        lists = [[str(d) for d in mine]]
    if any(len(ds) == 0 for ds in lists):
        raise ValueError(f"every process must bring a device: {lists}")
    names = [(r, d) for r, ds in enumerate(lists) for d in ds]
    n = len(names)
    spec = {"frames": frames, "rows": rows, "cols": cols}
    fixed = {k: v for k, v in spec.items() if v is not None}
    for k, v in fixed.items():
        if v < 1:
            raise ValueError(f"mesh axis {k}={v} must be >= 1")
    free = [k for k, v in spec.items() if v is None]
    prod = int(np.prod(list(fixed.values()))) if fixed else 1
    if n % prod:
        raise ValueError(f"specified mesh axes {fixed} do not divide {n} devices")
    rem = n // prod
    if not free:
        if prod != n:
            raise ValueError(f"mesh {fixed} covers {prod} of {n} devices")
    elif len(free) == 1:
        spec[free[0]] = rem
    else:
        # the 3-way factorization of the remainder, its extra factor folded
        # into the first free axis
        f3 = mesh_factorization(rem)
        if len(free) == 2:
            spec[free[0]] = f3[0] * f3[1]
            spec[free[1]] = f3[2]
        else:
            spec["frames"], spec["rows"], spec["cols"] = f3
    shape = (spec["frames"], spec["rows"], spec["cols"])
    grid = np.empty(n, dtype=object)
    mine_iter = iter(mine)
    for i, (r, d) in enumerate(names):
        grid[i] = next(mine_iter) if r == rank else torch.device(d)
    ranks = np.array([r for r, _ in names], dtype=np.int64)
    return FlowMesh(grid.reshape(shape), ranks.reshape(shape), rank)


def host_local_frames(
    frames: Iterable[np.ndarray],
    *,
    process_id: Optional[int] = None,
    process_count: Optional[int] = None,
) -> Iterator[np.ndarray]:
    """Round-robin frame partition across processes: process p takes frames
    p, p+P, p+2P, ... (each process runs its own decoder over the same
    input). Defaults from the group (rank 0 of 1 without one)."""
    rank, world = _process()
    p = rank if process_id is None else process_id
    P = world if process_count is None else process_count
    for i, frame in enumerate(frames):
        if i % P == p:
            yield frame


def make_global_batch(local_frames: Sequence, mesh: FlowMesh) -> torch.Tensor:
    """Each process's local frames as its share of one global (B, H, W)
    batch split over the mesh's frames axis, on the home device of every
    process (the sharded controller's input).

    A process's frames fill, in order, the frame indices at which it holds
    a slot, in equal parts; where several processes hold slots of one frame
    index, its frames are the lowest rank's (each passes the same frames
    there, as ``jax.make_array_from_process_local_data`` requires). Every
    process passes the same number of frames."""
    local = torch.stack([torch.as_tensor(np.asarray(f)) if not isinstance(f, torch.Tensor) else f
                         for f in local_frames]).to(mesh.home)
    if not mesh.across_processes:
        return local
    f = mesh.shape[AXIS_FRAMES]
    held = [sorted({i for i in range(f) if (mesh.ranks[i] == r).any()})
            for r in range(int(mesh.ranks.max()) + 1)]
    shapes = [None] * dist.get_world_size()
    dist.all_gather_object(shapes, tuple(local.shape))
    if len(set(shapes)) != 1:
        raise ValueError(f"processes pass local batches of different shapes: {shapes}")
    n_local = local.shape[0]
    if any(n_local % len(h) for h in held):
        raise ValueError(f"{n_local} local frames do not divide over the frame indices each "
                         f"process holds: {held}")
    everyone = gather_slots([local], np.arange(len(shapes)), mesh)
    parts = []
    for i in range(f):
        owner = int(mesh.ranks[i].min())
        per, k = n_local // len(held[owner]), held[owner].index(i)
        parts.append(everyone[owner][k * per : (k + 1) * per])
    return torch.cat(parts)
