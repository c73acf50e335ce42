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
pinned host memory. One process works through the same entry points:
without a group every slot is this process's.
"""

from __future__ import annotations

import datetime
import os
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


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Optional[str]:
    """Join this process to the group; returns the backend ('nccl' or
    'gloo'), or None where nothing was asked.

    A no-op when a group already exists (its backend is returned) or when
    nothing asks for more than one process (no arguments and no
    ``WORLD_SIZE`` above 1). ``coordinator_address`` ('host:port') becomes
    a ``tcp://`` rendezvous; without it torch's ``env://`` variables apply
    (``MASTER_ADDR``, ``MASTER_PORT``; ``WORLD_SIZE`` and ``RANK`` where the
    arguments leave them out). Each rank binds its card (``LOCAL_RANK``,
    else its rank, modulo the cards) before the group is made. A launch
    that claims several processes and comes up with another count raises."""
    if dist.is_initialized():
        return dist.get_backend()
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    if coordinator_address is None and (world is None or world <= 1):
        return None  # one process; nothing to do
    rank = process_id if process_id is not None else _env_int("RANK")
    if world is None or rank is None:
        raise ValueError("a group needs num_processes and process_id (or WORLD_SIZE and RANK)")
    local_rank = _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    local_ranks = _env_int("LOCAL_WORLD_SIZE") or world
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    backend = choose_backend(local_ranks)
    init = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=TIMEOUT)
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
