"""The device mesh of the flow engine, as a grid of ``torch.device``s.

Mesh axes (config.MeshConfig):
  frames: data parallelism over frame pairs (the batch),
  rows / cols: 2-D spatial tiling of each image.

The JAX package runs one controller over a ``jax.sharding.Mesh`` under
``shard_map``. The port keeps the controller: a ``FlowMesh`` is a
``(frames, rows, cols)`` grid of devices, which may repeat a device (a 2x2
tile grid runs whole on one card), and each slot names the process (its
rank in the ``torch.distributed`` group) that holds it. ``shard_map``'s
in_specs and out_specs become two explicit functions: ``split`` cuts a
global tensor into a grid of tiles and keeps this process's, each moved to
its device (another process's slot holds a ``Remote`` marker), and
``merge`` puts a grid back together on this process's home device, where
the global ops run. Across processes ``merge`` is a gather, so every
process holds the global tensor: XLA's replicated semantics. ``psum``
sums per-slot tensors over the mesh (this process's slots, then an
``all_reduce`` across processes).

On one process every slot is rank 0 and nothing crosses a process. Where
the group's backend takes only host tensors (gloo), CUDA tensors cross it
through pinned host memory.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from optical_flow_tpu_torch.utils.device import canonical_device

AXIS_FRAMES = "frames"
AXIS_ROWS = "rows"
AXIS_COLS = "cols"


def mesh_factorization(n: int) -> Tuple[int, int, int]:
    """Pick a (frames, rows, cols) factorization of n devices.

    Heuristic: prefer a square-ish spatial grid (rows x cols) with frames
    soaking up the leftover factor — spatial tiling is the scaling story for
    one large frame; frames scale throughput.
    """
    if n <= 0:
        raise ValueError(f"need >= 1 device, got {n}")
    best = (n, 1, 1)
    for rows in range(1, n + 1):
        if n % rows:
            continue
        rest = n // rows
        for cols in range(1, rest + 1):
            if rest % cols:
                continue
            frames = rest // cols
            # score: prefer rows*cols big, rows ~ cols
            spatial = rows * cols
            score = (spatial, -abs(rows - cols))
            if score > (best[1] * best[2], -abs(best[1] - best[2])):
                best = (frames, rows, cols)
    return best


class Remote(NamedTuple):
    """A grid slot held by another process: its rank."""

    rank: int


class FlowMesh:
    """A (frames, rows, cols) grid of devices, each slot held by a process.

    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh.shape``
    does. ``ranks`` is the grid of the processes that hold the slots (all 0
    on one process) and ``rank`` this process's; ``home`` is the device of
    this process's first slot (``devices[0, 0, 0]`` on one process). A
    slot's device is named as its own process names it. Meshes compare by
    identity, so the probe of parallel/vma_compat.py runs once per mesh.
    """

    def __init__(self, devices: np.ndarray, ranks: Optional[np.ndarray] = None, rank: int = 0):
        if devices.ndim != 3 or devices.size == 0:
            raise ValueError(f"devices must be a non-empty 3-D grid, got shape {devices.shape}")
        self.devices = devices
        f, r, c = devices.shape
        self.shape: Dict[str, int] = {AXIS_FRAMES: f, AXIS_ROWS: r, AXIS_COLS: c}
        self.ranks = (np.zeros(devices.shape, dtype=np.int64) if ranks is None
                      else np.asarray(ranks, dtype=np.int64).reshape(devices.shape))
        self.rank = rank
        mine = self.local_slots()
        if not mine:
            raise ValueError(f"rank {rank} holds no slot of the mesh")
        self.home: torch.device = devices.flat[mine[0]]

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def across_processes(self) -> bool:
        """Whether another process holds a slot."""
        return bool((self.ranks != self.rank).any())

    def local_slots(self) -> List[int]:
        """Flat indices (``devices.flat`` order) of this process's slots."""
        return [int(i) for i in np.flatnonzero(self.ranks.reshape(-1) == self.rank)]

    def __repr__(self) -> str:
        ranks = "" if not self.across_processes else f", ranks={self.ranks.reshape(-1).tolist()}"
        return f"FlowMesh({self.shape}, devices={[str(d) for d in self.devices.flat]}{ranks})"


def flow_mesh(
    frames: int = 1,
    rows: int = 1,
    cols: int = 1,
    *,
    devices: Optional[Sequence] = None,
) -> FlowMesh:
    """A (frames, rows, cols) mesh over the first frames*rows*cols entries
    of ``devices`` (default: the card, repeated over the grid; without a
    card this raises). Repeats are allowed; a list shorter than the grid
    is an error."""
    n = frames * rows * cols
    if n <= 0:
        raise ValueError(f"mesh axes must be >= 1, got {(frames, rows, cols)}")
    devices = ["cuda"] * n if devices is None else list(devices)
    if len(devices) < n:
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devices[:n]):
        grid[i] = canonical_device(d)
    return FlowMesh(grid.reshape(frames, rows, cols))


# ------------------------------------------------------------------ wire
#
# What crosses a process. Collectives run on the default group; the bytes
# this process hands to it are counted (``wire_counts``).

_WIRE = {"bytes": 0}


def wire_counts() -> Dict[str, int]:
    """Bytes this process handed to the group since the last
    ``reset_wire_counts``."""
    return dict(_WIRE)


def reset_wire_counts() -> None:
    _WIRE["bytes"] = 0


def _staged(t: torch.Tensor) -> bool:
    """Whether ``t`` crosses the group through host memory: gloo takes host
    tensors only."""
    return t.is_cuda and dist.get_backend() == "gloo"


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, as the group's backend takes it (a pinned host copy
    of a CUDA tensor under gloo), counted in ``wire_counts``."""
    _WIRE["bytes"] += t.numel() * t.element_size()
    if _staged(t):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t)
    return t.contiguous()


def _wire_buffer(shape, like: torch.Tensor) -> torch.Tensor:
    """An empty buffer for ``like``'s kind of tensor to arrive in."""
    if _staged(like):
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def exchange(sends, recvs) -> List[torch.Tensor]:
    """Point-to-point strips between processes, posted as one batch.

    sends: (tensor, to_rank, tag); recvs: (shape, like, from_rank, tag),
    ``like`` a tensor of the dtype and device the strip arrives on. Every
    process lists its messages in one order that all agree on (a walk over
    the grid's slots), so each pair of processes posts its sends and
    receives in the same order (NCCL matches by order, gloo by tag).
    Returns the received tensors on their devices."""
    ops = [dist.P2POp(dist.isend, _to_wire(t), peer, tag=tag) for t, peer, tag in sends]
    bufs = [_wire_buffer(shape, like) for shape, like, _, _ in recvs]
    ops += [dist.P2POp(dist.irecv, b, peer, tag=tag) for b, (_, _, peer, tag) in zip(bufs, recvs)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [b.to(like.device) for b, (_, like, _, _) in zip(bufs, recvs)]


def psum(values: Sequence[torch.Tensor], mesh: "FlowMesh") -> torch.Tensor:
    """The sum over the mesh's slots of one tensor a slot: ``values`` holds
    this process's slots' tensors (one shape, any devices), summed in slot
    order on the home device, then across processes by ``all_reduce`` (JAX's
    ``lax.psum`` over every mesh axis)."""
    total = values[0].to(mesh.home)
    for v in values[1:]:
        total = total + v.to(mesh.home)
    if not mesh.across_processes:
        return total
    w = _to_wire(total)
    dist.all_reduce(w)
    return w.to(mesh.home)


def gather_slots(values: Sequence[torch.Tensor], ranks: np.ndarray,
                 mesh: "FlowMesh") -> List[torch.Tensor]:
    """One tensor a slot, for the slots whose processes ``ranks`` lists in
    order, on the home device: ``values`` holds this process's slots'
    tensors (one shape), the others arrive by ``all_gather``."""
    mine = [v.to(mesh.home) for v in values]
    if not mesh.across_processes:
        return mine
    per_rank = np.bincount(ranks, minlength=dist.get_world_size())
    pad = int(per_rank.max()) - len(mine)
    packed = torch.stack(mine + [torch.zeros_like(mine[0])] * pad)
    w = _to_wire(packed)
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, w)
    seen = np.zeros(len(per_rank), dtype=np.int64)
    out = []
    for r in ranks:
        out.append(parts[r][seen[r]].to(mesh.home))
        seen[r] += 1
    return out


# ------------------------------------------------------------------ grids
#
# A grid is an object array of tensors: (frames, rows, cols) for a batched
# (B, H, W) tensor, B split over frames; (1, rows, cols) for an (H, W) one,
# on the devices of frame index 0. Another process's slot holds ``Remote``.


def _grid(shape) -> np.ndarray:
    return np.empty(shape, dtype=object)


def local_indices(grid: np.ndarray):
    """The indices of this process's tiles, in grid order."""
    return [idx for idx in np.ndindex(grid.shape) if not isinstance(grid[idx], Remote)]


def grid_like(grid: np.ndarray) -> np.ndarray:
    """An empty grid of ``grid``'s shape with its ``Remote`` markers, for
    this process's tiles to be filled in."""
    out = _grid(grid.shape)
    for idx in np.ndindex(grid.shape):
        if isinstance(grid[idx], Remote):
            out[idx] = grid[idx]
    return out


def grid_map(fn: Callable, *grids: np.ndarray) -> np.ndarray:
    """``fn`` applied tile by tile over this process's tiles; a tuple result
    gives a tuple of grids."""
    results = {idx: fn(*(g[idx] for g in grids)) for idx in local_indices(grids[0])}
    first = next(iter(results.values()))
    n_out = len(first) if isinstance(first, tuple) else 0
    outs = [grid_like(grids[0]) for _ in range(max(n_out, 1))]
    for idx, r in results.items():
        for o, x in zip(outs, r if n_out else (r,)):
            o[idx] = x
    return tuple(outs) if n_out else outs[0]


def tile_origin(grid: np.ndarray, idx) -> Tuple[int, int]:
    """Global (row, col) of tile ``idx`` = (frame, row, col) of a grid of
    equal tiles."""
    t = grid[idx]
    return idx[1] * t.shape[-2], idx[2] * t.shape[-1]


def split(x: torch.Tensor, mesh: FlowMesh) -> np.ndarray:
    """Cut a global (H, W) or (B, H, W) tensor into the mesh's grid of
    tiles and keep this process's, each moved to its device (B over frames,
    H over rows, W over cols; each must divide evenly)."""
    f, r, c = mesh.devices.shape
    if x.ndim not in (2, 3):
        raise ValueError(f"split takes (H, W) or (B, H, W), got {tuple(x.shape)}")
    if x.ndim == 2:
        f = 1
    H, W = x.shape[-2], x.shape[-1]
    B = x.shape[0] if x.ndim == 3 else 1
    if H % r or W % c or B % f:
        raise ValueError(f"{tuple(x.shape)} does not divide over the mesh {mesh.shape}")
    h, w, b = H // r, W // c, B // f
    if set(mesh.ranks[:f].reshape(-1).tolist()) != set(mesh.ranks.reshape(-1).tolist()):
        raise ValueError(f"every process must hold a tile of {tuple(x.shape)}: frame index 0 "
                         f"of {mesh} leaves one out (give a (B, H, W) batch)")
    grid = _grid((f, r, c))
    for idx in np.ndindex(grid.shape):
        owner = int(mesh.ranks[idx])
        if owner != mesh.rank:
            grid[idx] = Remote(owner)
            continue
        i, j, k = idx
        tile = x[..., j * h : (j + 1) * h, k * w : (k + 1) * w]
        if x.ndim == 3:
            tile = tile[i * b : (i + 1) * b]
        grid[idx] = tile.to(mesh.devices[idx])
    return grid


def merge(grid: np.ndarray, mesh: FlowMesh) -> torch.Tensor:
    """The global tensor of a grid of tiles, on the home device; another
    process's tiles arrive by ``gather_slots`` (every process must call)."""
    flat = grid.reshape(-1)
    tiles = gather_slots([t for t in flat if not isinstance(t, Remote)],
                         mesh.ranks[: grid.shape[0]].reshape(-1), mesh)
    full = _grid(grid.shape)
    for i, t in enumerate(tiles):
        full.flat[i] = t
    rows = [
        [torch.cat([full[i, j, k] for k in range(grid.shape[2])], dim=-1)
         for j in range(grid.shape[1])]
        for i in range(grid.shape[0])
    ]
    frames = [torch.cat(r, dim=-2) for r in rows]
    if frames[0].ndim == 2:
        if len(frames) != 1:
            raise ValueError("a grid of 2-D tiles has one frame index")
        return frames[0]
    return torch.cat(frames, dim=0)
