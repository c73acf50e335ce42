"""The device mesh of the flow engine, as a grid of ``torch.device``s.

Mesh axes (config.MeshConfig):
  frames: data parallelism over frame pairs (the batch),
  rows / cols: 2-D spatial tiling of each image.

The JAX package runs one controller over a ``jax.sharding.Mesh`` under
``shard_map``. The port keeps the single controller: one process drives
every tile, and a ``FlowMesh`` is a ``(frames, rows, cols)`` grid of
devices, which may repeat a device (a 2x2 tile grid runs whole on one
card). ``shard_map``'s in_specs and out_specs become two explicit
functions: ``split`` cuts a global tensor into a grid of tiles, each moved
to its device, and ``merge`` puts a grid back together on the mesh's home
device, ``devices[0, 0, 0]``, where the global ops run.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

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


class FlowMesh:
    """A (frames, rows, cols) grid of devices.

    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh.shape``
    does; ``home`` is ``devices[0, 0, 0]``. Meshes compare by identity, so
    the probe of parallel/vma_compat.py runs once per mesh.
    """

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 3 or devices.size == 0:
            raise ValueError(f"devices must be a non-empty 3-D grid, got shape {devices.shape}")
        self.devices = devices
        f, r, c = devices.shape
        self.shape: Dict[str, int] = {AXIS_FRAMES: f, AXIS_ROWS: r, AXIS_COLS: c}
        self.home: torch.device = devices[0, 0, 0]

    def __repr__(self) -> str:
        return f"FlowMesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


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


# ------------------------------------------------------------------ grids
#
# A grid is an object array of tensors: (frames, rows, cols) for a batched
# (B, H, W) tensor, B split over frames; (1, rows, cols) for an (H, W) one,
# on the devices of frame index 0.


def _grid(shape) -> np.ndarray:
    return np.empty(shape, dtype=object)


def grid_map(fn: Callable, *grids: np.ndarray) -> np.ndarray:
    """``fn`` applied tile by tile; a tuple result gives a tuple of grids."""
    out = None
    for idx in np.ndindex(grids[0].shape):
        r = fn(*(g[idx] for g in grids))
        if out is None:
            out = tuple(_grid(grids[0].shape) for _ in r) if isinstance(r, tuple) else _grid(
                grids[0].shape)
        if isinstance(r, tuple):
            for o, x in zip(out, r):
                o[idx] = x
        else:
            out[idx] = r
    return out


def tile_origin(grid: np.ndarray, idx) -> Tuple[int, int]:
    """Global (row, col) of tile ``idx`` = (frame, row, col) of a grid of
    equal tiles."""
    t = grid[idx]
    return idx[1] * t.shape[-2], idx[2] * t.shape[-1]


def split(x: torch.Tensor, mesh: FlowMesh) -> np.ndarray:
    """Cut a global (H, W) or (B, H, W) tensor into the mesh's grid of
    tiles, each moved to its device (B over frames, H over rows, W over
    cols; each must divide evenly)."""
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
    grid = _grid((f, r, c))
    for idx in np.ndindex(grid.shape):
        i, j, k = idx
        tile = x[..., j * h : (j + 1) * h, k * w : (k + 1) * w]
        if x.ndim == 3:
            tile = tile[i * b : (i + 1) * b]
        grid[idx] = tile.to(mesh.devices[idx])
    return grid


def merge(grid: np.ndarray, mesh: FlowMesh) -> torch.Tensor:
    """The global tensor of a grid of tiles, on the mesh's home device."""
    home = mesh.home
    rows = [
        [torch.cat([grid[i, j, k].to(home) for k in range(grid.shape[2])], dim=-1)
         for j in range(grid.shape[1])]
        for i in range(grid.shape[0])
    ]
    frames = [torch.cat(r, dim=-2) for r in rows]
    if frames[0].ndim == 2:
        if len(frames) != 1:
            raise ValueError("a grid of 2-D tiles has one frame index")
        return frames[0]
    return torch.cat(frames, dim=0)
