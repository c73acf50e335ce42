"""Stencil halo exchange over a grid of tiles (parallel/mesh.py).

The JAX package moves halo strips with ``lax.ppermute`` inside
``shard_map``; here one function takes the whole grid and builds every
extended tile of this process from its own data and its neighbours' edge
strips. A neighbour of this process moves its strip with
``.to(tile.device)`` (a no-op where two tiles share a device); a
neighbour held by another process sends it point to point
(``mesh.exchange``: one batch of sends and receives that every process
posts in the grid's slot order).

Exchange order matters for corners: extending columns first and then
exchanging rows of the already-extended tiles brings a diagonal
neighbour's data in two hops, so one rows+cols exchange provides the full
(2k+1)^2 window. ``exchange_halo_pyrup`` goes the other way, rows first,
because the fused inter-level kernel's coarse border takes its column fill
from the row-extended strip.

Where a tile has no neighbour (the frame's edge), the border fills it:
'reflect' (BORDER_REFLECT_101 of the tile's own data, what the unsharded
ops see from their reflect padding), 'zero' (the warp's BORDER_CONSTANT 0)
or 'pyrup' (cv::pyrUp's asymmetric 1-sample border, zeros beyond). Only
copies move data, so sharded results stay bit-identical to unsharded ones.
"""

from __future__ import annotations

import numpy as np
import torch

from optical_flow_tpu_torch.parallel.mesh import Remote, exchange, grid_like, local_indices


def _fill(x: torch.Tensor, k: int, axis: int, border: str):
    """(lo, hi) strips of width k for a tile side on the frame's edge."""
    n = x.shape[axis]
    if border == "reflect":
        if k >= n:
            raise ValueError(f"reflect halo {k} needs a tile wider than {k}, got {n}")
        return x.narrow(axis, 1, k).flip(axis), x.narrow(axis, n - k - 1, k).flip(axis)
    if border == "zero":
        z = x.new_zeros(_with(x.shape, axis, k))
        return z, z
    if border == "pyrup":
        lo_src = x.narrow(axis, 1 if n > 1 else 0, 1)
        hi_src = x.narrow(axis, n - 1, 1)
        z = x.new_zeros(_with(x.shape, axis, k - 1))
        return torch.cat([z, lo_src], axis), torch.cat([hi_src, z], axis)
    raise ValueError(f"unknown border {border!r}")


def _with(shape, axis: int, k: int):
    s = list(shape)
    s[axis] = k
    return tuple(s)


def _exchange_1d(grid: np.ndarray, k: int, axis: int, border: str) -> np.ndarray:
    """Extend every tile by k on both sides along ``axis`` (-2 rows, -1
    cols), from the grid neighbours along the matching grid axis."""
    if k <= 0:
        return grid
    gaxis = 1 if axis == -2 else 2
    size = grid[local_indices(grid)[0]].shape[axis]  # tiles are equal on every process
    if k > size:
        raise ValueError(f"halo {k} exceeds the tile ({size} along axis {axis})")
    # strips from another process's tiles, walked in one order on every process
    sends, recvs, keys = [], [], []
    for flat, idx in enumerate(np.ndindex(grid.shape)):
        x = grid[idx]
        for side, nb in _neighbours(grid, idx, gaxis):
            if isinstance(x, Remote) and not isinstance(nb, Remote):
                sends.append((_edge(nb, k, axis, side), x.rank, 2 * flat + side))
            elif isinstance(nb, Remote) and not isinstance(x, Remote):
                recvs.append((_with(x.shape, axis, k), x, nb.rank, 2 * flat + side))
                keys.append((idx, side))
    received = dict(zip(keys, exchange(sends, recvs)))
    out = grid_like(grid)
    for idx in local_indices(grid):
        x = grid[idx]
        strips = list(_fill(x, k, axis, border))
        for side, nb in _neighbours(grid, idx, gaxis):
            strips[side] = (received[idx, side] if isinstance(nb, Remote)
                            else _edge(nb, k, axis, side).to(x.device))
        out[idx] = torch.cat([strips[0], x, strips[1]], axis)
    return out


def _neighbours(grid: np.ndarray, idx, gaxis: int):
    """(side, tile) of slot ``idx``'s neighbours along grid axis ``gaxis``:
    side 0 before it, 1 after it."""
    for side, j in ((0, idx[gaxis] - 1), (1, idx[gaxis] + 1)):
        if 0 <= j < grid.shape[gaxis]:
            yield side, grid[idx[:gaxis] + (j,) + idx[gaxis + 1 :]]


def _edge(nb: torch.Tensor, k: int, axis: int, side: int) -> torch.Tensor:
    """The strip of neighbour ``nb`` that borders a tile on its ``side``
    (0: the neighbour comes before the tile, its last k; 1: after, its
    first k)."""
    return nb.narrow(axis, nb.shape[axis] - k, k) if side == 0 else nb.narrow(axis, 0, k)


def exchange_halo_rows(grid: np.ndarray, k: int, *, border: str = "reflect") -> np.ndarray:
    """Extend (..., h, w) tiles to (..., h+2k, w) with the row neighbours'
    data only: the tiled separable shift warp's x-pass needs the neighbour
    rows' displacement field but never their columns."""
    return _exchange_1d(grid, k, -2, border)


def exchange_halo_pyrup(grid: np.ndarray, k_rows: int, k_cols: int) -> np.ndarray:
    """Halo exchange with cv::pyrUp's asymmetric border at the frame's
    edges, rows first and then columns over the row-extended tiles: the
    layout of the fused inter-level kernel's full-frame coarse border, so
    each extended tile is the matching slice of it (corners included;
    beyond the 1-sample border the fill is zero)."""
    return _exchange_1d(_exchange_1d(grid, k_rows, -2, "pyrup"), k_cols, -1, "pyrup")


def exchange_halo(grid: np.ndarray, k: int, *, border: str = "reflect") -> np.ndarray:
    """Extend (..., h, w) tiles to (..., h+2k, w+2k) with halo data,
    columns first so that the row exchange carries the corners."""
    return _exchange_1d(_exchange_1d(grid, k, -1, border), k, -2, border)
