"""The mesh probe (kernel P1), run before the first kernel on a mesh.

The JAX package's ``vma_compat`` traces a copy kernel under ``shard_map``
to learn whether JAX's varying-mesh-axes checker accepts kernel outputs,
and turns the checker off only while it does not. The port has no such
checker. What can break on its mesh is the composition itself: a
hand-written kernel launched on each tile's device, on that device's
current stream, between ``split``, the halo exchange and ``merge``. So the
probe runs the copy kernel P1 on each of this process's tiles of a small
frame, exchanges a 1-px reflect halo (point to point where a neighbour is
another process's), and checks bit for bit that every extended tile is the
matching slice of the reflect-padded frame and that ``merge`` gives the
frame back. On a CPU mesh the copy is its plain version and nothing
launches.

The result is cached per mesh, as ``functools.lru_cache`` caches the JAX
probe per process. The sharded wrappers call ``require_mesh_probe`` before
their first kernel launch and raise if the probe failed.
"""

from __future__ import annotations

import functools

import torch

from optical_flow_tpu_torch.kernels.tile_copy_kernel import tile_copy_cuda
from optical_flow_tpu_torch.ops.pad import pad_last2
from optical_flow_tpu_torch.parallel.halo import exchange_halo
from optical_flow_tpu_torch.parallel.mesh import (
    FlowMesh,
    grid_map,
    local_indices,
    merge,
    psum,
    split,
    tile_origin,
)

_TILE = (8, 128)  # per-tile shape of the probe frame (the JAX probe's (8, 128))


@functools.lru_cache(maxsize=16)
def mesh_probe(mesh: FlowMesh) -> bool:
    """True when P1 composes with split, the halo exchange and merge on
    every tile of ``mesh``, on every process (each checks its own tiles;
    the verdict is summed across the mesh, so all agree). A kernel that
    fails to build or launch raises."""
    f, r, c = mesh.devices.shape
    h, w = _TILE
    x = torch.arange(f * r * h * c * w, dtype=torch.float32, device=mesh.home)
    x = x.reshape(f, r * h, c * w)
    copies = grid_map(lambda t: tile_copy_cuda(t.contiguous()), split(x, mesh))
    ext = exchange_halo(copies, 1)
    padded = pad_last2(x, 1, 1, 1, 1)
    faults = 0
    for idx in local_indices(ext):
        r0, c0 = tile_origin(copies, idx)
        want = padded[idx[0] : idx[0] + 1, r0 : r0 + h + 2, c0 : c0 + w + 2]
        faults += not torch.equal(ext[idx].to(mesh.home), want)
    faults += not torch.equal(merge(copies, mesh), x)
    flag = torch.tensor([float(faults)], device=mesh.home)
    return float(psum([flag], mesh)) == 0.0


def require_mesh_probe(mesh: FlowMesh) -> None:
    """Raise unless ``mesh_probe(mesh)`` holds."""
    if not mesh_probe(mesh):
        raise RuntimeError(
            f"the mesh probe failed on {mesh}: a kernel's tiles did not survive "
            "split, the halo exchange and merge bit for bit"
        )
