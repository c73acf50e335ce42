"""Mesh parallelism for the flow engine: a device grid, halo exchange and
the sharded flow controller (port of optical_flow_tpu/parallel/).

- frame parallelism: a batch of frame pairs split over a 'frames' axis;
- spatial tiling: 2-D image tiles over ('rows', 'cols') with stencil halo
  exchange between neighbouring tiles;
- coarse levels and global ops run whole on the mesh's home device.

A mesh may place several tiles on one device, and its slots may belong to
several processes joined by ``torch.distributed`` (``distributed.py``:
one process per card); each process then drives its own tiles.
"""

from optical_flow_tpu_torch.parallel.mesh import flow_mesh, mesh_factorization
from optical_flow_tpu_torch.parallel.halo import exchange_halo, exchange_halo_pyrup
from optical_flow_tpu_torch.parallel.sharded_lk import sharded_lucas_kanade
from optical_flow_tpu_torch.parallel.sharded_flow import (
    sharded_coarse_to_fine,
    sharded_coarse_to_fine_pyramids,
    sharded_coarse_to_fine_with_images,
)
from optical_flow_tpu_torch.parallel.sharded_warp import sharded_symmetric_warp
from optical_flow_tpu_torch.parallel.sharded_warp_lk import (
    sharded_pyrup_warp_lk,
    sharded_warp_lk,
)

__all__ = [
    "flow_mesh",
    "mesh_factorization",
    "exchange_halo",
    "sharded_lucas_kanade",
    "sharded_coarse_to_fine",
    "sharded_coarse_to_fine_pyramids",
    "sharded_coarse_to_fine_with_images",
    "sharded_symmetric_warp",
    "exchange_halo_pyrup",
    "sharded_pyrup_warp_lk",
    "sharded_warp_lk",
]
