"""P1: the copy kernel of the mesh probe (csrc/tile_copy.cu).

Replaces the copy kernel of ``optical_flow_tpu/parallel/vma_compat.py::
vma_accepts_pallas`` (pallas_call at :44); parallel/vma_compat.py says
what the port probes with it. Its plain version is ``tile_copy_plain``.
"""

from __future__ import annotations

import torch

from optical_flow_tpu_torch.kernels import _lib

__all__ = ["tile_copy_cuda", "tile_copy_plain"]


def tile_copy_plain(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def tile_copy_cuda(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` made by kernel P1 on ``x``'s device and that
    device's current stream. A CUDA tensor must be contiguous float32 and
    launches the kernel (or raises); a CPU tensor runs ``tile_copy_plain``."""
    if not x.is_cuda:
        return tile_copy_plain(x)
    _lib.check_cuda_f32("tile_copy_cuda", x)
    out = torch.empty_like(x)
    if x.numel():
        _lib.launch("oft_tile_copy", x.device, x.data_ptr(), out.data_ptr(), x.numel())
    return out
