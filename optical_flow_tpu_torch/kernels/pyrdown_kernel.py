"""K2: cv::pyrDown as one CUDA kernel (csrc/pyrdown.cu).

Replaces the TPU kernel ``optical_flow_tpu/kernels/pyrdown_kernel.py::
_pyrdown_pallas_batched`` (pallas_call at :146). Both separable passes run
in one launch: the input slab is read once into shared memory and only the
decimated output is written. The sums follow the plain ``'poly'`` order
(``ops/pyramid.pyr_down_poly``, the plain version), not the TPU kernel's
MXU column pass. REFLECT_101 indices are computed in the kernel, so every
H, W >= 1 is taken: there is no shape the kernel refuses.
"""

from __future__ import annotations

import torch

from optical_flow_tpu_torch.kernels import _lib
from optical_flow_tpu_torch.ops.pyramid import pyr_down_poly as pyr_down_plain

__all__ = ["pyr_down_cuda", "pyr_down_plain"]


def pyr_down_cuda(x: torch.Tensor) -> torch.Tensor:
    """One pyramid level down of ``(..., H, W)`` through kernel K2.

    A CUDA tensor must be contiguous float32 and launches the kernel (or
    raises); a CPU tensor runs ``pyr_down_plain``.
    """
    if not x.is_cuda:
        return pyr_down_plain(x)
    _lib.check_cuda_f32("pyr_down_cuda", x)
    H, W = x.shape[-2], x.shape[-1]
    out = torch.empty(x.shape[:-2] + (-(-H // 2), -(-W // 2)), dtype=x.dtype, device=x.device)
    B = x.numel() // max(H * W, 1)
    if B and H and W:
        _lib.launch("oft_pyrdown", x.device, x.data_ptr(), out.data_ptr(), B, H, W)
    return out
