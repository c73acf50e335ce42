"""K2: cv::pyrDown as one CUDA kernel (csrc/pyrdown.cu); a whole pyramid
from one host call.

Replaces the TPU kernel ``optical_flow_tpu/kernels/pyrdown_kernel.py::
_pyrdown_pallas_batched`` (pallas_call at :146). ``gaussian_pyramid_cuda``
builds every level below the input in one call (``oft_pyramid``, counted as
one launch: one grid a level, each started early by programmatic dependent
launch and waiting on the level above) into one buffer and returns views of
it; ``pyr_down_cuda`` is the same kernel for one level (``oft_pyrdown``).
Both separable passes run in the kernel: each input slab is read once into
shared memory and only the decimated output is written. The sums follow
the plain ``'poly'`` order (``ops/pyramid.pyr_down_poly``, the plain
version), not the TPU kernel's MXU column pass, so the kernel is
bit-identical to it. REFLECT_101 indices are computed in the kernel, so
every H, W >= 1 is taken: there is no shape the kernel refuses.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from optical_flow_tpu_torch.kernels import _lib
from optical_flow_tpu_torch.ops.pyramid import gaussian_pyramid
from optical_flow_tpu_torch.ops.pyramid import pyr_down_poly as pyr_down_plain

__all__ = ["gaussian_pyramid_cuda", "level_layout", "pyr_down_cuda", "pyr_down_plain"]


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


def level_layout(B: int, H: int, W: int, levels: int) -> Tuple[List[Tuple[int, int, int]], int]:
    """Where levels 1 .. levels-1 of a (B, H, W) pyramid lie in its one
    buffer: each level's (offset, Ho, Wo) in elements, offsets rounded up to
    a multiple of 4 (16 bytes, so every level's rows can be staged with
    16-byte copies where its width allows), and the buffer's length. The
    only copy of the layout: ``oft_pyramid`` is handed the offsets."""
    out, off = [], 0
    for _ in range(levels - 1):
        H, W = -(-H // 2), -(-W // 2)
        out.append((off, H, W))
        off += -(-B * H * W // 4) * 4
    return out, off


def gaussian_pyramid_cuda(x: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """The ``levels``-level pyramid of ``(..., H, W)``, levels 1 and below
    from one call of kernel K2 (``oft_pyramid``); level 0 is ``x`` itself, as in
    ``ops/pyramid.gaussian_pyramid``. The levels below it are views of one
    buffer (``level_layout``). Integer inputs are promoted to float32.

    A CUDA tensor must be contiguous float32 (after the promotion) and
    launches the kernel (or raises); a CPU tensor fills the same views from
    the plain pyramid (``gaussian_pyramid(..., impl='poly')``).
    """
    src = x if torch.is_floating_point(x) else x.to(torch.float32)
    if x.is_cuda:
        _lib.check_cuda_f32("gaussian_pyramid_cuda", src)
    lead, (H, W) = x.shape[:-2], x.shape[-2:]
    B = src.numel() // max(H * W, 1)
    layout, total = level_layout(B, H, W, levels)
    buf = torch.empty(total, dtype=src.dtype, device=x.device)
    pyr = [x] + [buf[o : o + B * h * w].view(lead + (h, w)) for o, h, w in layout]
    if not x.is_cuda:
        for level, plain in zip(pyr[1:], gaussian_pyramid(src, levels, impl="poly")[1:]):
            level.copy_(plain)
    elif layout and B and H and W:
        offsets = (ctypes.c_longlong * len(layout))(*(o for o, _, _ in layout))
        _lib.launch("oft_pyramid", x.device, src.data_ptr(), buf.data_ptr(), offsets, B, H, W,
                    levels)
    return pyr
