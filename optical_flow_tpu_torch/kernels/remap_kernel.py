"""W1: reference mode's symmetric gather warp as one CUDA kernel (csrc/remap.cu).

Replaces no TPU kernel: the JAX package's warp (``optical_flow_tpu/ops/
warp.py::remap_bilinear``) is a plain XLA gather. One launch warps both
frames of a level: ``img1`` sampled at ``(x + u/2, y + v/2)`` and ``img2``
at ``(x - u/2, y - v/2)``, INTER_LINEAR with a constant-0 border and cv2's
5-bit fixed-point coordinates (or the plain floor with ``quantize=False``).
A thread owns up to four consecutive outputs of a row and computes both
frames' taps from one load of ``u`` and ``v``; no index, mask or promoted
plane reaches device memory. Its plain version is ``symmetric_remap_plain``
(``ops.warp.symmetric_warp`` with ``impl='gather'``); the kernel equals it
bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from optical_flow_tpu_torch.kernels import _lib
from optical_flow_tpu_torch.ops.warp import symmetric_warp

__all__ = ["symmetric_remap_cuda", "symmetric_remap_plain"]


def symmetric_remap_plain(img1, img2, u, v, *, quantize: bool = True):
    return symmetric_warp(img1, img2, u, v, quantize=quantize, impl="gather")


def symmetric_remap_cuda(
    img1: torch.Tensor, img2: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
    quantize: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both frames of ``(..., H, W)`` warped half-way along the flow ``(u,
    v)`` of the same shape, through kernel W1; float32 results.

    CUDA tensors launch the kernel (or raise): contiguous float32 frames, or
    uint8 frames (promoted in the kernel, as ``symmetric_warp`` promotes an
    integer ``img1``), and contiguous float32 flows, all on one device. CPU
    tensors run ``symmetric_remap_plain``.
    """
    shapes = {tuple(t.shape) for t in (img1, img2, u, v)}
    if len(shapes) != 1:
        raise ValueError(f"symmetric_remap_cuda: frames and flows differ in shape: {shapes}")
    if not img1.is_cuda:
        return symmetric_remap_plain(img1, img2, u, v, quantize=quantize)
    src = torch.uint8 if img1.dtype == torch.uint8 else torch.float32
    _lib.check_cuda("symmetric_remap_cuda", src, img1, img2)
    _lib.check_cuda_f32("symmetric_remap_cuda", u, v)
    if u.device != img1.device:
        raise ValueError("symmetric_remap_cuda: all inputs must be on one CUDA device")
    w1 = torch.empty(u.shape, dtype=torch.float32, device=u.device)
    w2 = torch.empty(u.shape, dtype=torch.float32, device=u.device)
    H, W = u.shape[-2], u.shape[-1]
    B = u.numel() // max(H * W, 1)
    if B and H and W:
        _lib.launch("oft_remap", u.device, img1.data_ptr(), img2.data_ptr(), u.data_ptr(),
                    v.data_ptr(), w1.data_ptr(), w2.data_ptr(), B, H, W,
                    int(src == torch.uint8), int(quantize))
    return w1, w2
