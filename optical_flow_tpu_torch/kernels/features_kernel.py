"""F1: the frame's feature map, ``diff_features``, as one CUDA kernel
(csrc/features.cu).

Replaces no TPU kernel: the JAX package's ``diff_features``
(``optical_flow_tpu/pipeline/preprocess.py``) is left to XLA, which fuses
it. In eager PyTorch the chain (temporal diff, saturated to uint8 on the
faithful path; THRESH_TOZERO; Sobel x + y; dilate and erode) is about 54
launches a frame, every intermediate a full plane in device memory. The
kernel reads the two gray planes once and writes the feature plane once.

Its bound is bytes: two gray planes in and one float32 plane out, 14.0 MB
at 1080^2 in float32 and 7.0 MB in uint8. A block stages the diff over its
output tile and the stencil's halo (1 + 2r pixels) in shared memory and
runs Sobel, the max and the min there as separable passes, so no
intermediate leaves the chip and the halo's re-reads come from L2. The
kernel equals its plain version, ``pipeline.preprocess.diff_features``, bit
for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from optical_flow_tpu_torch.config import PreprocessConfig
from optical_flow_tpu_torch.kernels import _lib
from optical_flow_tpu_torch.pipeline.preprocess import diff_features

__all__ = ["MAX_MORPH_ITERATIONS", "diff_features_cuda", "kernel_takes"]

# the largest morph_iterations (the max and min windows' radius) F1 takes
MAX_MORPH_ITERATIONS = 4


def kernel_takes(cur_gray: torch.Tensor, prev_gray: torch.Tensor,
                 config: PreprocessConfig) -> bool:
    """Whether F1 computes ``diff_features`` of these planes under ``config``:
    both float32 or both uint8, and ``morph_iterations`` at most
    ``MAX_MORPH_ITERATIONS``."""
    return (cur_gray.dtype == prev_gray.dtype
            and cur_gray.dtype in (torch.float32, torch.uint8)
            and config.morph_iterations <= MAX_MORPH_ITERATIONS)


def diff_features_cuda(cur_gray: torch.Tensor, prev_gray: torch.Tensor,
                       config: PreprocessConfig = PreprocessConfig()) -> torch.Tensor:
    """``diff_features`` of two ``(..., H, W)`` gray planes through kernel F1;
    a float32 result of the same shape.

    CUDA tensors launch the kernel (or raise): contiguous planes on one
    device, both float32 or both uint8 (uint8 saturates the diff where
    ``config.faithful_uint8`` holds, as ``temporal_diff`` does), and
    ``morph_iterations`` at most ``MAX_MORPH_ITERATIONS``. CPU tensors run
    ``diff_features``.
    """
    if cur_gray.shape != prev_gray.shape or cur_gray.ndim < 2:
        raise ValueError(f"diff_features_cuda: planes of shapes {tuple(cur_gray.shape)} and "
                         f"{tuple(prev_gray.shape)}; want one shape (..., H, W)")
    if not cur_gray.is_cuda:
        return diff_features(cur_gray, prev_gray, config)
    r = max(int(config.morph_iterations), 0)
    if r > MAX_MORPH_ITERATIONS:
        raise ValueError(f"diff_features_cuda: morph_iterations {r} > {MAX_MORPH_ITERATIONS}")
    u8 = cur_gray.dtype == torch.uint8
    _lib.check_cuda("diff_features_cuda", torch.uint8 if u8 else torch.float32, cur_gray,
                    prev_gray)
    out = torch.empty(cur_gray.shape, dtype=torch.float32, device=cur_gray.device)
    H, W = cur_gray.shape[-2], cur_gray.shape[-1]
    B = cur_gray.numel() // max(H * W, 1)
    if B and H and W:
        _lib.launch("oft_diff_features", cur_gray.device, cur_gray.data_ptr(),
                    prev_gray.data_ptr(), out.data_ptr(), B, H, W, int(u8),
                    int(u8 and config.faithful_uint8), float(np.float32(config.learning_rate)),
                    float(config.diff_thresh), r)
    return out
