"""Spatio-temporal gradients fx, fy, ft (reference C1-C3).

OpenCV ``filter2D`` correlations with 2x2 kernels, anchor (1, 1) and
BORDER_REFLECT_101, applied to both frames and summed (LKof.cpp:34-74).
Output (y, x) reads source pixels (y-1..y, x-1..x); index -1 reflects to 1.
There is no 0.25 normalisation factor.
"""

from __future__ import annotations

from typing import Tuple

import torch

from optical_flow_tpu_torch.ops.pad import pad_last2


def _shifted4(img):
    """The four 2x2-stencil reads (y-1,x-1), (y-1,x), (y,x-1), (y,x) with
    REFLECT_101 at the top/left border."""
    p = pad_last2(img, 1, 0, 1, 0, mode="reflect")
    return p[..., :-1, :-1], p[..., :-1, 1:], p[..., 1:, :-1], p[..., 1:, 1:]


def spatio_temporal_gradients(img1, img2) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(fx, fy, ft) with the eight stencil reads shared; the sums run in
    the JAX package's order, so results agree bit for bit."""
    a1, b1, c1, d1 = _shifted4(img1)
    a2, b2, c2, d2 = _shifted4(img2)
    fx = (b1 - a1 + d1 - c1) + (b2 - a2 + d2 - c2)
    fy = (c1 + d1 - a1 - b1) + (c2 + d2 - a2 - b2)
    ft = (a2 + b2 + c2 + d2) - (a1 + b1 + c1 + d1)
    return fx, fy, ft
