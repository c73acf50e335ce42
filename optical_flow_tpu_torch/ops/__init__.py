"""Dense tensor ops with OpenCV-faithful numerics (PyTorch port of
optical_flow_tpu/ops): padding, gradients, window sums, the 2x2 solve,
Gaussian pyramids and warps, on ``(..., H, W)`` tensors."""

from optical_flow_tpu_torch.ops.gradients import spatio_temporal_gradients
from optical_flow_tpu_torch.ops.window import sum3x3_interior
from optical_flow_tpu_torch.ops.solve import solve_lk_2x2, safe_divide
from optical_flow_tpu_torch.ops.pyramid import (
    pyr_down,
    pyr_up,
    gaussian_pyramid,
    max_pyramid_levels,
)
from optical_flow_tpu_torch.ops.warp import (
    remap_bilinear,
    symmetric_warp,
)

__all__ = [
    "spatio_temporal_gradients",
    "sum3x3_interior",
    "solve_lk_2x2",
    "safe_divide",
    "pyr_down",
    "pyr_up",
    "gaussian_pyramid",
    "max_pyramid_levels",
    "remap_bilinear",
    "symmetric_warp",
]
