"""Dense flow solvers and the coarse-to-fine pyramid controller."""

from optical_flow_tpu_torch.flow.lk import lucas_kanade
from optical_flow_tpu_torch.flow.coarse_to_fine import (
    coarse_to_fine,
    coarse_to_fine_pyramids,
    coarse_to_fine_with_images,
)

__all__ = [
    "lucas_kanade",
    "coarse_to_fine",
    "coarse_to_fine_pyramids",
    "coarse_to_fine_with_images",
]
