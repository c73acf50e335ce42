"""Dense flow solvers and the coarse-to-fine pyramid controller: Lucas–Kanade
(the reference's algorithm) and Horn–Schunck (the variational extension)."""

from optical_flow_tpu_torch.flow.lk import lucas_kanade
from optical_flow_tpu_torch.flow.coarse_to_fine import (
    coarse_to_fine,
    coarse_to_fine_pyramids,
    coarse_to_fine_with_images,
)
from optical_flow_tpu_torch.flow.horn_schunck import HornSchunckConfig, horn_schunck

__all__ = [
    "lucas_kanade",
    "coarse_to_fine",
    "coarse_to_fine_pyramids",
    "coarse_to_fine_with_images",
    "horn_schunck",
    "HornSchunckConfig",
]
