"""Structure from motion and mapping (port of optical_flow_tpu/slam/, the
first slice): sparse tracks -> relative pose -> 3D map -> bundle adjustment.

Layer map, in dependency order:
  epipolar.py  essential-matrix RANSAC (batched 8-point, host 5-point),
               pose recovery, Gauss-Newton pose refinement, triangulation
  pnp.py       absolute pose by DLT, and its RANSAC
  ba.py        Schur-complement Gauss-Newton bundle adjustment on one device
  window.py    sliding-window BA with track retirement (WindowedBA)
  frontend.py  two_view_reconstruct and multi_view_reconstruct over the
               sparse tracker of track/ (kernel K2 builds its pyramids)

Not ported yet, in the order they follow: descriptors, pose_graph,
incremental (and the CLI's slam subcommand), then stereo, imu, vi_ba, and
sharded_bundle_adjust with the mesh over several cards.
"""

from optical_flow_tpu_torch.slam.ba import (
    BAProblem,
    bundle_adjust,
    project,
    reprojection_rmse,
)
from optical_flow_tpu_torch.slam.epipolar import (
    EssentialRansacConfig,
    estimate_essential,
    five_point,
    five_point_batch,
    normalize_pixels,
    ransac_essential_5pt,
    recover_pose,
    refine_pose,
    triangulate,
)
from optical_flow_tpu_torch.slam.frontend import TwoViewReconstruction, two_view_reconstruct
from optical_flow_tpu_torch.slam.pnp import pnp_dlt, pnp_ransac
from optical_flow_tpu_torch.slam.window import WindowedBA

__all__ = [
    "WindowedBA",
    "BAProblem",
    "bundle_adjust",
    "project",
    "reprojection_rmse",
    "EssentialRansacConfig",
    "estimate_essential",
    "five_point",
    "five_point_batch",
    "ransac_essential_5pt",
    "normalize_pixels",
    "recover_pose",
    "refine_pose",
    "triangulate",
    "TwoViewReconstruction",
    "two_view_reconstruct",
    "pnp_dlt",
    "pnp_ransac",
]
