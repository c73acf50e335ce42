"""Structure from motion and mapping (port of optical_flow_tpu/slam/): sparse
tracks -> relative pose -> 3D map -> bundle adjustment -> loop closure.

Layer map, in dependency order:
  epipolar.py     essential-matrix RANSAC (batched 8-point, host 5-point),
                  pose recovery, Gauss-Newton pose refinement, triangulation
  pnp.py          absolute pose by DLT, and its RANSAC
  ba.py           Schur-complement Gauss-Newton bundle adjustment, on one
                  device or with the points sharded over a mesh
  window.py       sliding-window BA with track retirement (WindowedBA)
  frontend.py     two_view_reconstruct and multi_view_reconstruct over the
                  sparse tracker of track/ (kernel K2 builds its pyramids)
  descriptors.py  normalized patch descriptors: the tracks' drift gate and
                  occlusion revival
  pose_graph.py   SE(3) and Sim(3) pose graphs (float64 Gauss-Newton), place
                  descriptors, loop verification, relocalization, the
                  Umeyama-measured loop similarity
  stereo.py       sparse stereo matching (K2) and dense disparity through
                  coarse_to_fine (K1 and K3 at C = 12 on the card)
  incremental.py  incremental_slam: the mapper over all of the above, the
                  engine of ``python -m optical_flow_tpu_torch slam``
  imu.py          IMU preintegration (a loop over the samples, batched over
                  the intervals; bias Jacobians by forward-mode
                  differentiation), gyro-bias estimation and the linear
                  visual-inertial alignment
  vi_ba.py        tightly-coupled visual-inertial BA (9- and 15-DOF states,
                  IMU factors in the reduced camera system) and
                  refine_slam_with_imu, the engine of ``slam --imu``; its
                  sharded form as ba.py's
"""

from optical_flow_tpu_torch.slam.ba import (
    BAProblem,
    bundle_adjust,
    project,
    reprojection_rmse,
    sharded_bundle_adjust,
)
from optical_flow_tpu_torch.slam.descriptors import (
    match_descriptors,
    ncc_scores,
    patch_descriptors,
    verify_tracks,
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
from optical_flow_tpu_torch.slam.imu import preintegrate, visual_inertial_alignment
from optical_flow_tpu_torch.slam.incremental import SlamResult, incremental_slam
from optical_flow_tpu_torch.slam.pnp import pnp_dlt, pnp_ransac
from optical_flow_tpu_torch.slam.pose_graph import (
    PoseGraph,
    Sim3PoseGraph,
    measure_loop_sim3,
    place_descriptor,
    propose_loop_candidates,
    relative_pose,
    relocalize,
    thumbnail_descriptor,
    umeyama_alignment,
    verify_loop_closure,
)
from optical_flow_tpu_torch.slam.stereo import (
    dense_depth,
    dense_disparity,
    split_sbs,
    stereo_backproject,
    stereo_match,
)
from optical_flow_tpu_torch.slam.vi_ba import (
    VIBAProblem,
    group_imu_by_keyframes,
    refine_slam_with_imu,
    refine_with_imu,
    sharded_vi_bundle_adjust,
    vi_bundle_adjust,
    vi_problem_from_ba,
)
from optical_flow_tpu_torch.slam.window import WindowedBA

__all__ = [
    "dense_depth",
    "dense_disparity",
    "split_sbs",
    "stereo_backproject",
    "stereo_match",
    "WindowedBA",
    "BAProblem",
    "bundle_adjust",
    "project",
    "reprojection_rmse",
    "sharded_bundle_adjust",
    "match_descriptors",
    "ncc_scores",
    "patch_descriptors",
    "verify_tracks",
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
    "SlamResult",
    "incremental_slam",
    "two_view_reconstruct",
    "pnp_dlt",
    "pnp_ransac",
    "PoseGraph",
    "Sim3PoseGraph",
    "measure_loop_sim3",
    "place_descriptor",
    "propose_loop_candidates",
    "relative_pose",
    "relocalize",
    "thumbnail_descriptor",
    "umeyama_alignment",
    "verify_loop_closure",
    "preintegrate",
    "visual_inertial_alignment",
    "VIBAProblem",
    "group_imu_by_keyframes",
    "refine_slam_with_imu",
    "refine_with_imu",
    "sharded_vi_bundle_adjust",
    "vi_bundle_adjust",
    "vi_problem_from_ba",
]
