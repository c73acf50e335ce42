"""Sparse feature tracking (port of optical_flow_tpu/track/; reference
C16/C17: of.cpp:21-101, OpenCV goodFeaturesToTrack + calcOpticalFlowPyrLK).

Static shapes and batched, as in the JAX package:
  features.py   Shi–Tomasi corners: a fixed-K corner array and a validity
                mask (top-k over the min-eigenvalue map, max-pool non-max
                suppression in place of OpenCV's serial minDistance pass)
  sparse_lk.py  pyramidal sparse LK: all K features as one batched 2x2
                solve a step, a fixed 20 steps with a convergence mask; the
                tracking pyramid built by kernel K2 on the card
  pose.py       RANSAC homography: every hypothesis solved and scored as one
                batch (eigh null-space DLT), 4-point sets drawn on the CPU
                from a seed
"""

from optical_flow_tpu_torch.track.features import good_features_to_track, min_eig_map
from optical_flow_tpu_torch.track.sparse_lk import SparseLKConfig, track_features

__all__ = [
    "good_features_to_track",
    "min_eig_map",
    "track_features",
    "SparseLKConfig",
]
