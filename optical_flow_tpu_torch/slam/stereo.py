"""Stereo depth for the mapper: rectified-pair disparity through the same
engines that track features over time (port of
optical_flow_tpu/slam/stereo.py).

On a rectified rig the right-image correspondence of a left corner lies on
the same scanline, so ``track_features(left, right, pts)`` with an epipolar
gate (|dy| small) is the sparse stereo matcher (kernel K2 builds both
pyramids on the card), and left->right dense flow is the disparity field:
``dense_disparity`` runs the port's ``coarse_to_fine`` in corrected mode
with ``warp_clamp=24``, so on the card kernel K1 solves its coarsest level
and K3 every step between levels, at a tap reach C = 12. Given the rig
baseline, disparity fixes metric depth (Z = f b / d), which closes the one
gap of the monocular pipeline: scale.

Every entry point runs on the call's device: tensors stay on theirs, host
arrays go to the card unless ``device`` names another. ``stereo_match``
returns host numpy, as JAX does; the dense functions return tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from optical_flow_tpu_torch.track.sparse_lk import SparseLKConfig, track_features
from optical_flow_tpu_torch.utils.device import as_tensor, call_device, host_array


def stereo_match(
    left, right, pts, *, max_dy: float = 1.5, min_disparity: float = 0.25,
    max_disparity: Optional[float] = None, config: Optional[SparseLKConfig] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Match left-image points into a rectified right image.

    pts: (K, 2) float32 (x, y) in the LEFT image. Returns host (disparity
    (K,) float32, ok (K,) bool, matched (K, 2), the measured right-image
    pixels). disparity = x_l - x_r; matches off the scanline (|dy| >
    max_dy), with non-positive or out-of-range disparity fail ``ok``.
    """
    pts = host_array(pts).astype(np.float32)
    if config is None:
        # a whole baseline of parallax in one hop: one pyramid level over
        # the tracker's default 3 raises the capture range past typical rig
        # disparities
        config = SparseLKConfig(max_level=3)
    dev = call_device(left, right, device=device)
    matched, status, _ = track_features(as_tensor(left, dev, torch.float32),
                                        as_tensor(right, dev, torch.float32), pts, config)
    matched = host_array(matched).astype(np.float32)
    disp = pts[:, 0] - matched[:, 0]
    dy = np.abs(pts[:, 1] - matched[:, 1])
    ok = host_array(status).astype(bool) & (dy <= max_dy) & (disp >= min_disparity)
    if max_disparity is not None:
        ok &= disp <= max_disparity
    return disp.astype(np.float32), ok, matched


def stereo_backproject(pts, disp, focal: float, cx: float, cy: float, baseline: float) -> np.ndarray:
    """Metric 3-D points in the LEFT camera frame from pixel + disparity
    (host float32): Z = focal baseline / disparity, X and Y from the
    pinhole model. Guard rows of invalid disparity with stereo_match's
    ``ok``."""
    pts = host_array(pts).astype(np.float32)
    disp = np.maximum(host_array(disp).astype(np.float32), 1e-6)
    z = np.float32(focal * baseline) / disp
    x = (pts[:, 0] - np.float32(cx)) * z / np.float32(focal)
    y = (pts[:, 1] - np.float32(cy)) * z / np.float32(focal)
    return np.stack([x, y, z], axis=1)


def dense_disparity(left, right, *, config=None, max_dy: float = 1.0, device=None):
    """Dense sub-pixel disparity from the pyramidal LK engine: on a
    rectified rig, left->right flow is u = -disparity, v ~ 0.

    The default config is corrected mode (pixel-true disparities) with
    ``warp_clamp=24``: rig disparities are larger than frame-to-frame
    motion and the per-level clamp is the binding limit. Returns
    (disparity (H, W) float32, valid (H, W) bool) on the call's device;
    ``valid`` rejects |v| > max_dy (off the scanline) and non-positive
    disparity.
    """
    from optical_flow_tpu_torch.config import FlowConfig
    from optical_flow_tpu_torch.flow.coarse_to_fine import coarse_to_fine

    if config is None:
        config = FlowConfig(mode="corrected", warp_clamp=24.0)
    dev = call_device(left, right, device=device)
    u, v = coarse_to_fine(as_tensor(left, dev, torch.float32).contiguous(),
                          as_tensor(right, dev, torch.float32).contiguous(),
                          config.levels, config=config)
    disp = -u
    valid = (torch.abs(v) <= max_dy) & (disp > 0)
    return disp, valid


def dense_depth(disparity, focal: float, baseline: float, valid=None, *, device=None):
    """Metric depth map Z = focal baseline / disparity; invalid or
    non-positive disparities give 0."""
    dev = call_device(disparity, valid, device=device)
    d = as_tensor(disparity, dev, torch.float32)
    ok = d > 1e-6
    if valid is not None:
        ok = ok & as_tensor(valid, dev, torch.bool)
    z = (focal * baseline) / torch.clamp_min(d, 1e-6)
    return torch.where(ok, z, torch.zeros_like(z))


def split_sbs(frame):
    """Split a side-by-side stereo frame (left|right) into the pair, along
    the width axis (-2 when a trailing channel axis of 1, 3 or 4 is
    present, else -1). Odd widths drop the centre column. Takes a numpy
    array or a tensor and returns two of the same kind."""
    f = frame if isinstance(frame, torch.Tensor) else np.asarray(frame)
    ax = -2 if (f.ndim >= 3 and f.shape[-1] in (1, 3, 4)) else -1
    W = f.shape[ax]
    w = W // 2
    if ax == -1:
        return f[..., :w], f[..., W - w:]
    return f[..., :w, :], f[..., W - w:, :]
