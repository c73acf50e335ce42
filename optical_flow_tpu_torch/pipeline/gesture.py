"""Gesture detection from dense flow (reference C12,
ParallelVideoPyr.cpp:845-890): pixels with |flow| >= mag_thresh vote into a
centroid, detection fires when votes > min_votes, and the thresholded
magnitude is L2-normalised to norm_alpha (cv::normalize's NORM_L2)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from optical_flow_tpu_torch.config import GestureConfig


class GestureResult(NamedTuple):
    detected: torch.Tensor  # bool[...]: votes > min_votes
    cx: torch.Tensor  # float[...]: centroid x (col) in flow coords
    cy: torch.Tensor  # float[...]: centroid y (row)
    votes: torch.Tensor  # int32[...]: number of voting pixels
    magnitude: torch.Tensor  # float[..., H, W]: thresholded |flow|, L2-normalised


def flow_magnitude(u, v, mag_thresh: float = 20.0):
    """|flow| with sub-threshold pixels zeroed, tested on the keep side
    (mag >= thresh) so non-finite magnitudes zero out."""
    mag = torch.sqrt(u * u + v * v)
    return torch.where(mag >= mag_thresh, mag, torch.zeros((), dtype=mag.dtype, device=mag.device))


def detect_gesture(u, v, config: GestureConfig = GestureConfig()) -> GestureResult:
    """Centroid-of-motion detection over ``(..., H, W)`` flow; leading axes
    are batch and reductions are per frame."""
    H, W = u.shape[-2], u.shape[-1]
    mag = torch.sqrt(u * u + v * v)
    thresholded = flow_magnitude(u, v, config.mag_thresh)
    votes_mask = mag >= config.mag_thresh
    cols = torch.arange(W, dtype=u.dtype, device=u.device)[None, :]
    rows = torch.arange(H, dtype=u.dtype, device=u.device)[:, None]
    votes = votes_mask.sum(dim=(-2, -1))
    denom = votes.clamp_min(1).to(u.dtype)
    cx = torch.where(votes_mask, cols, 0.0).sum(dim=(-2, -1)) / denom
    cy = torch.where(votes_mask, rows, 0.0).sum(dim=(-2, -1)) / denom
    l2 = torch.sqrt((thresholded * thresholded).sum(dim=(-2, -1), keepdim=True))
    normalized = torch.where(
        l2 > 0, thresholded * (config.norm_alpha / l2.clamp_min(1e-30)), thresholded
    )
    return GestureResult(
        detected=votes > config.min_votes,
        cx=cx,
        cy=cy,
        votes=votes.to(torch.int32),
        magnitude=normalized,
    )
