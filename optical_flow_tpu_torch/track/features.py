"""Shi–Tomasi corner detection, cv2.goodFeaturesToTrack semantics (port of
optical_flow_tpu/track/features.py).

Sobel dx/dy -> structure tensor (full 3x3 box) -> smaller eigenvalue ->
per-image threshold at quality_level * max -> non-max suppression over the
min_distance neighbourhood -> top max_corners by score. Like the JAX
package, min_distance is a (2r+1)-square max-pool dominance test (a corner
survives iff it is the largest within its neighbourhood), not OpenCV's
serial greedy pass; two corners within min_distance whose scores tie bit
for bit both survive.

``lax.reduce_window`` max is ``F.max_pool2d`` (its implicit padding is
-inf, as JAX's), ``lax.top_k`` is ``torch.topk``. The slots past the valid
corners are filled as ``lax.top_k`` fills them, with the first non-corner
pixels in raster order, so the whole fixed-size array matches the JAX
package's; the valid corners may come in another order where scores tie.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from optical_flow_tpu_torch.ops.window import _box3_cols, _box3_rows
from optical_flow_tpu_torch.pipeline.preprocess import sobel3
from optical_flow_tpu_torch.utils.device import as_tensor, call_device


def _box3(x: torch.Tensor) -> torch.Tensor:
    """Full 3x3 box sum, border included (zero outside)."""
    return _box3_cols(_box3_rows(x))


def min_eig_map(img: torch.Tensor) -> torch.Tensor:
    """Per-pixel smaller eigenvalue of the 3x3-summed structure tensor
    (cv2.cornerMinEigenVal up to a constant positive scale)."""
    dx = sobel3(img, 1, 0)
    dy = sobel3(img, 0, 1)
    sxx = _box3(dx * dx)
    syy = _box3(dy * dy)
    sxy = _box3(dx * dy)
    tr = 0.5 * (sxx + syy)
    d = 0.5 * (sxx - syy)
    return tr - torch.sqrt(d * d + sxy * sxy)


def good_features_to_track(
    img, max_corners: int = 500, quality_level: float = 0.01, min_distance: float = 10.0,
    *, device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corner points as ((..., max_corners, 2) float32 (x, y), (...,
    max_corners) bool validity), for a gray image of shape (..., H, W), any
    float or integer dtype. Each image of a batch has its own threshold.

    A tensor stays on its device; a host array goes to the card unless
    ``device`` names another.
    """
    dev = call_device(img, device=device)
    img = as_tensor(img, dev)
    H, W = img.shape[-2], img.shape[-1]
    raw = min_eig_map(img.to(torch.float32))
    # OpenCV zeroes the border ring of the eigen map
    score = torch.zeros_like(raw)
    score[..., 1:-1, 1:-1] = raw[..., 1:-1, 1:-1]
    thresh = quality_level * torch.amax(score, dim=(-2, -1), keepdim=True)
    r = max(int(min_distance), 1)
    pooled = F.max_pool2d(score.reshape(-1, 1, H, W), 2 * r + 1, stride=1, padding=r)
    keep = (score >= thresh) & (score == pooled.reshape(score.shape)) & (score > 0)
    masked = torch.where(keep, score, torch.full((), -float("inf"), device=dev))

    lead = score.shape[:-2]
    keep = keep.reshape(lead + (H * W,))
    vals, idx = torch.topk(masked.reshape(lead + (H * W,)), max_corners, dim=-1)
    # slot s past the n valid corners holds the (s - n + 1)-th non-corner
    # pixel in raster order, as lax.top_k orders ties
    slot = torch.arange(max_corners, device=dev)
    n_valid = keep.sum(-1, keepdim=True)
    rank = (slot - n_valid).clamp_min(0) + 1
    tail = torch.searchsorted(torch.cumsum((~keep).to(torch.int64), -1), rank)
    idx = torch.where(slot < n_valid, idx, tail)
    ys = torch.div(idx, W, rounding_mode="floor").to(torch.float32)
    xs = (idx % W).to(torch.float32)
    pts = torch.stack([xs, ys], dim=-1)
    valid = torch.isfinite(vals) & (vals > 0)
    return pts, valid
