"""Appearance descriptors for track verification and re-association (port of
optical_flow_tpu/slam/descriptors.py).

Each track carries an appearance anchor: a mean-removed, unit-normalized
intensity patch sampled (bilinear, subpixel) at its birth position. NCC
against the anchor is then a dot product, so

  * track VERIFICATION is one row-wise dot per keyframe (``ncc_scores``);
  * lost-track RE-ASSOCIATION is one (N, D) @ (D, M) matmul plus
    mutual-nearest and Lowe-ratio gating (``match_descriptors``).

Patches come from the sparse tracker's batched bilinear sampler
(``track/sparse_lk._sample_patches``). ``patch_descriptors`` and the score
matrix run on the call's device (tensors stay on theirs, host arrays go to
the card unless ``device`` names another); the score matrix is a float32
matmul with TF32 off. The gating is host numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from optical_flow_tpu_torch.pipeline.preprocess import _ieee_f32_matmul
from optical_flow_tpu_torch.track.sparse_lk import _sample_patches
from optical_flow_tpu_torch.utils.device import as_tensor, call_device, host_array


def patch_descriptors(img, pts, half: int = 7, *, device=None) -> torch.Tensor:
    """Normalized patch descriptors at subpixel points.

    img: (H, W) gray; pts: (K, 2) float xy. Returns (K, D) float32 with D =
    (2 half + 1)^2: each row is the bilinear patch around the point,
    mean-removed and L2-normalized (so a @ b.T is NCC in [-1, 1]). Flat
    patches (zero variance) come out as all-zero rows and match nothing.
    """
    dev = call_device(img, pts, device=device)
    img = as_tensor(img, dev, torch.float32)
    p = _sample_patches(img, as_tensor(pts, dev, torch.float32), half, extra=0)
    d = p.reshape(p.shape[0], -1)
    d = d - torch.mean(d, dim=1, keepdim=True)
    n = torch.sqrt(torch.sum(d * d, dim=1, keepdim=True))
    return torch.where(n > 1e-6, d / torch.clamp_min(n, 1e-6), torch.zeros_like(d))


def ncc_scores(anchor, current) -> np.ndarray:
    """Row-wise NCC between two aligned (K, D) descriptor tables (host
    float32)."""
    a = host_array(anchor).astype(np.float32)
    b = host_array(current).astype(np.float32)
    return np.sum(a * b, axis=1)


def _score_matrix(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    with _ieee_f32_matmul():
        return torch.matmul(da, db.mT)


def match_descriptors(
    da, db, *, min_score: float = 0.8, ratio: float = 0.85, device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Mutual-nearest NCC matching with a Lowe ratio test.

    da: (N, D), db: (M, D) normalized descriptors. Returns host (idx, ok):
    idx[i] = best column in db for row i; ok[i] = the match is mutual,
    scores >= min_score, is positive, and beats the runner-up by the ratio
    margin (second_best <= ratio * best). Zero rows (flat patches) never
    match. The score matrix is computed on the call's device.
    """
    n, m = da.shape[0], db.shape[0]
    if n == 0 or m == 0:
        return np.zeros(n, np.int64), np.zeros(n, bool)
    dev = call_device(da, db, device=device)
    S = host_array(_score_matrix(as_tensor(da, dev, torch.float32),
                                 as_tensor(db, dev, torch.float32)))
    rows = np.arange(n)
    idx = np.argmax(S, axis=1)
    best = S[rows, idx]
    # runner-up along each row for the ratio test (guard M == 1)
    if m > 1:
        S2 = S.copy()
        S2[rows, idx] = -np.inf
        second = S2.max(axis=1)
    else:
        second = np.full(n, -np.inf, np.float32)
    mutual = np.argmax(S, axis=0)[idx] == rows
    # an anti-correlated best match is never distinctive: best <= 0 fails
    # (ratio * best would invert the gate's sense there)
    ok = mutual & (best >= min_score) & (best > 0) & (second <= ratio * best)
    return idx.astype(np.int64), ok


def verify_tracks(anchor_desc, img, pts, *, gate: float, half: int = 7, device=None) -> np.ndarray:
    """True where the current appearance still matches the track's anchor.

    anchor_desc: (K, D) descriptors captured at track birth; pts: (K, 2)
    current positions in img. A row passes when NCC(anchor, now) >= gate;
    rows whose anchor is all-zero (flat at birth) pass (no identity to
    enforce). Returns a host bool array.
    """
    anchor = host_array(anchor_desc).astype(np.float32)
    now = patch_descriptors(img, pts, half=half, device=device)
    s = ncc_scores(anchor, now)
    no_anchor = np.abs(anchor).sum(axis=1) < 1e-6
    return no_anchor | (s >= gate)
