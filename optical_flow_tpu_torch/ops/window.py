"""3x3 window sums on the interior (reference C5/C6, ``get_Sum9_Mat``).

Interior pixels get the sum of their 3x3 neighbourhood; the 1-px border
ring is exactly 0 (LKof.cpp:129-137). Rows are summed first, then columns,
as in the JAX package. ``_box3_rows``/``_box3_cols`` are the zero-padded
full 3x3 passes (border included) that the corner detector composes
(track/features.py).
"""

from __future__ import annotations

import torch

from optical_flow_tpu_torch.ops.pad import pad_last2


def _box3_rows(x: torch.Tensor) -> torch.Tensor:
    p = pad_last2(x, 1, 1, 0, 0, mode="constant")
    return p[..., :-2, :] + p[..., 1:-1, :] + p[..., 2:, :]


def _box3_cols(x: torch.Tensor) -> torch.Tensor:
    p = pad_last2(x, 0, 0, 1, 1, mode="constant")
    return p[..., :, :-2] + p[..., :, 1:-1] + p[..., :, 2:]


def sum3x3_interior(x: torch.Tensor) -> torch.Tensor:
    """3x3 box sum on the interior of ``(..., H, W)``; the ring is zero."""
    out = torch.zeros_like(x)
    if x.shape[-2] < 3 or x.shape[-1] < 3:
        return out
    r = x[..., :-2, :] + x[..., 1:-1, :] + x[..., 2:, :]
    s = r[..., :, :-2] + r[..., :, 1:-1] + r[..., :, 2:]
    out[..., 1:-1, 1:-1] = s
    return out


def interior_mask(h: int, w: int, row0: int, col0: int, H: int, W: int, device=None) -> torch.Tensor:
    """(h, w) bool: True where the tile whose first pixel is (row0, col0)
    of an H x W frame lies off the frame's 1-px border ring, the ring LK
    leaves at 0 (``sum3x3_interior``)."""
    ys = torch.arange(row0, row0 + h, device=device)[:, None]
    xs = torch.arange(col0, col0 + w, device=device)[None, :]
    return (ys > 0) & (ys < H - 1) & (xs > 0) & (xs < W - 1)
