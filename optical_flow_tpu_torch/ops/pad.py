"""Padding on the last two (spatial) axes of ``(..., H, W)`` tensors.

OpenCV's default filter border is BORDER_REFLECT_101 (``gfedcb|abcdefgh|
gfedcba``, the edge pixel is not repeated), numpy's ``mode='reflect'``.
``torch.nn.functional.pad(mode='reflect')`` takes only 3-D and 4-D inputs
and pads no wider than the axis, so the padding here is built from
single-line slices on each axis instead: any leading shape, any width, with
numpy's repeated reflection where a pad is wider than the axis.
"""

from __future__ import annotations

import torch


def reflect101(i: int, n: int) -> int:
    """BORDER_REFLECT_101 source index of position ``i`` on an axis of
    length ``n`` (numpy 'reflect', repeated for pads wider than ``n``)."""
    if n == 1:
        return 0
    period = 2 * (n - 1)
    i %= period
    return i if i < n else period - i


def _reflect_axis(x: torch.Tensor, dim: int, before: int, after: int) -> torch.Tensor:
    if before == 0 and after == 0:
        return x
    n = x.shape[dim]
    parts = [x.narrow(dim, reflect101(i, n), 1) for i in range(-before, 0)]
    parts.append(x)
    parts += [x.narrow(dim, reflect101(n + i, n), 1) for i in range(after)]
    return torch.cat(parts, dim=dim)


def pad_last2(
    x: torch.Tensor, top: int, bottom: int, left: int, right: int,
    mode: str = "reflect", value: float = 0.0,
) -> torch.Tensor:
    """Pad the trailing two axes: ``mode='reflect'`` (REFLECT_101) or
    ``'constant'`` (``value``)."""
    if mode == "reflect":
        return _reflect_axis(_reflect_axis(x, -2, top, bottom), -1, left, right)
    if mode != "constant":
        raise ValueError(f"mode must be 'reflect' or 'constant', got {mode!r}")
    H, W = x.shape[-2], x.shape[-1]
    out = x.new_full(x.shape[:-2] + (top + H + bottom, left + W + right), value)
    out[..., top : top + H, left : left + W] = x
    return out
