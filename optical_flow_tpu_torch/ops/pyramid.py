"""Gaussian pyramid ops (cv::pyrDown / cv::pyrUp; reference C8/C10).

pyr_down: separable 5-tap [1,4,6,4,1]/16, BORDER_REFLECT_101, keep the even
rows and columns; the output is (ceil(H/2), ceil(W/2)).

pyr_up: zero-stuffed 2x upsample convolved with the same taps scaled by 2
per axis, with OpenCV's asymmetric border (index -1 -> 1, index n -> n-1).
The output is exactly (2H, 2W).

max_pyramid_levels: the reference's getMaxLayer (LKof.cpp:230-249).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from optical_flow_tpu_torch.ops.pad import pad_last2

# OpenCV's 5-tap Gaussian, exact binary fractions: [1,4,6,4,1]/16.
_K5 = (0.0625, 0.25, 0.375, 0.25, 0.0625)


def _poly_pass(p: torch.Tensor, dim: int, n_out: int) -> torch.Tensor:
    """5-tap blur of the reflect-padded ``p`` evaluated only at the kept
    (even) positions along ``dim``, taps summed in order k0..k4."""
    out = None
    idx = [slice(None)] * p.ndim
    for t, k in enumerate(_K5):
        idx[dim] = slice(t, t + 2 * n_out - 1, 2)
        term = k * p[tuple(idx)]
        out = term if out is None else out + term
    return out


def pyr_down_poly(x: torch.Tensor) -> torch.Tensor:
    """The plain polyphase pyr_down: rows first, then columns (the JAX
    package's bit-pinned ``'poly'`` order). Integer inputs are promoted to
    float32."""
    if not torch.is_floating_point(x):
        x = x.to(torch.float32)
    H, W = x.shape[-2], x.shape[-1]
    r = _poly_pass(pad_last2(x, 2, 2, 0, 0, mode="reflect"), -2, -(-H // 2))
    return _poly_pass(pad_last2(r, 0, 0, 2, 2, mode="reflect"), -1, -(-W // 2))


def pyr_down(x: torch.Tensor, impl: str = "poly") -> torch.Tensor:
    """One pyramid level down (cv::pyrDown).

    impl: ``'poly'`` (plain PyTorch), ``'cuda'`` (the pyr_down kernel;
    a CPU tensor runs its plain version) or ``'auto'`` (``'cuda'`` for a
    CUDA tensor, ``'poly'`` otherwise).
    """
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "poly"
    if impl == "poly":
        return pyr_down_poly(x)
    if impl != "cuda":
        raise ValueError(f"pyr_down impl must be 'poly', 'cuda' or 'auto', got {impl!r}")
    from optical_flow_tpu_torch.kernels.pyrdown_kernel import pyr_down_cuda

    if not torch.is_floating_point(x):
        x = x.to(torch.float32)
    return pyr_down_cuda(x)


def _pad_pyrup(x: torch.Tensor) -> torch.Tensor:
    """Pad by 1 with OpenCV pyrUp's asymmetric border (-1 -> 1, n -> n-1)."""
    H, W = x.shape[-2], x.shape[-1]
    top = x[..., 1:2, :] if H > 1 else x[..., 0:1, :]
    x = torch.cat([top, x, x[..., H - 1 : H, :]], dim=-2)
    left = x[..., :, 1:2] if W > 1 else x[..., :, 0:1]
    return torch.cat([left, x, x[..., :, W - 1 : W]], dim=-1)


_K5UP = tuple(2.0 * v for v in _K5)


def _up_rows(p: torch.Tensor) -> torch.Tensor:
    """Row pass of pyr_up on a padded plane: (n+2, ...) rows -> 2n rows."""
    k = _K5UP
    ev = k[0] * p[..., :-2, :] + k[2] * p[..., 1:-1, :] + k[4] * p[..., 2:, :]
    od = k[1] * p[..., 1:-1, :] + k[3] * p[..., 2:, :]
    s = torch.stack([ev, od], dim=-2)
    return s.reshape(s.shape[:-3] + (2 * s.shape[-3], s.shape[-1]))


def _up_cols(p: torch.Tensor) -> torch.Tensor:
    """Column pass of pyr_up on a padded plane: (..., n+2) -> (..., 2n)."""
    k = _K5UP
    ev = k[0] * p[..., :, :-2] + k[2] * p[..., :, 1:-1] + k[4] * p[..., :, 2:]
    od = k[1] * p[..., :, 1:-1] + k[3] * p[..., :, 2:]
    s = torch.stack([ev, od], dim=-1)
    return s.reshape(s.shape[:-2] + (2 * s.shape[-2],))


def pyr_up(x: torch.Tensor) -> torch.Tensor:
    """One pyramid level up to exactly (2H, 2W), rows first (cv::pyrUp)."""
    return _up_cols(_up_rows(_pad_pyrup(x)))


def pyr_up_cols_first(x: torch.Tensor) -> torch.Tensor:
    """``pyr_up`` with the column pass first: the corrected-mode upsample
    whose rounding the pyrUp+warp+LK kernel mirrors."""
    return _up_rows(_up_cols(_pad_pyrup(x)))


def gaussian_pyramid(img: torch.Tensor, levels: int, impl: str = "poly") -> List[torch.Tensor]:
    """n-level pyramid; level 0 is the input itself (LKof.cpp:180-189).

    impl as ``pyr_down``'s; ``'cuda'`` builds every level below the input
    in one call of the pyr_down kernel (``gaussian_pyramid_cuda``; a CPU
    tensor runs its plain version).
    """
    if impl == "auto":
        impl = "cuda" if img.is_cuda else "poly"
    if impl == "cuda":
        from optical_flow_tpu_torch.kernels.pyrdown_kernel import gaussian_pyramid_cuda

        return gaussian_pyramid_cuda(img, levels)
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1], impl=impl))
    return pyr


def max_pyramid_levels(shape: Tuple[int, ...]) -> int:
    """Reference getMaxLayer: min over dims of (2-adic valuation + 1)."""

    def v2_plus1(n: int) -> int:
        p = 1
        while n % (1 << p) == 0:
            p += 1
        return p

    h, w = int(shape[-2]), int(shape[-1])
    if h <= 0 or w <= 0:
        raise ValueError(f"image dimensions must be positive, got {h}x{w}")
    return min(v2_plus1(w), v2_plus1(h))
