"""Horn–Schunck variational dense flow (port of
optical_flow_tpu/flow/horn_schunck.py).

Minimizes sum (fx u + fy v + ft)^2 + alpha^2 (|grad u|^2 + |grad v|^2) by
Jacobi iterations

    u <- ubar - fx (fx ubar + fy vbar + ft) / (alpha^2 + fx^2 + fy^2)

with the classic weighted neighbour average (1/6 edge, 1/12 diagonal,
REFLECT_101 border). A fixed ``iters`` loop of eager stencil and
elementwise ops: u and v go through each step stacked, one tensor, so a
step queues half the launches; the arithmetic is the JAX package's, op for
op. ``levels > 1`` runs the displacement-true corrected pyramid through the
LK controller's ``run_pyramid``, with pyramids from ``gaussian_pyramid(...,
impl='auto')`` (kernel K2 on the card, bit-identical to ``'poly'``) and the
warp of ``resolve_warp_impl`` (``'auto'``: ``shift_sep`` on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from optical_flow_tpu_torch.config import FlowConfig
from optical_flow_tpu_torch.flow.coarse_to_fine import resolve_warp_impl
from optical_flow_tpu_torch.flow.pyramid_loop import run_pyramid
from optical_flow_tpu_torch.ops.gradients import spatio_temporal_gradients
from optical_flow_tpu_torch.ops.pad import pad_last2
from optical_flow_tpu_torch.ops.pyramid import gaussian_pyramid, max_pyramid_levels
from optical_flow_tpu_torch.ops.warp import symmetric_warp
from optical_flow_tpu_torch.utils.device import as_tensor, call_device


@dataclasses.dataclass(frozen=True)
class HornSchunckConfig:
    alpha: float = 1.0  # smoothness weight
    iters: int = 100  # Jacobi iterations per level
    levels: Optional[int] = 1  # None -> max_pyramid_levels
    # the corrected pyramid's clamp on the warp displacement per level
    warp_clamp: Optional[float] = 8.0
    # 'gather' | 'shift' | 'shift_sep' | 'auto' (resolve_warp_impl)
    warp_impl: str = "auto"


def _neighbor_avg(x: torch.Tensor) -> torch.Tensor:
    """HS weighted average: 1/6 edge + 1/12 diagonal neighbours,
    REFLECT_101 border."""
    p = pad_last2(x, 1, 1, 1, 1, mode="reflect")
    edge = p[..., :-2, 1:-1] + p[..., 2:, 1:-1] + p[..., 1:-1, :-2] + p[..., 1:-1, 2:]
    diag = p[..., :-2, :-2] + p[..., :-2, 2:] + p[..., 2:, :-2] + p[..., 2:, 2:]
    return edge / 6.0 + diag / 12.0


def _hs_level(img1, img2, u0, v0, alpha: torch.Tensor, iters: int):
    """``iters`` Jacobi steps from (u0, v0); alpha is a 0-d tensor of the
    images' dtype, squared in that dtype as in the JAX package."""
    fx, fy, ft = spatio_temporal_gradients(img1, img2)
    denom = alpha * alpha + fx * fx + fy * fy
    grad = torch.stack([fx, fy])
    uv = torch.stack([u0, v0])
    for _ in range(iters):
        b = _neighbor_avg(uv)
        r = (fx * b[0] + fy * b[1] + ft) / denom
        uv = b - grad * r
    return uv[0], uv[1]


def horn_schunck(
    img1, img2, config: HornSchunckConfig = HornSchunckConfig(), *, device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense HS flow on ``(..., H, W)`` images; returns (u, v).

    Tensors stay on their device; host arrays go to the card unless
    ``device`` names another (``device="cpu"``). Integer images are
    promoted to float32; float images keep their dtype. With levels > 1 it
    runs coarse-to-fine with the symmetric half-flow warp of the LK
    controller's corrected mode.
    """
    dev = call_device(img1, img2, device=device)
    img1, img2 = as_tensor(img1, dev), as_tensor(img2, dev)
    if not torch.is_floating_point(img1):
        img1, img2 = img1.to(torch.float32), img2.to(torch.float32)
    levels = config.levels or max_pyramid_levels(img1.shape)
    if levels > max_pyramid_levels(img1.shape):
        raise ValueError(
            f"levels={levels} too deep for {img1.shape[-2]}x{img1.shape[-1]} "
            f"(max {max_pyramid_levels(img1.shape)}: pyr_up only inverts "
            f"even-sized pyr_down levels)"
        )
    alpha = torch.tensor(config.alpha, dtype=img1.dtype, device=dev)
    if levels <= 1:
        z = torch.zeros_like(img1)
        return _hs_level(img1, img2, z, z, alpha, config.iters)

    fc = FlowConfig(levels=levels, mode="corrected", warp_clamp=config.warp_clamp,
                    warp_impl=config.warp_impl)
    warp_impl, max_disp = resolve_warp_impl(fc, img1.is_cuda)
    pyr1 = gaussian_pyramid(img1, levels, impl="auto")
    pyr2 = gaussian_pyramid(img2, levels, impl="auto")

    def solve(_i, a, b):
        z = torch.zeros_like(a)
        return _hs_level(a, b, z, z, alpha, config.iters)

    def warp(_i, a, b, u, v):
        return symmetric_warp(a, b, u, v, impl=warp_impl, max_disp=max_disp)

    u, v, _, _ = run_pyramid(pyr1, pyr2, solve, warp, fc)
    return u, v
