"""The coarse-to-fine level loop (port of optical_flow_tpu/flow/pyramid_loop.py).

solve(level_index, img1, img2) -> (u, v)
warp(level_index, img1, img2, u, v) -> (w1, w2)        # symmetric half-flow
warp_solve(level_index, img1, img2, u, v) -> (du, dv)  # optional fusion (K4)
level_step(level_index, img1, img2, u_coarse, v_coarse) -> (u, v)  # K3
upsample(u_coarse, v_coarse) -> (pyr_up(u), pyr_up(v))  # reference mode (S1)

``warp_solve`` receives the same already-clamped/negated (u, v) the warp
would. ``level_step`` (corrected mode only) does the whole inter-level step
from the coarser level's accumulated flow. Both are used at every level
except, when ``need_images`` is True, the finest, whose warped frames are
part of the return contract (LKof.cpp:191-228). ``upsample`` replaces the
plain ``pyr_up`` of reference mode's inter-level step; corrected mode's
``pyr_up_cols_first`` (another sum order) stays plain.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from optical_flow_tpu_torch.config import FlowConfig
from optical_flow_tpu_torch.ops.pyramid import pyr_up, pyr_up_cols_first


def run_pyramid(
    pyr1: List[torch.Tensor],
    pyr2: List[torch.Tensor],
    solve: Callable,
    warp: Callable,
    config: FlowConfig,
    *,
    warp_solve: Optional[Callable] = None,
    level_step: Optional[Callable] = None,
    upsample: Optional[Callable] = None,
    need_images: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (u, v, finest_img1, finest_img2). With ``warp_solve`` /
    ``level_step`` and need_images=False the finest frames come back
    unwarped."""
    if config.mode not in ("reference", "corrected"):
        raise ValueError(f"mode must be 'reference' or 'corrected', got {config.mode!r}")
    corrected = config.mode == "corrected"
    if config.level_iters > 1 and not corrected:
        raise ValueError(
            "level_iters > 1 requires mode='corrected' (reference-mode flow "
            "is not displacement; re-warping by it diverges)"
        )
    if level_step is not None and not corrected:
        raise ValueError("level_step fuses the corrected-mode inter-level math")
    levels = len(pyr1)
    pyr1, pyr2 = list(pyr1), list(pyr2)
    orig1, orig2 = list(pyr1), list(pyr2)

    def _clamped(u, v):
        if config.warp_clamp is None:
            return u, v
        c = config.warp_clamp
        return torch.clamp(u, -c, c), torch.clamp(v, -c, c)

    for i in range(levels - 1, -1, -1):
        if i == levels - 1:
            u, v = solve(i, pyr1[i], pyr2[i])
        elif level_step is not None and not (i == 0 and need_images):
            u, v = level_step(i, pyr1[i], pyr2[i], u, v)
        else:
            if corrected:
                # displacement doubles between levels, and the warp brings the
                # frames together (the reference's own warp drives them apart)
                upu = 2.0 * pyr_up_cols_first(u)
                upv = 2.0 * pyr_up_cols_first(v)
                wu, wv = _clamped(upu, upv)
                wu, wv = -wu, -wv
            else:
                # flow NOT doubled: faithful to the reference
                upu, upv = (pyr_up(u), pyr_up(v)) if upsample is None else upsample(u, v)
                wu, wv = _clamped(upu, upv)
            if warp_solve is not None and not (i == 0 and need_images):
                du, dv = warp_solve(i, pyr1[i], pyr2[i], wu, wv)
            else:
                pyr1[i], pyr2[i] = warp(i, pyr1[i], pyr2[i], wu, wv)
                du, dv = solve(i, pyr1[i], pyr2[i])
            # accumulation stays unclamped: clip(upu) + du was measured worse
            # on the translation ladder (optical_flow_tpu/flow/pyramid_loop.py)
            u = du + upu
            v = dv + upv
        for _ in range(config.level_iters - 1):
            wu, wv = _clamped(u, v)
            if corrected:
                wu, wv = -wu, -wv
            if warp_solve is not None:
                du, dv = warp_solve(i, orig1[i], orig2[i], wu, wv)
            else:
                w1, w2 = warp(i, orig1[i], orig2[i], wu, wv)
                du, dv = solve(i, w1, w2)
            u = u + du  # unclamped here too (same measurement)
            v = v + dv
        if i == 0:
            return u, v, pyr1[0], pyr2[0]
    raise AssertionError("unreachable")
