"""Per-pixel 2x2 structure-tensor (Cramer) solve (reference C7 tail,
LKof.cpp:170-174) with ``cv::divide`` semantics: x / 0 -> 0."""

from __future__ import annotations

from typing import Tuple

import torch


def safe_divide(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den with den == 0 -> 0; nonfinite inputs propagate."""
    ok = den != 0
    return torch.where(ok, num, torch.zeros_like(num)) / torch.where(
        ok, den, torch.ones_like(den)
    )


def solve_lk_2x2(sfx2, sfy2, sfxfy, sfxft, sfyft) -> Tuple[torch.Tensor, torch.Tensor]:
    det = sfx2 * sfy2 - sfxfy * sfxfy
    u = safe_divide(sfxfy * sfyft - sfy2 * sfxft, det)
    v = safe_divide(sfxft * sfxfy - sfx2 * sfyft, det)
    return u, v
