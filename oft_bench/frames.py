"""The benchmark's camera: a ring of 64 distinct 720x1280 BGR uint8 frames
made from a seed.

A textured patch moves over a textured background on a closed path: a
circle of radius ``RADIUS`` walked once in ``RING`` frames, its positions
rounded to whole pixels, so each step moves the patch 2-3 px and no two
frames of the ring are alike. Frame ``i`` of a clip of any length is ring
frame ``(start + i) % RING``: the motion is continuous across the ring's
wrap. The seed draws the textures, the tint and the phase of the path;
sizes, path and speed are the same for every seed.

The textures are ``chip_smoke.py``'s ``smooth_texture`` (Gaussian-smoothed
uniform noise), the composition its ``synthetic_frames`` with a periodic
path in place of a straight one that leaves the frame.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

RING = 64
FRAME_HW = (720, 1280)
RADIUS = 26.0


def _rng(seed: int) -> np.random.Generator:
    """A generator for any whole number (negative and past 64 bits too)."""
    return np.random.default_rng(int(seed) % (1 << 64))


def smooth_texture(rng: np.random.Generator, h: int, w: int, sigma: float) -> np.ndarray:
    """Unit-range random texture, Gaussian-smoothed (FFT, periodic)."""
    noise = rng.random((h, w))
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    g = np.exp(-2.0 * (np.pi * sigma) ** 2 * (fx * fx + fy * fy))
    t = np.fft.irfft2(np.fft.rfft2(noise) * g, s=(h, w))
    t -= t.min()
    return t / max(t.max(), 1e-12)


def path(phase: float, ring: int = RING, radius: float = RADIUS) -> List[Tuple[int, int]]:
    """The patch's (dy, dx) offset in each ring frame."""
    out = []
    for t in range(ring):
        a = phase + 2.0 * math.pi * t / ring
        out.append((int(round(radius * math.sin(a))), int(round(radius * math.cos(a)))))
    return out


def ring(seed: int, hw: Tuple[int, int] = FRAME_HW, n: int = RING) -> List[np.ndarray]:
    """``n`` BGR uint8 frames of ``hw``: the ring of ``seed``."""
    rng = _rng(seed)
    H, W = hw
    bg = smooth_texture(rng, H, W, 4.0)
    ph, pw = H // 4, W // 6
    patch = smooth_texture(rng, ph, pw, 2.0)
    tint = rng.random(3) * 0.5 + 0.5
    phase = float(rng.random()) * 2.0 * math.pi
    base = np.clip((0.6 * bg)[..., None] * tint * 255.0, 0, 255).astype(np.uint8)
    fg = np.clip((0.3 + 0.7 * patch)[..., None] * tint * 255.0, 0, 255).astype(np.uint8)
    y0, x0 = (H - ph) // 2, (W - pw) // 2
    frames = []
    for dy, dx in path(phase, n, RADIUS * min(1.0, H / 720.0)):
        f = base.copy()
        f[y0 + dy : y0 + dy + ph, x0 + dx : x0 + dx + pw] = fg
        frames.append(f)
    return frames
