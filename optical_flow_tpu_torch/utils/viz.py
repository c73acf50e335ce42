"""Flow-field and gesture visualization (headless; a copy of
optical_flow_tpu/utils/viz.py, host numpy).

The reference's observability is `imshow` windows plus a circle drawn on the
live frame (ParallelVideoPyr.cpp:886-890, of.cpp:63-87). Headless
replacements: flow -> HSV color wheel image, magnitude heatmaps, and circle
overlays, all as uint8 arrays writable with PIL/cv2.
"""

from __future__ import annotations

import numpy as np

from optical_flow_tpu_torch.utils.device import host_array


def flow_to_color(u, v, max_mag: float | None = None) -> np.ndarray:
    """Dense flow -> uint8 RGB (HSV wheel: hue = direction, value = speed).
    ``u``, ``v``: host arrays or tensors on any device."""
    u = np.asarray(host_array(u), np.float32)
    v = np.asarray(host_array(v), np.float32)
    mag = np.sqrt(u * u + v * v)
    ang = np.arctan2(v, u)  # [-pi, pi]
    if max_mag is None:
        max_mag = max(float(mag.max()), 1e-6)
    h = (ang + np.pi) / (2 * np.pi)  # [0,1)
    s = np.ones_like(h)
    val = np.clip(mag / max_mag, 0, 1)
    i = np.floor(h * 6).astype(np.int32) % 6
    f = h * 6 - np.floor(h * 6)
    p = val * (1 - s)
    q = val * (1 - f * s)
    t = val * (1 - (1 - f) * s)
    r = np.choose(i, [val, q, p, p, t, val])
    g = np.choose(i, [t, val, val, q, p, p])
    b = np.choose(i, [p, p, t, val, val, q])
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def draw_circle(img: np.ndarray, cx: float, cy: float, radius: int, color=(255, 0, 0), thickness: int = 2) -> np.ndarray:
    """Draw a circle outline on an (H, W, 3) uint8 image (pure numpy)."""
    out = np.array(img, copy=True)
    H, W = out.shape[:2]
    yy, xx = np.mgrid[0:H, 0:W]
    d = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    ring = np.abs(d - radius) <= thickness / 2
    out[ring] = color
    return out


def annotate_gesture_frame(frame, gesture, proc_size, circle_radius: int):
    """The reference's live overlay on ONE original frame: BGR -> RGB
    (gray frames promoted to 3 channels when drawing), the gesture
    centroid rescaled from processing coords to frame coords, and the
    detection circle drawn (ParallelVideoPyr.cpp:884-890). Shared by the
    CLI's --annotate/--preview paths — one copy of the rescale semantics.
    ``frame`` is a host array and ``gesture`` a GestureResult of one frame;
    its fields are read as host scalars (``bool``/``float`` of a tensor on
    any device)."""
    fr = np.asarray(frame)
    rgb = fr[..., ::-1] if fr.ndim == 3 else fr
    if bool(gesture.detected):
        ph, pw = proc_size
        fh, fw = rgb.shape[:2]
        if rgb.ndim == 2:
            rgb = np.repeat(rgb[..., None], 3, axis=-1)
        rgb = draw_circle(
            rgb,
            float(gesture.cx) * fw / pw,
            float(gesture.cy) * fh / ph,
            radius=max(1, round(circle_radius * fw / pw)),
            color=(255, 0, 0),
        )
    return rgb


def draw_arrows(
    img: np.ndarray,
    pts: np.ndarray,
    flows: np.ndarray,
    mask: np.ndarray | None = None,
    scale: float = 1.0,
    thickness: int = 1,
) -> np.ndarray:
    """Draw flow arrows (line + head dot) on an (H, W, 3) uint8 image —
    the reference's sparse-track rendering (OpticalFlowDemo.cpp:211-254,
    of.cpp:63-77: red/green by x-direction)."""
    out = np.array(img, copy=True)
    H, W = out.shape[:2]
    if mask is None:
        mask = np.ones(len(pts), bool)
    for (x, y), (dx, dy), ok in zip(pts, flows, mask):
        if not ok:
            continue
        color = (255, 0, 0) if dx < 0 else (0, 255, 0)
        x1, y1 = x + dx * scale, y + dy * scale
        n = max(int(np.hypot(x1 - x, y1 - y)) * 2, 1)
        xs = np.clip(np.linspace(x, x1, n).round().astype(int), 0, W - 1)
        ys = np.clip(np.linspace(y, y1, n).round().astype(int), 0, H - 1)
        for t in range(-(thickness // 2), thickness // 2 + 1):
            out[np.clip(ys + t, 0, H - 1), xs] = color
        hx, hy = int(round(x1)), int(round(y1))
        # clamp BOTH ends: a negative stop index wraps around and floods
        # a large region with the arrow color (round-5 review)
        y0d, y1d = max(0, hy - 1), max(0, min(H, hy + 2))
        x0d, x1d = max(0, hx - 1), max(0, min(W, hx + 2))
        out[y0d:y1d, x0d:x1d] = color
    return out


def save_png(img: np.ndarray, path) -> None:
    from PIL import Image

    Image.fromarray(img).save(str(path))
