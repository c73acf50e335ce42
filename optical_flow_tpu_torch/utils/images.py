"""Image loading helpers (a copy of optical_flow_tpu/utils/images.py;
host numpy).

OpenCV's ``imread(path, 0)`` decodes JPEG and converts to gray with the
fixed-point BT.601 weights ((R*4899 + G*9617 + B*1868 + 8192) >> 14). JPEG
decoding itself must also match libjpeg output; PIL uses libjpeg too, so
PIL-decode + fixed-point gray reproduces cv2.imread(path, 0) exactly for
baseline JPEGs. We prefer cv2 when present (same library the reference
linked), else PIL. The JAX package first warms one TPU compile before a
codec library loads (utils/compat.py); the port has no such runtime and
skips it.
"""

from __future__ import annotations

import numpy as np


def bgr_to_gray_u8(bgr: np.ndarray) -> np.ndarray:
    """OpenCV CV_BGR2GRAY on uint8: fixed-point BT.601 with 15-bit
    coefficients (R 9798, G 19235, B 3735) — verified exact vs cv2 5.0."""
    b = bgr[..., 0].astype(np.int64)
    g = bgr[..., 1].astype(np.int64)
    r = bgr[..., 2].astype(np.int64)
    return ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15).astype(np.uint8)


def imread_gray(path) -> np.ndarray:
    try:
        import cv2

        img = cv2.imread(str(path), 0)
        if img is None:
            raise FileNotFoundError(path)
        return img
    except ImportError:
        from PIL import Image

        rgb = np.asarray(Image.open(path).convert("RGB"))
        return bgr_to_gray_u8(rgb[..., ::-1])
