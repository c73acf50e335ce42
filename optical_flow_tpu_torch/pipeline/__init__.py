"""Video/gesture application pipeline (reference L4): preprocess,
pyramidal LK on consecutive preprocessed frames, gesture detection; the
steady steps replayed as CUDA graphs on a card (pipeline/graphs.py)."""

from optical_flow_tpu_torch.pipeline.preprocess import (
    dilate3x3,
    erode3x3,
    gaussian_blur,
    preprocess_frame,
    resize_cubic,
    sobel3,
    temporal_diff,
    threshold_tozero,
)
from optical_flow_tpu_torch.pipeline.gesture import GestureResult, detect_gesture
from optical_flow_tpu_torch.pipeline.video import VideoPipeline

__all__ = [
    "GestureResult",
    "VideoPipeline",
    "detect_gesture",
    "dilate3x3",
    "erode3x3",
    "gaussian_blur",
    "preprocess_frame",
    "resize_cubic",
    "sobel3",
    "temporal_diff",
    "threshold_tozero",
]
