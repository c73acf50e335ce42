"""Video/gesture application pipeline (reference L4): float preprocess,
pyramidal LK on consecutive preprocessed frames, gesture detection."""

from optical_flow_tpu_torch.pipeline.preprocess import (
    dilate3x3,
    erode3x3,
    preprocess_frame,
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
    "preprocess_frame",
    "sobel3",
    "temporal_diff",
    "threshold_tozero",
]
