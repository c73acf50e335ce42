"""Headless annotated-video output (a copy of
optical_flow_tpu/io/video_writer.py; host-only).

The reference shows its detection overlay in a live `imshow` window
(ParallelVideoPyr.cpp:884-891). Headless jobs need a file instead:
`VideoWriter` encodes (H, W, 3) uint8 RGB frames to a video, falling back
gracefully:

  ffmpeg pipe (raw RGB in, h264/mpeg4 out)  ->  cv2.VideoWriter  ->
  numbered PNG directory (always available).

The backend is chosen as the JAX package chooses it. Its construction there
first warms one TPU compile (utils/compat.py: a codec library loaded before
the TPU runtime's first compile deadlocks it); the port has no such
runtime and skips that step.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np


class VideoWriter:
    """Write RGB uint8 frames to `path` (extension picks the container;
    a directory path or backend='png' writes frame_%05d.png instead).

    Usage:
        with VideoWriter("out.mp4", fps=30) as w:
            w.write(frame)          # (H, W, 3) uint8, RGB
    """

    def __init__(self, path, fps: float = 30.0, backend: str = "auto"):
        self.path = Path(path)
        self.fps = float(fps)
        self._proc: Optional[subprocess.Popen] = None
        self._cv2_writer = None
        self._png_dir: Optional[Path] = None
        self._count = 0
        self._shape = None
        if backend == "auto":
            if self.path.suffix == "" :
                backend = "png"
            elif shutil.which("ffmpeg"):
                backend = "ffmpeg"
            else:
                try:
                    import cv2  # noqa: F401

                    backend = "cv2"
                except ImportError:
                    backend = "png"
        self.backend = backend
        if backend == "png":
            self._png_dir = self.path if self.path.suffix == "" else self.path.with_suffix("")
            self._png_dir.mkdir(parents=True, exist_ok=True)
        elif backend not in ("ffmpeg", "cv2"):
            raise ValueError(f"unknown backend {backend!r}")

    def _open(self, h: int, w: int) -> None:
        self._shape = (h, w)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if self.backend == "ffmpeg":
            self._proc = subprocess.Popen(
                [
                    "ffmpeg", "-y", "-loglevel", "error",
                    "-f", "rawvideo", "-pix_fmt", "rgb24",
                    "-s", f"{w}x{h}", "-r", str(self.fps), "-i", "-",
                    # yuv420p needs even dims; odd source sizes (a 427px
                    # clip via --annotate) would kill the encoder and
                    # surface as BrokenPipeError on the next write
                    "-vf", "pad=ceil(iw/2)*2:ceil(ih/2)*2",
                    "-pix_fmt", "yuv420p", str(self.path),
                ],
                stdin=subprocess.PIPE,
            )
        elif self.backend == "cv2":
            import cv2

            self._cv2_writer = cv2.VideoWriter(
                str(self.path),
                cv2.VideoWriter_fourcc(*"mp4v"),
                self.fps,
                (w, h),
            )

    def write(self, frame: np.ndarray) -> None:
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        if frame.ndim != 3 or frame.shape[2] != 3:
            raise ValueError(f"expected (H, W, 3) RGB uint8, got {frame.shape}")
        if self.backend == "png":
            from optical_flow_tpu_torch.utils.viz import save_png

            save_png(frame, self._png_dir / f"frame_{self._count:05d}.png")
            self._count += 1
            return
        if self._shape is None:
            self._open(frame.shape[0], frame.shape[1])
        elif self._shape != frame.shape[:2]:
            raise ValueError(f"frame size changed: {self._shape} -> {frame.shape[:2]}")
        if self.backend == "ffmpeg":
            self._proc.stdin.write(frame.tobytes())
        else:
            import cv2

            self._cv2_writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        self._count += 1

    def close(self) -> None:
        if self._proc is not None:
            self._proc.stdin.close()
            rc = self._proc.wait()
            self._proc = None
            if rc != 0:
                raise RuntimeError(f"ffmpeg encoder exited with rc={rc}")
        if self._cv2_writer is not None:
            self._cv2_writer.release()
            self._cv2_writer = None

    def __enter__(self) -> "VideoWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def frames_written(self) -> int:
        return self._count
