"""Video decode backends (port of optical_flow_tpu/io/video_reader.py).

Frames come out as numpy arrays on the host; decoding never belongs on
the card. Backends:

- ``native``: the native host runtime's libavcodec decoder on a C++
  thread (``optical_flow_tpu_torch/native``), with container seeks for
  ``read_frames(start=)`` and decode-time GRAY8;
- ``v4l2``: the native runtime's V4L2 camera capture;
- ``pipe``: a rawvideo source ``'pipe:WxH[@FPS]:PATH'`` (BGR24, or GRAY8
  with ``gray=True``) read from a FIFO or a file, as an external capture
  tool writes it;
- ``ffmpeg``: an ffmpeg subprocess streaming raw frames over a pipe, its
  geometry from ffprobe;
- ``cv2``: ``cv2.VideoCapture``, for files and cameras.

``'auto'`` chooses as the JAX package does: a file goes to ``native`` when
the library loads and its probe opens the file, else to ``ffmpeg`` when
ffprobe reads it, else to ``cv2``; a camera to ``v4l2``, else ``cv2``.
``reader.backend`` names the choice. Asked for by name, ``native`` and
``v4l2`` raise with the library's reason rather than decode elsewhere.
"""

from __future__ import annotations

import json
import shutil
import subprocess
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

from optical_flow_tpu_torch import native


def _probe_ffmpeg(path: str) -> Optional[Tuple[int, int, float]]:
    """(width, height, fps) via ffprobe, or None if unavailable."""
    ffprobe = shutil.which("ffprobe")
    if ffprobe is None:
        return None
    try:
        out = subprocess.run(
            [
                ffprobe, "-v", "error", "-select_streams", "v:0",
                "-show_entries", "stream=width,height,avg_frame_rate",
                "-of", "json", path,
            ],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
        st = json.loads(out)["streams"][0]
        num, den = st["avg_frame_rate"].split("/")
        fps = float(num) / float(den) if float(den) else 0.0
        return int(st["width"]), int(st["height"]), fps
    except (OSError, subprocess.SubprocessError, ValueError, KeyError, IndexError):
        return None


def _parse_pipe_spec(spec: str):
    """'pipe:WxH[@FPS]:PATH' -> (width, height, fps, path) or None."""
    if not spec.startswith("pipe:"):
        return None
    try:
        geom, path = spec[5:].split(":", 1)
        if "@" in geom:
            geom, fps = geom.split("@", 1)
            fps = float(fps)
        else:
            fps = 0.0
        w, h = (int(x) for x in geom.split("x"))
        return w, h, fps, path
    except ValueError:
        raise ValueError(f"bad pipe spec {spec!r}: expected pipe:WxH[@FPS]:PATH") from None


def _parse_device_spec(path):
    """Camera sources -> '/dev/videoN' device path, else None. Accepts an
    int, a digit string, 'device:N' and '/dev/videoN' (the reference's
    VideoCapture(0), ParallelVideoPyr.cpp:737)."""
    if isinstance(path, int):
        return f"/dev/video{path}"
    s = str(path)
    if s.isdigit():
        return f"/dev/video{int(s)}"
    if s.startswith("device:") and s[7:].isdigit():
        return f"/dev/video{int(s[7:])}"
    if s.startswith("/dev/video"):
        return s
    return None


def _read_exact(f, nbytes: int, shape) -> Iterator[np.ndarray]:
    """Whole frames of ``nbytes`` from a binary stream until a short read."""
    while True:
        buf = f.read(nbytes)
        if len(buf) < nbytes:
            return
        yield np.frombuffer(buf, np.uint8).reshape(shape)


class VideoReader:
    """Iterate HxWx3 uint8 BGR frames from a video file, camera or pipe.

    Camera sources — an integer, 'device:N' or '/dev/videoN' (the
    reference's VideoCapture(0), ParallelVideoPyr.cpp:737) — capture via
    the native V4L2 backend, else cv2.VideoCapture.

    gray=True yields (H, W) GRAY8 frames instead: BT.601 luma made during
    decode (native, ffmpeg) or on the host (cv2), so a third of the bytes
    cross to the card for gray-first consumers (the fast preset).
    """

    def __init__(self, path, backend: str = "auto", gray: bool = False):
        self.gray = bool(gray)
        pipe = _parse_pipe_spec(path) if isinstance(path, str) else None
        if pipe is not None:
            self.width, self.height, self.fps, self.path = pipe
            self.backend = "pipe"
            return
        dev = _parse_device_spec(path)
        if dev is not None:
            self.path = dev
            self._init_camera(backend)
            return
        self.path = str(path)
        if not Path(self.path).exists():
            raise FileNotFoundError(self.path)
        probe = None
        if backend == "auto":
            # commit only to a backend whose probe opens this file
            probe = native.probe_native(self.path)
            if probe is not None:
                backend = "native"
            else:
                probe = _probe_ffmpeg(self.path) if shutil.which("ffmpeg") else None
                backend = "ffmpeg" if probe else "cv2"
        self.backend = backend
        if backend == "native":
            native.require_library()
            probe = probe or native.probe_native(self.path)
            if probe is None:
                raise RuntimeError(f"native probe failed for {self.path}")
            self.width, self.height, self.fps = probe
        elif backend == "ffmpeg":
            probe = probe or _probe_ffmpeg(self.path)
            if probe is None:
                raise RuntimeError(
                    f"ffprobe unavailable or failed for {self.path} "
                    "(backend='ffmpeg' requires a working ffprobe)"
                )
            self.width, self.height, self.fps = probe
        elif backend == "cv2":
            self._probe_cv2()
        else:
            raise ValueError(f"unknown backend {backend!r}")

    def _init_camera(self, backend: str) -> None:
        if backend in ("auto", "v4l2"):
            # an explicit v4l2 raises with the library's reason, never degrades to cv2
            lib = native.require_library() if backend == "v4l2" else native.load_library()
            if lib is not None:
                try:
                    cam = native.NativeCamera(self.path, gray=self.gray)
                except RuntimeError:
                    if backend == "v4l2":
                        raise
                else:
                    self.backend = "v4l2"
                    self.width, self.height, self.fps = cam.width, cam.height, cam.fps
                    self._camera = cam
                    return
        # cv2 (any other backend named for a camera, as in the JAX package)
        # wants the device index
        self.backend = "cv2"
        self.path = int(self.path[len("/dev/video"):])
        self._probe_cv2()

    def _probe_cv2(self) -> None:
        import cv2

        cap = cv2.VideoCapture(self.path)
        self.width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.fps = cap.get(cv2.CAP_PROP_FPS)
        cap.release()

    def _frame_shape(self):
        return (self.height, self.width) if self.gray else (self.height, self.width, 3)

    def _frame_bytes(self) -> int:
        return self.width * self.height * (1 if self.gray else 3)

    def __iter__(self) -> Iterator[np.ndarray]:
        if self.backend == "v4l2":
            with self._camera as cam:
                yield from cam
        elif self.backend == "native":
            with native.NativeFramePipe(self.path, gray=self.gray) as pipe:
                yield from pipe
        elif self.backend == "pipe":
            yield from self._iter_pipe()
        elif self.backend == "ffmpeg":
            yield from self._iter_ffmpeg()
        else:
            yield from self._iter_cv2()

    def _iter_pipe(self):
        nbytes = self._frame_bytes()
        with open(self.path, "rb", buffering=nbytes * 4) as f:
            yield from _read_exact(f, nbytes, self._frame_shape())

    def _iter_ffmpeg(self):
        nbytes = self._frame_bytes()
        proc = subprocess.Popen(
            [
                shutil.which("ffmpeg"), "-v", "error", "-i", self.path,
                "-f", "rawvideo", "-pix_fmt", "gray" if self.gray else "bgr24", "-",
            ],
            stdout=subprocess.PIPE,
            bufsize=nbytes * 4,
        )
        try:
            yield from _read_exact(proc.stdout, nbytes, self._frame_shape())
        finally:
            proc.stdout.close()
            proc.terminate()
            proc.wait()

    def _iter_cv2(self):
        import cv2

        cap = cv2.VideoCapture(self.path)
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                yield cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY) if self.gray else frame
        finally:
            cap.release()


def read_frames(
    path,
    max_frames: Optional[int] = None,
    start: int = 0,
    stride: int = 1,
    gray: bool = False,
) -> Iterator[np.ndarray]:
    """Frames [start::stride], up to max_frames of them (the reference demo's
    frame scrubbing, OpticalFlowDemo.cpp:265-274). With the native decoder
    ``start`` seeks the container (av_seek_frame to the preceding keyframe,
    then decode-discard to the exact frame); other backends, and streams
    that cannot seek, decode and skip, which is exact for any codec.
    gray=True yields (H, W) luma (see VideoReader)."""
    if stride < 1:
        raise ValueError("stride must be >= 1 (decode cannot run backwards)")
    reader = VideoReader(path, gray=gray)
    source: Iterator[np.ndarray] = iter(reader)
    base = 0
    if start > 0 and reader.backend == "native":
        try:
            pipe = native.NativeFramePipe(reader.path, start=start, gray=gray)
        except RuntimeError:
            pass  # the stream cannot seek: decode and skip below
        else:
            source, base = _closing(pipe), start
    yielded = 0
    for i, frame in enumerate(source, start=base):
        if i < start or (i - start) % stride:
            continue
        if max_frames is not None and yielded >= max_frames:
            break
        yield frame
        yielded += 1


def _closing(pipe) -> Iterator[np.ndarray]:
    with pipe:
        yield from pipe
