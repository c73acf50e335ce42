"""Live annotated-frame preview over HTTP (the imshow counterpart; a copy
of optical_flow_tpu/io/preview.py, host-only).

The reference's interactive surface is an `imshow` window + `waitKey`
on the machine running the loop (ParallelVideoPyr.cpp:890-891,
of.cpp:86-87). A GPU host is headless and usually remote, so the live
surface is an HTTP MJPEG stream: point any browser
(or `ffplay http://host:PORT/stream`) at the host and watch the
annotated frames as the pipeline produces them.

Design constraints, in order:
- the PIPELINE must never stall on a viewer: `push()` is non-blocking,
  latest-frame-wins — a slow client (or none at all) just drops frames;
- zero dependencies beyond a JPEG encoder (cv2 if present, else
  Pillow); stdlib `http.server` threads, one per client;
- multiple clients are fine (each streams the shared latest frame).

Endpoints:  `/`          tiny HTML page wrapping the stream
            `/stream`    multipart/x-mixed-replace MJPEG
            `/frame.jpg` single latest frame (curl-able health check)
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

_BOUNDARY = "oftframe"


def _encode_jpeg(rgb: np.ndarray, quality: int = 85) -> bytes:
    """(H, W, 3) uint8 RGB (or (H, W) gray) -> JPEG bytes."""
    try:
        import cv2

        bgr = rgb[..., ::-1] if rgb.ndim == 3 else rgb
        ok, buf = cv2.imencode(
            ".jpg", bgr, [int(cv2.IMWRITE_JPEG_QUALITY), quality]
        )
        if not ok:
            raise RuntimeError("cv2.imencode failed")
        return buf.tobytes()
    except ImportError:
        import io

        from PIL import Image

        mode = "RGB" if rgb.ndim == 3 else "L"
        bio = io.BytesIO()
        Image.fromarray(rgb, mode).save(bio, "JPEG", quality=quality)
        return bio.getvalue()


def _require_jpeg_encoder() -> None:
    """Raise unless cv2 or Pillow can be imported (the preview has no JPEG
    encoder of its own)."""
    import importlib.util

    if not (importlib.util.find_spec("cv2") or importlib.util.find_spec("PIL")):
        raise RuntimeError("MjpegPreview needs a JPEG encoder: install opencv-python (cv2) "
                           "or Pillow (PIL)")


class _Handler(BaseHTTPRequestHandler):
    daemon_threads = True

    def log_message(self, *a):  # quiet: the pipeline owns stdout
        pass

    def do_GET(self):
        prev: MjpegPreview = self.server.preview  # type: ignore[attr-defined]
        if self.path in ("/", "/index.html"):
            body = (
                b"<html><body style='margin:0;background:#111'>"
                b"<img src='/stream' style='width:100%'/></body></html>"
            )
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/frame.jpg":
            jpeg = prev.latest(timeout=5.0)
            if jpeg is None:
                self.send_response(503)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", "image/jpeg")
            self.send_header("Content-Length", str(len(jpeg)))
            self.end_headers()
            self.wfile.write(jpeg)
        elif self.path == "/stream":
            self.send_response(200)
            self.send_header(
                "Content-Type",
                f"multipart/x-mixed-replace; boundary={_BOUNDARY}",
            )
            self.end_headers()
            seq = -1
            try:
                while not prev.closed:
                    jpeg, seq = prev.wait_next(seq, timeout=1.0)
                    if jpeg is None:
                        continue  # timeout: poll the closed flag again
                    self.wfile.write(
                        b"--%s\r\nContent-Type: image/jpeg\r\n"
                        b"Content-Length: %d\r\n\r\n"
                        % (_BOUNDARY.encode(), len(jpeg))
                    )
                    self.wfile.write(jpeg)
                    self.wfile.write(b"\r\n")
            except (BrokenPipeError, ConnectionResetError):
                pass  # viewer left; the pipeline never notices
        else:
            self.send_response(404)
            self.end_headers()


class MjpegPreview:
    """Non-blocking live preview server.

    >>> prev = MjpegPreview(port=0)       # 0 = ephemeral
    >>> print("watch at", prev.url)
    >>> for frame in frames: prev.push(annotated_rgb)
    >>> prev.close()
    """

    def __init__(self, host: str = "0.0.0.0", port: int = 8089,
                 quality: int = 85):
        _require_jpeg_encoder()
        self._cond = threading.Condition()
        self._jpeg: Optional[bytes] = None
        self._seq = 0
        self._quality = quality
        self.closed = False
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self._server.preview = self  # type: ignore[attr-defined]
        self.address: Tuple[str, int] = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    @property
    def url(self) -> str:
        host, port = self.address
        shown = "localhost" if host in ("0.0.0.0", "::") else host
        return f"http://{shown}:{port}/"

    def push(self, frame: np.ndarray) -> None:
        """Publish a frame (RGB (H,W,3) or gray (H,W), uint8). Encoding
        runs on the caller thread (~1 ms at preview sizes); distribution
        to however many viewers is push-free (they wake on the cond)."""
        if self.closed:
            return
        jpeg = _encode_jpeg(np.ascontiguousarray(frame), self._quality)
        with self._cond:
            self._jpeg = jpeg
            self._seq += 1
            self._cond.notify_all()

    def latest(self, timeout: float = 0.0) -> Optional[bytes]:
        with self._cond:
            if self._jpeg is None and timeout > 0:
                self._cond.wait(timeout)
            return self._jpeg

    def wait_next(self, after_seq: int, timeout: float = 1.0):
        """Block until a frame newer than after_seq exists; (jpeg, seq)
        or (None, after_seq) on timeout. Waits BOTH when no newer seq
        exists and when no frame has ever been pushed — a viewer
        connecting before the first push (the first frame waits for the
        kernels' build) must park on the condition, not busy-spin the
        handler thread."""
        with self._cond:
            if self._seq <= after_seq or self._jpeg is None:
                self._cond.wait(timeout)
            if self._seq <= after_seq or self._jpeg is None:
                return None, after_seq
            return self._jpeg, self._seq

    def close(self) -> None:
        self.closed = True
        with self._cond:
            self._cond.notify_all()
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
