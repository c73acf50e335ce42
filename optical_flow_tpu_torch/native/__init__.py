"""ctypes bindings for the native host runtime (port of
optical_flow_tpu/native/, with its own copies of framepipe.cpp and
v4l2cap.cpp).

The library decodes video through libavformat/libavcodec/libswscale on a
C++ thread into a ring of frames (``NativeFramePipe``), captures V4L2
cameras (``NativeCamera``) and reads and writes the reference's saveMat
text (``load_mat_native``, ``save_mat_native``). It is host code: frames
reach the card through ``io/prefetch.py`` and the pipeline's upload.

It is built at first use (never at import) with ``g++ -O3 -fPIC -std=c++17
-pthread -shared`` and the flags ``pkg-config`` gives for libavformat,
libavcodec, libavutil and libswscale (the JAX package's Makefile's
fallback, ``-lavformat -lavcodec -lavutil -lswscale``, where pkg-config
itself is missing), into ``build/native/`` at the root of the checkout,
under a name that hashes the sources, the flags and the compiler's and
packages' versions. Nothing is written into the JAX package.

As in the JAX package, ``load_library`` returns None when the library
cannot be had, and the functions that only report (``probe_native``,
``load_mat_native``, ``save_mat_native``) return None or False; the
reason (the compiler's output, the ``pkg-config`` packages not found) is
kept, ``unavailable_reason()`` returns it, and the classes raise with it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

SRC = Path(__file__).resolve().parent
SOURCES = ("framepipe.cpp", "v4l2cap.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-shared")
AV_PACKAGES = ("libavformat", "libavcodec", "libavutil", "libswscale")
AV_LIBS_FALLBACK = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_reason: Optional[str] = None  # why the library is unavailable, once tried

_I, _L, _P, _S = ctypes.c_int, ctypes.c_long, ctypes.c_void_p, ctypes.c_char_p
_IP, _DP = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {  # name: (restype, argtypes), the C interface of the two sources
    "fp_open": (_P, [_S, _I, _IP, _IP, _DP]),
    "fp_open_at": (_P, [_S, _I, _L, _IP, _IP, _DP]),
    "fp_open_fmt": (_P, [_S, _I, _L, _I, _IP, _IP, _DP]),
    "fp_probe": (_I, [_S, _IP, _IP, _DP]),
    "fp_next": (_I, [_P, _S]),
    "fp_buffered": (_I, [_P]),
    "fp_close": (None, [_P]),
    "cam_open": (_P, [_S, _I, _IP, _IP, _DP]),
    "cam_next": (_I, [_P, _S]),
    "cam_close": (None, [_P]),
    "gf_load": (_L, [_S, _DP, _L]),
    "gf_save": (_I, [_S, _DP, _L, _L]),
}


def av_flags() -> tuple:
    """(compiler and linker flags for the libav packages, the packages
    ``pkg-config`` does not find). Without ``pkg-config`` the flags are the
    plain ``-l`` list and the second item says so."""
    pkg_config = shutil.which("pkg-config")
    if pkg_config is None:
        return AV_LIBS_FALLBACK, ("pkg-config not found",)
    missing = tuple(p for p in AV_PACKAGES
                    if subprocess.run([pkg_config, "--exists", p]).returncode != 0)
    if missing:
        return AV_LIBS_FALLBACK, missing
    out = subprocess.run([pkg_config, "--cflags", "--libs", *AV_PACKAGES], capture_output=True,
                         text=True, check=True).stdout
    return tuple(out.split()), ()


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found (set CXX to a C++17 compiler)")
    return cxx


def _toolchain() -> str:
    """The compiler's and the libav packages' versions: a library built
    against other ones (another machine's checkout) is not reused."""
    cmds = [[_compiler(), "--version"]]
    if shutil.which("pkg-config"):
        cmds.append(["pkg-config", "--modversion", *AV_PACKAGES])
    return "\n".join(subprocess.run(c, capture_output=True, text=True).stdout for c in cmds)


def library_path(flags: tuple) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + tuple(flags)).encode())
    h.update(_toolchain().encode())
    for name in SOURCES:
        h.update((SRC / name).read_bytes())
    return BUILD_DIR / f"libframepipe_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library into ``BUILD_DIR`` if it is not there yet;
    return its path. Raises RuntimeError with the compiler's output and the
    libav packages ``pkg-config`` did not find."""
    flags, missing = av_flags()
    cxx = _compiler()
    out = library_path(flags)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *(str(SRC / s) for s in SOURCES), *flags]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the native build took over {BUILD_TIMEOUT_S} s: {' '.join(cmd)}")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        not_found = f"; pkg-config did not find {', '.join(missing)}" if missing else ""
        raise RuntimeError(f"the native build failed ({proc.returncode}){not_found}: "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


def load_library() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None if it cannot be built
    or loaded (``unavailable_reason()`` says why). Tried once a process."""
    global _lib, _reason
    with _lock:
        if _lib is not None or _reason is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError) as e:
            _reason = str(e)
            return None
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
        return _lib


def unavailable_reason() -> Optional[str]:
    """Why ``load_library`` returned None (None while it has not failed)."""
    return _reason


def require_library() -> ctypes.CDLL:
    """The native library, or RuntimeError naming why it is unavailable."""
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_reason}")
    return lib


def probe_native(path):
    """(width, height, fps) from container headers only (no decode thread);
    None if the native library is unavailable or the file can't be opened."""
    lib = load_library()
    if lib is None:
        return None
    w, h, fps = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_double(0.0)
    if lib.fp_probe(str(path).encode(), ctypes.byref(w), ctypes.byref(h), ctypes.byref(fps)):
        return None
    return w.value, h.value, fps.value


class _NativeSource:
    """A handle of the library that yields frames into one reused buffer;
    ``close`` (also on exit and at collection) releases it."""

    _next = _close = None  # names of the C functions

    def _start(self, lib, handle, w, h, fps, gray: bool) -> None:
        self._lib, self._h = lib, handle
        self.width, self.height, self.fps = w.value, h.value, fps.value
        self.gray = bool(gray)
        shape = (self.height, self.width) if gray else (self.height, self.width, 3)
        self._buf = np.empty(shape, np.uint8)

    def _frames(self) -> Iterator[np.ndarray]:
        next_frame = getattr(self._lib, self._next)
        while self._h and next_frame(self._h, self._buf.ctypes.data_as(ctypes.c_char_p)):
            yield self._buf.copy()

    def close(self) -> None:
        if getattr(self, "_h", None):
            getattr(self._lib, self._close)(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


class NativeFramePipe(_NativeSource):
    """Ring-buffered libavcodec decode on a C++ thread (overlaps compute)."""

    _next, _close = "fp_next", "fp_close"

    def __init__(self, path: str, ring: int = 4, start: int = 0, gray: bool = False):
        """start > 0 seeks the container (av_seek_frame to the preceding
        keyframe + decode-discard to the exact frame) before streaming —
        O(GOP) instead of decoding `start` frames. Raises RuntimeError if
        the stream can't seek (caller falls back to decode-and-skip).

        gray=True yields (H, W) GRAY8 frames — BT.601 luma straight from
        libswscale, one byte per pixel: a third of the bytes crossing
        host->device, for consumers that gray-convert first anyway (the
        fast-preset preprocess)."""
        lib = require_library()
        w, h, fps = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_double(0.0)
        handle = lib.fp_open_fmt(str(path).encode(), ring, start, 1 if gray else 0,
                                 ctypes.byref(w), ctypes.byref(h), ctypes.byref(fps))
        if not handle:
            raise RuntimeError(f"fp_open failed for {path} (start={start})")
        self._start(lib, handle, w, h, fps, gray)

    def __iter__(self) -> Iterator[np.ndarray]:
        return self._frames()

    def buffered(self) -> int:
        return int(self._lib.fp_buffered(self._h))


class NativeCamera(_NativeSource):
    """Live V4L2 capture via the kernel API (native/v4l2cap.cpp) — the
    reference's cv::VideoCapture(0) modality (ParallelVideoPyr.cpp:737)
    without OpenCV: ioctl + mmap streaming ring, libswscale conversion to
    BGR24 (or decode-time GRAY8), MJPEG cameras through libavcodec."""

    _next, _close = "cam_next", "cam_close"

    def __init__(self, device: str = "/dev/video0", gray: bool = False):
        lib = require_library()
        w, h, fps = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_double(0.0)
        handle = lib.cam_open(str(device).encode(), 1 if gray else 0, ctypes.byref(w),
                              ctypes.byref(h), ctypes.byref(fps))
        if not handle:
            raise RuntimeError(f"cam_open failed for {device}")
        self._start(lib, handle, w, h, fps, gray)

    def __iter__(self) -> Iterator[np.ndarray]:
        if not self._h:
            # the camera is single-shot: a previous iteration's cleanup
            # closed the device; a kernel capture stream cannot re-open
            raise RuntimeError(
                "NativeCamera already closed (cameras are single-"
                "iteration; open a new NativeCamera to capture again)"
            )
        return self._frames()


def load_mat_native(path, rows: int, cols: int) -> Optional[np.ndarray]:
    """saveMat-format text matrix via the C parser; None if the library is
    unavailable or the file does not hold exactly rows x cols values."""
    lib = load_library()
    if lib is None:
        return None
    out = np.empty(rows * cols, np.float64)
    n = lib.gf_load(str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    rows * cols)
    return out.reshape(rows, cols) if n == rows * cols else None


def save_mat_native(mat, path) -> bool:
    """Write ``mat`` (a host array or a tensor on any device) in saveMat
    format with the C writer; False if the library is unavailable."""
    from optical_flow_tpu_torch.utils.device import host_array

    lib = load_library()
    if lib is None:
        return False
    mat = np.ascontiguousarray(host_array(mat), np.float64)
    rows, cols = mat.shape
    rc = lib.gf_save(str(path).encode(), mat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                     rows, cols)
    return rc == 0
