"""Build, load and launch the port's CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a``, one
``nvcc`` process per source, all started together, and linked into one
shared library with a plain C interface, loaded with ``ctypes``. The build
happens at the first launch (never at import), into ``build/kernels/`` at
the root of the checkout, under a name that hashes the sources and flags,
so an edited source is rebuilt and an unchanged one is reused.

Flags: ``-O3 -fmad=false`` and no ``--use_fast_math``. Without contraction
every product and sum rounds as in eager PyTorch, so a kernel agrees with
its plain version to the last bit or nearly; fast math would make ``/``
approximate and flush denormals.

Each C entry point returns ``cudaGetLastError()``; ``launch`` raises if it
is not 0 and otherwise adds one to the kernel's count in ``launches``. A
launch captured into a CUDA graph runs only when the graph is replayed, so
it is not counted there: inside ``captured_launches()`` it goes to the
graph's own tally, which ``add_launches`` adds to ``launches`` once per
replay (``pipeline/graphs.py``).

What the compiler allotted each kernel (``ptxas -v``: registers, shared
memory, spills) is kept beside the library (``ptxas_info``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("lk.cu", "pyrdown.cu", "warp_lk.cu", "tile_copy.cu", "pyrup.cu", "remap.cu",
           "features.cu", "probes.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
)

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_LP = ctypes.POINTER(ctypes.c_longlong)  # a host array, e.g. (ctypes.c_longlong * n)(...)
# Every entry point ends with the stream (a cudaStream_t passed as a pointer).
_ARGTYPES = {
    "oft_lk": [_P, _P, _P, _P, _I, _I, _I, _P],
    "oft_pyrdown": [_P, _P, _I, _I, _I, _P],
    "oft_pyramid": [_P, _P, _LP, _I, _I, _I, _I, _P],  # x, out, level offsets, B, H, W, levels
    "oft_warp_lk": [_P] * 6 + [_I, _I, _I, _I, _F, _F, _P],
    "oft_pyrup_warp_lk": [_P] * 6 + [_I, _I, _I, _I, _F, _P],
    # K5: ... halo, row0, col0, Hg, Wg (K3 also the coarse row halo after halo)
    "oft_warp_lk_tile": [_P] * 6 + [_I, _I, _I, _I, _F, _F] + [_I] * 5 + [_P],
    "oft_pyrup_warp_lk_tile": [_P] * 6 + [_I, _I, _I, _I, _F] + [_I] * 6 + [_P],
    "oft_tile_copy": [_P, _P, _L, _P],
    "oft_pyrup": [_P] * 4 + [_I] * 3 + [_P],
    "oft_remap": [_P] * 6 + [_I] * 5 + [_P],  # ... B, H, W, uint8 frames, quantize
    # cur, prev, out, B, H, W, uint8 planes, saturate, learning_rate, diff_thresh, radius
    "oft_diff_features": [_P] * 3 + [_I] * 5 + [_F, _F, _I, _P],
    # the probes S2-S4 (csrc/probes.cu); the last int of each: take the 16-byte path
    "oft_interleave_rows": [_P] * 3 + [_I] * 3 + [_P],
    "oft_interleave_cols_f2": [_P] * 3 + [_I] * 3 + [_P],
    "oft_interleave_cols_smem": [_P] * 3 + [_I] * 3 + [_P],
    "oft_colsum_smem": [_P] * 2 + [_I] * 4 + [_P],
    "oft_colsum_shfl": [_P] * 2 + [_I] * 4 + [_P],
    "oft_mul_add_chain_f32": [_P] * 3 + [_L, _I, _I, _P],
    "oft_mul_add_chain_bf16": [_P] * 3 + [_L, _I, _I, _P],
}

# Launch counts by C entry point: incremented only where a kernel launched.
launches = dict.fromkeys(_ARGTYPES, 0)

_lib = None
_lock = threading.Lock()
_capture = threading.local()  # .tally: the launches of the graph this thread captures


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def add_launches(counts) -> None:
    """Add a captured graph's launches to ``launches`` (once per replay)."""
    for name, n in counts.items():
        launches[name] += n


@contextmanager
def captured_launches():
    """Tally the launches that this thread captures into a CUDA graph: they
    are counted in the dict yielded, not in ``launches``. A launch captured
    outside this context is counted nowhere."""
    tally = dict.fromkeys(_ARGTYPES, 0)
    _capture.tally = tally
    try:
        yield tally
    finally:
        _capture.tally = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found (looked in {candidate} and on PATH)")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"liboft_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; return its path."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{Path(s).stem}.o") for s in SOURCES]
    compiles = [
        [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(o), str(CSRC / s)]
        for s, o in zip(SOURCES, objs)
    ]
    procs = []
    try:
        for c in compiles:
            procs.append(subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
        # communicate() on each in turn: the others keep compiling meanwhile
        results = [(cmd, p.communicate()[0], p.returncode) for cmd, p in zip(compiles, procs)]
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        if all(rc == 0 for _, _, rc in results):
            proc = subprocess.run(link, capture_output=True, text=True)
            results.append((link, proc.stdout + proc.stderr, proc.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for o in objs:
            o.unlink(missing_ok=True)
    for cmd, output, rc in results:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{output}")
    _ptxas_path(out).write_text("".join(output for _, output, _ in results[: len(SOURCES)]))
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


def _ptxas_path(lib: Path) -> Path:
    return lib.with_name(lib.name + ".ptxas.txt")


def ptxas_info(kernel: str) -> list:
    """The ``ptxas -v`` lines of the built library's kernels whose mangled
    name contains ``kernel``: one "<name>: <registers and memory>" each."""
    path = _ptxas_path(build())
    out, name = [], None
    for line in path.read_text().splitlines() if path.exists() else []:
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else None
        elif name and kernel in name and ("registers" in line or "spill" in line):
            out.append(f"{name}: {line.split('ptxas info    :')[-1].strip()}")
    return out


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call entry point ``name`` on ``device``'s current stream; raise on a
    launch error, count the launch otherwise (a captured one in the graph's
    tally)."""
    lib = library()
    with torch.cuda.device(device):
        err = getattr(lib, name)(*args, torch.cuda.current_stream(device).cuda_stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    if capturing:
        tally = getattr(_capture, "tally", None)
        if tally is not None:
            tally[name] += 1
    else:
        launches[name] += 1


def check_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous float32 CUDA tensor on one
    device (what the kernels take)."""
    check_cuda(name, torch.float32, *tensors)


def check_cuda(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous ``dtype`` CUDA tensor on
    one device."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all inputs must be on one CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"{name}: inputs must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
