"""Reference golden-file IO (reference C13/C14; a copy of
optical_flow_tpu/utils/goldens.py, host numpy).

The reference saves flow fields as space-separated ``%lf`` rows
(`saveMat`, LKof.cpp:139-150) and regression-checks elementwise with
threshold 1e-6 (serialOrig.cpp:575-636). These helpers read/write that exact
format and locate the reference checkout (read-only) for parity tests.
``load_mat`` parses with the native host runtime's strtod loader
(``native.load_mat_native``) where the library loads, with numpy
otherwise. The checkout is found only through ``OPTICAL_FLOW_REFERENCE_DIR``
(the JAX package also looks in a fixed default directory).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np

#: Environment variable pointing at a checkout of the reference repo
#: (mileslindheimer/optical-flow) containing the golden .txt files and
#: testdata/ images.
REFERENCE_DIR_ENV = "OPTICAL_FLOW_REFERENCE_DIR"


def reference_dir() -> Optional[Path]:
    """The reference checkout named by ``OPTICAL_FLOW_REFERENCE_DIR``, or
    None when it is unset or not a directory."""
    env = os.environ.get(REFERENCE_DIR_ENV)
    p = Path(env) if env else None
    return p if p is not None and p.is_dir() else None


def load_mat(path) -> np.ndarray:
    """Load a saveMat-format text matrix (448x640 doubles for the goldens):
    the native strtod parser where the library loads (~20x ``loadtxt``),
    numpy otherwise or where the parser rejects the file's shape."""
    from optical_flow_tpu_torch.native import load_library, load_mat_native

    if load_library() is not None:
        with open(path) as f:
            cols = len(f.readline().split())
            rows = 1 + sum(1 for _ in f)
        mat = load_mat_native(path, rows, cols)
        if mat is not None:
            return mat
    return np.loadtxt(path, dtype=np.float64)


def save_mat(mat, path) -> None:
    """Write a matrix in the reference's exact saveMat format: '%lf' with a
    single space between columns and a newline per row (LKof.cpp:139-150).
    ``mat``: a host array or a tensor on any device."""
    from optical_flow_tpu_torch.utils.device import host_array

    mat = np.asarray(host_array(mat), dtype=np.float64)
    with open(path, "w") as f:
        for row in mat:
            f.write(" ".join("%f" % v for v in row))
            f.write("\n")


def load_table_pair():
    """The reference regression inputs: table1/table2 cropped to 640x448 and
    scaled to [0,1] float64 (serialOrig.cpp:538-545)."""
    ref = reference_dir()
    if ref is None:
        raise FileNotFoundError("reference checkout not found")
    from optical_flow_tpu_torch.utils.images import imread_gray

    img1 = imread_gray(ref / "testdata" / "table1.jpg")
    img2 = imread_gray(ref / "testdata" / "table2.jpg")
    img1 = img1[:448, :640].astype(np.float64) / 255.0
    img2 = img2[:448, :640].astype(np.float64) / 255.0
    return img1, img2
