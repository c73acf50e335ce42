"""preprocess.gemm_ms_per_frame: device ms of the cuBLAS matrix products
(the float head's banded ``ResizeBlur``, the faithful head's dense
``resize_cubic``) per frame whose result reached the host in the traced
window."""

from oft_bench import costs


def read(summary):
    s = sum(r["s"] for n, r in summary["device_ops"].items() if costs.GEMM.search(n))
    if not summary["frames"] or s <= 0:
        return None
    return 1e3 * s / summary["frames"]
