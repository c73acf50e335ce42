"""eager.ms_per_frame: device ms of the kernels that are neither the port's
hand-written ones, nor matrix products, nor copies or sets: PyTorch's own
elementwise, reduction, gather and indexing kernels (``diff_features``, the
faithful head's blur and gray, the gesture, the 'gather' warp, the state
and result copies that run as kernels), per frame whose result reached the
host in the traced window."""

from oft_bench import costs


def _eager(name):
    return not (costs.is_port_kernel(name) or costs.GEMM.search(name)
                or name.startswith("Memcpy") or name.startswith("Memset"))


def read(summary):
    s = sum(r["s"] for n, r in summary["device_ops"].items() if _eager(n))
    if not summary["frames"] or s <= 0:
        return None
    return 1e3 * s / summary["frames"]
