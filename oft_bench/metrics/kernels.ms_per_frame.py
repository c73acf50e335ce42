"""kernels.ms_per_frame: device ms of the port's hand-written kernels
(``kernels/csrc``: K1 ``lk_strip_kernel``, K2 ``pyrdown_kernel``, K3/K4
``warp_lk_kernel``, S1 ``pyrup_strip_kernel``, P1 ``tile_copy``) per frame
whose result reached the host in the traced window; the names are
``oft_bench/costs.py``'s ``PORT_KERNELS``."""

from oft_bench import costs


def read(summary):
    s = sum(r["s"] for n, r in summary["device_ops"].items() if costs.is_port_kernel(n))
    if not summary["frames"] or s <= 0:
        return None
    return 1e3 * s / summary["frames"]
