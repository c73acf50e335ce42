"""kernels_roofline: the port's kernels together against their roofline,
100 * (the bound of the kernel work of the frames whose results reached the
host in the traced window) / (device time of the port's kernels in it).

The work is what the frame's functions need at the cell's shapes
(``oft_bench/costs.py``: the pyramid, LK at each level, the fused steps,
S1), against the H100's published peaks; the kernels' own re-reads are not
counted. Work of frames that gave no result (the two warm-up frames after a
reset) is not counted either, so the share errs low."""

from oft_bench import costs


def read(summary):
    s = sum(r["s"] for n, r in summary["device_ops"].items() if costs.is_port_kernel(n))
    bound = summary["frames"] * costs.frame_bound_s(summary["video"])
    if s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / s
