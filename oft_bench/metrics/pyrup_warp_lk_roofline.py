"""pyrup_warp_lk_roofline: K3 (``warp_lk_kernel<true, ...>``, the corrected
inter-level step) against its roofline, 100 * the bound of the frames'
pyrUp+warp+LK steps (``oft_bench/costs.py``, kind "pyrup_warp_lk") / K3's
device time, over the traced window."""

from oft_bench import costs

PATTERNS = ("warp_lk_kernel<true",)


def read(summary):
    s = sum(r["s"] for n, r in summary["device_ops"].items()
            if any(p in n for p in PATTERNS))
    bound = summary["frames"] * costs.frame_bound_s(summary["video"], ("pyrup_warp_lk",))
    if s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / s
