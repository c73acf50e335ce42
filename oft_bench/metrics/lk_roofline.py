"""lk_roofline: K1 (``lk_strip_kernel``) against its roofline, 100 * the
bound of the frames' dense LK solves (``oft_bench/costs.py``, kind "lk") /
K1's device time, over the traced window."""

from oft_bench import costs

PATTERNS = ("lk_strip_kernel",)


def read(summary):
    s = sum(r["s"] for n, r in summary["device_ops"].items()
            if any(p in n for p in PATTERNS))
    bound = summary["frames"] * costs.frame_bound_s(summary["video"], ("lk",))
    if s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / s
