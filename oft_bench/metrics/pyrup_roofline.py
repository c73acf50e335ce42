"""pyrup_roofline: S1 (``pyrup_strip_kernel``, pyrUp of (u, v) between
reference-mode levels) against its roofline, 100 * the bound of the frames'
upsamples (``oft_bench/costs.py``, kind "pyrup") / S1's device time, over
the traced window."""

from oft_bench import costs

PATTERNS = ("pyrup_strip_kernel",)


def read(summary):
    s = sum(r["s"] for n, r in summary["device_ops"].items()
            if any(p in n for p in PATTERNS))
    bound = summary["frames"] * costs.frame_bound_s(summary["video"], ("pyrup",))
    if s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / s
