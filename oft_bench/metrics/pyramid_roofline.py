"""pyramid_roofline: K2 (``pyrdown_kernel``, one ``oft_pyramid`` call a
frame) against its roofline, 100 * the bound of the frames' diff pyramids
(``oft_bench/costs.py``, kind "pyramid": the input read once, each level
written once) / K2's device time, over the traced window."""

from oft_bench import costs

PATTERNS = ("pyrdown_kernel",)


def read(summary):
    s = sum(r["s"] for n, r in summary["device_ops"].items()
            if any(p in n for p in PATTERNS))
    bound = summary["frames"] * costs.frame_bound_s(summary["video"], ("pyramid",))
    if s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / s
