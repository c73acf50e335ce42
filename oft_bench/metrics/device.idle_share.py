"""device.idle_share: the share of the traced window in which no operation
ran on the card, 100 * (1 - busy / window), busy being the union of the
device intervals inside the window (``oft_bench/trace.py``)."""


def read(summary):
    if summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
