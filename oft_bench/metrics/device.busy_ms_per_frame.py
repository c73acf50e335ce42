"""device.busy_ms_per_frame: ms in which the card ran some operation, the
union of the device intervals inside the traced window, per frame whose
result reached the host in it."""


def read(summary):
    if not summary["frames"]:
        return None
    return 1e3 * summary["busy_s"] / summary["frames"]
