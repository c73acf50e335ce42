"""graphs.d2d_ms_per_frame: device ms of device-to-device copies (the
graph replay's state copied into its buffers and results cloned out, and
the input landed in its buffer) per frame whose result reached the host in
the traced window."""


def read(summary):
    s = sum(r["s"] for n, r in summary["device_ops"].items() if n.startswith("Memcpy DtoD"))
    if not summary["frames"] or s <= 0:
        return None
    return 1e3 * s / summary["frames"]
