"""upload.h2d_ms_per_frame: device ms of host-to-device copies (the
frames' pinned uploads by ``push`` and the prefetcher) per frame whose
result reached the host in the traced window."""


def read(summary):
    s = sum(r["s"] for n, r in summary["device_ops"].items() if n.startswith("Memcpy HtoD"))
    if not summary["frames"] or s <= 0:
        return None
    return 1e3 * s / summary["frames"]
