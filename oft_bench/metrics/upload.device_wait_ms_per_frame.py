"""upload.device_wait_ms_per_frame: ms in which the card ran nothing while
the innermost program span open on the window's thread was an ``upload.*``
one (the frame's pinned copy, its staging) per frame whose result reached
the host in the traced window. 0 where the thread that drives the window
runs no upload (the prefetch worker's are on its own thread)."""


def read(summary):
    p = summary.get("program")
    if not p or not p["spans"] or not summary["device_events"] or not summary["frames"]:
        return None
    s = sum(g for n, g in p["idle"].items() if n.startswith("upload."))
    return 1e3 * s / summary["frames"]
