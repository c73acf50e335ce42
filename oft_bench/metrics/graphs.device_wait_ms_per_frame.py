"""graphs.device_wait_ms_per_frame: ms in which the card ran nothing while
the innermost program span open on the window's thread was a ``graph.*``
one (the replay's copies, its launch, the clone of its result) per frame
whose result reached the host in the traced window."""


def read(summary):
    p = summary.get("program")
    if not p or not p["spans"] or not summary["device_events"] or not summary["frames"]:
        return None
    s = sum(g for n, g in p["idle"].items() if n.startswith("graph."))
    return 1e3 * s / summary["frames"]
