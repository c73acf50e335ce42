"""upload.pin_ms_per_frame: host ms copying frames into pinned memory (the
self time of the program's ``upload.pin`` spans on every thread:
``pinned_copy`` in ``push``, the prefetch worker's chunk stacking) per frame
whose result reached the host in the traced window."""


def read(summary):
    r = (summary.get("program") or {}).get("spans", {}).get("upload.pin")
    if r is None or not summary["frames"]:
        return None
    return 1e3 * r["self_s"] / summary["frames"]
