"""kernels.launches_per_frame: launches of the port's kernels in the traced
window (``kernels/_lib.launches`` over the window, a graph's counted once
per replay) per frame whose result reached the host in it."""


def read(summary):
    c = (summary.get("program") or {}).get("counters", {})
    n = sum(v for k, v in c.items() if k.startswith("launches."))
    if not summary["frames"] or not any(k.startswith("launches.") for k in c):
        return None
    return n / summary["frames"]
