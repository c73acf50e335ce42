"""frame_loop.push_ms_per_frame: host ms inside ``VideoPipeline.push`` (the
benchmark's ``push`` span) per frame whose result reached the host in the
traced window: the enqueue of a frame's work, the pinned copy, the graph
replay; not the wait for the result."""


def read(summary):
    s = summary["host_spans"].get("push", 0.0)
    if not summary["frames"] or s <= 0:
        return None
    return 1e3 * s / summary["frames"]
