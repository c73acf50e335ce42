"""frame_loop.read_ms_per_frame: host ms reading a result's gesture
scalars to the host (the benchmark's ``read`` span: the stack, the
device-to-host copy and the wait for the frame's device work) per frame
whose result reached the host in the traced window."""


def read(summary):
    s = summary["host_spans"].get("read", 0.0)
    if not summary["frames"] or s <= 0:
        return None
    return 1e3 * s / summary["frames"]
