"""frame_loop.next_chunk_ms_per_frame: host ms inside ``run_chunked``'s
next chunk (the benchmark's ``next_chunk`` span: waiting for the
prefetcher's chunk, the chunk step's enqueue or graph replay) per frame
whose result reached the host in the traced window."""


def read(summary):
    s = summary["host_spans"].get("next_chunk", 0.0)
    if not summary["frames"] or s <= 0:
        return None
    return 1e3 * s / summary["frames"]
