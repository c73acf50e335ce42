"""frame_loop.prefetch_wait_ms_per_frame: host ms the consumer of the
prefetcher blocked on its queue (the program's ``prefetch.wait`` span,
inside ``run_chunked``'s next chunk) per frame whose result reached the
host in the traced window."""


def read(summary):
    r = (summary.get("program") or {}).get("spans", {}).get("prefetch.wait")
    if r is None or not summary["frames"]:
        return None
    return 1e3 * r["total_s"] / summary["frames"]
