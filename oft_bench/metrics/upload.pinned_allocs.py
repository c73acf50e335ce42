"""upload.pinned_allocs: blocks by which the caching host allocator's
pinned pool grew in the traced window (``torch.cuda.host_memory_stats()``'s
``num_host_alloc``, read at the window's ends); 0 once the pool holds what
the steady loop reuses."""


def read(summary):
    c = (summary.get("program") or {}).get("counters", {})
    if "host_memory.num_host_alloc" not in c:
        return None
    return float(c["host_memory.num_host_alloc"])
