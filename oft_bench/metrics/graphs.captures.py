"""graphs.captures: CUDA graphs captured in the traced window (the
program's ``graph.captures`` counter over the window): 0 where every shape
was warmed in set-up."""


def read(summary):
    c = (summary.get("program") or {}).get("counters", {})
    if "graph.captures" not in c:
        return None
    return float(c["graph.captures"])
