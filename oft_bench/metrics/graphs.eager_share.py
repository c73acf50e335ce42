"""graphs.eager_share: the share of the traced window's steps that ran
eagerly and not as a graph replay, 100 * ``step.eager`` / (``step.eager`` +
``graph.replays``), the program's counters over the window (the warm-up
frames after a reset, a chunked call's first chunk)."""


def read(summary):
    c = (summary.get("program") or {}).get("counters", {})
    if "step.eager" not in c or "graph.replays" not in c:
        return None
    steps = c["step.eager"] + c["graph.replays"]
    if steps <= 0:
        return None
    return 100.0 * c["step.eager"] / steps
