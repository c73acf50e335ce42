"""graphs.replay_ms_per_frame: host ms inside ``StepGraph.replay`` (the
program's ``graph.replay`` span: the input and any foreign state copied in,
``graph.replay()``, the result cloned out) per frame whose result reached
the host in the traced window."""


def read(summary):
    r = (summary.get("program") or {}).get("spans", {}).get("graph.replay")
    if r is None or not summary["frames"]:
        return None
    return 1e3 * r["total_s"] / summary["frames"]
