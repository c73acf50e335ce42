"""stage.pyramid_ms_per_frame: device ms of the pipeline's ``stage.pyramid``
(the diff pyramid (K2), pyramid reuse only) per frame its readings cover: CUDA timing events around the
stage on the step's stream, captured into each graph, read over the traced
window (the program's ``stage_totals``)."""


def read(summary):
    r = (summary.get("program") or {}).get("stages", {}).get("stage.pyramid")
    if r is None or not r["frames"]:
        return None
    return r["ms"] / r["frames"]
