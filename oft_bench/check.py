"""The comparison that decides ``correct``: sampled results of the window
against the plain reference (``oft_bench/reference/``).

Which results are compared. The window's stream of frames is cut into
segments of the mix's ``segment_frames`` (a mix that resets the pipeline
resets it at each segment's start; one that does not runs one stream, and
a segment is then only the unit the sample is drawn in). Before the window a
seeded reservoir picks ``check.segments`` segments of all those the window
starts (each as likely to be kept as any other), and in each kept segment
``check.per_segment`` frame positions drawn from the seed, its last frame among
them. The results at those positions are copied aside on the card as the
window produces them. After the window, with the program's state freed, the
reference replays the frames each kept result depends on (the three frames
up to it for a configuration without the warped-diff feedback, its segment
from the reset with it) and the two are compared.

The numbers compared, each the worst over the compared results:

- ``flow_q99_px``: the 99th percentile over the frame of |flow - reference
  flow| (Euclidean, px);
- ``flow_off_share``: the share of the frame's pixels where that exceeds
  ``OFF_PX``, which sees a fault too small for the 99th percentile (a tile,
  a border row);
- ``flow_median_px``, ``flow_max_px``: the median and the largest of it;
- ``votes_rel``: |votes - reference votes| / max(reference votes, 1);
- ``centroid_px``: the larger of |cx - reference cx| and |cy - reference cy|;
- ``detected_mismatch``: how many compared results' ``detected`` differs
  from the reference's (a count over the results, not a worst);
- ``magnitude_off_share``: the share of the frame's pixels where the
  gesture's L2-normalised magnitude differs from the reference's by more
  than ``OFF_MAGNITUDE``;
- ``magnitude_q99``: the 99th percentile of that difference;
- ``compared``: how many results were compared, held to at least its
  limit.

A configuration file's ``check.limits`` names the numbers held and each
one's limit; a run is correct when every one is within its limit. The
others are computed for the readings the limits are set from
(``oft_bench/calibrate.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from oft_bench.reference.stream import results_at

NUMBERS = ("flow_q99_px", "flow_off_share", "flow_median_px", "flow_max_px", "votes_rel",
           "centroid_px", "detected_mismatch", "magnitude_off_share", "magnitude_q99")
# numbers summed over the compared results; the others are the worst
SUMMED = ("detected_mismatch",)
# |flow - reference flow| in px above which a pixel counts as off
OFF_PX = 0.01
# |magnitude - reference magnitude| above which a pixel counts as off; the
# magnitude is scaled to an L2 norm of ``norm_alpha`` (255), some units a pixel
OFF_MAGNITUDE = 0.01


class Keeper:
    """The reservoir of segments and the results kept from them.

    ``slot(g)``, called in order for the result of each frame ``g`` of the
    window's stream (its index from the window's start), returns the slot
    that result is copied into, or None; ``put`` copies it there on the
    card. The reservoir holds ``segments`` whole segments; a segment drawn to
    replace one goes into a spare group, and the one it replaces is let go
    only when the new segment is whole, so a segment that the window's end
    cuts off is compared as far as it went, beside all of the whole ones.
    Positions are drawn from 2 on in a segment that starts with a reset
    (the pipeline's two warm-up frames give no result) and from 0 on in one
    that continues the stream."""

    def __init__(self, seed: int, segments: int, per_segment: int, segment_frames: int,
                 reset: bool,
                 hw: Sequence[int], device):
        self.rng = np.random.default_rng((int(seed) % (1 << 64), 0x0F7B))
        self.segments, self.per_segment = int(segments), int(per_segment)
        self.segment_frames, self.reset = int(segment_frames), bool(reset)
        n = (self.segments + 1) * self.per_segment
        self.planes = torch.zeros((n, 3) + tuple(hw), dtype=torch.float32, device=device)
        self.scalars = np.zeros((n, 4), np.float64)
        self.filled = np.zeros(n, bool)
        self.free = list(range(self.segments + 1))
        self.committed: List[int] = []  # whole segments held, in the order kept
        self.group: Dict[int, int] = {}  # segment -> its slot group
        self.slots: Dict[int, Dict[int, int]] = {}  # segment -> {position: slot}
        self.victim: Dict[int, Optional[int]] = {}  # pending segment -> the one it replaces
        self.current: Optional[int] = None
        self.seen = 0

    def positions(self, lo: int) -> List[int]:
        """``per_segment`` positions in [lo, segment_frames): the last and
        others drawn without repeats."""
        last = self.segment_frames - 1
        k = min(self.per_segment - 1, last - lo)
        rest = self.rng.choice(np.arange(lo, last), size=k, replace=False) if k > 0 else []
        return sorted({last, *(int(x) for x in rest)})

    def _start(self, k: int) -> None:
        self.seen += 1
        victim = None
        if len(self.committed) >= self.segments:
            draw = int(self.rng.integers(0, self.seen))
            if draw >= self.segments:
                return
            victim = self.committed[draw]
        g = self.free.pop()
        pos = self.positions(2 if self.reset or k == 0 else 0)
        self.group[k] = g
        self.slots[k] = {j: g * self.per_segment + i for i, j in enumerate(pos)}
        self.filled[g * self.per_segment : (g + 1) * self.per_segment] = False
        self.victim[k] = victim

    def _end(self, k: int) -> None:
        if k not in self.victim:
            return
        victim = self.victim.pop(k)
        if victim is None:
            self.committed.append(k)
            return
        self.committed[self.committed.index(victim)] = k
        self.free.append(self.group.pop(victim))
        del self.slots[victim]

    def slot(self, g: int) -> Optional[int]:
        k, j = divmod(int(g), self.segment_frames)
        if k != self.current:
            if self.current is not None:
                self._end(self.current)
            self.current = k
            self._start(k)
        return self.slots.get(k, {}).get(j)

    def put(self, slot: int, u, v, magnitude, scalars) -> None:
        self.planes[slot, 0].copy_(u)
        self.planes[slot, 1].copy_(v)
        self.planes[slot, 2].copy_(magnitude)
        self.scalars[slot] = scalars
        self.filled[slot] = True

    def kept(self) -> List[tuple]:
        """(segment, [(position, slot), ...]) of every kept segment with a
        result."""
        out = []
        for k, slots in sorted(self.slots.items()):
            got = [(j, s) for j, s in sorted(slots.items()) if self.filled[s]]
            if got:
                out.append((k, got))
        return out


def _q(d: torch.Tensor, q: float) -> float:
    x = d.reshape(-1).to(torch.float64)
    k = max(1, int(np.ceil(q * x.numel())))
    return float(torch.kthvalue(x.cpu(), k).values)


def _off(d: torch.Tensor) -> torch.Tensor:
    """|difference| with a non-finite one counted as infinitely far off."""
    return torch.where(torch.isfinite(d), d, torch.full_like(d, float("inf")))


def compare_one(u, v, mag, scalars, ref) -> Dict[str, float]:
    """The numbers of one result against the reference's ``(u, v, g)``;
    ``scalars`` are the program's detected, cx, cy and votes as read on the
    host."""
    ru, rv, g = ref
    d = _off(torch.hypot(u - ru, v - rv))
    dm = _off((mag - g.magnitude).abs())
    detected, cx, cy, votes = (float(x) for x in scalars)
    ref_votes = float(g.votes)
    centroid = max(abs(cx - float(g.cx)), abs(cy - float(g.cy)))
    return {
        "flow_q99_px": _q(d, 0.99),
        "flow_off_share": float((d > OFF_PX).to(torch.float64).mean()),
        "flow_median_px": _q(d, 0.5),
        "flow_max_px": float(d.max()),
        "votes_rel": abs(votes - ref_votes) / max(ref_votes, 1.0),
        "centroid_px": centroid if np.isfinite(centroid) else float("inf"),
        "detected_mismatch": float(bool(detected) != bool(g.detected)),
        "magnitude_off_share": float((dm > OFF_MAGNITUDE).to(torch.float64).mean()),
        "magnitude_q99": _q(dm, 0.99),
    }


def worst(rows: Sequence[Dict[str, float]]) -> Dict[str, float]:
    return {k: (sum(r[k] for r in rows) if k in SUMMED
                else max((r[k] for r in rows), default=float("inf"))) for k in NUMBERS}


def reference_rows(video: Dict, ring: Sequence, segment_frames: int, kept: Sequence[tuple],
                   device, precision: str = "ieee"):
    """(segment, position, reference result) of every kept result; frame
    ``g`` of the window's stream is ``ring[g % len(ring)]``."""
    n = len(ring)
    for k, got in kept:
        start = (k * segment_frames) % n
        wanted = [j for j, _ in got]
        for j, res in results_at(video, lambda i: ring[(start + i) % n], wanted, device,
                                 precision):
            yield k, j, res


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each number beside its limit; ``compared`` is held to at least its
    limit, the others to at most theirs."""
    out = {}
    for name, limit in limits.items():
        out[name] = {"value": numbers.get(name, float("inf") if name != "compared" else 0),
                     "limit": limit}
    return out


def passed(judged: Dict[str, Dict[str, float]]) -> bool:
    for name, r in judged.items():
        if name == "compared":
            if not r["value"] >= r["limit"]:
                return False
        elif not r["value"] <= r["limit"]:
            return False
    return True


def check(video: Dict, ring: Sequence, segment_frames: int, keeper: Keeper, limits: Dict,
          device, precision: str = "ieee") -> tuple:
    """(judged numbers, rows, failed count) of the kept results against
    the reference at ``precision``."""
    rows = []
    for k, j, res in reference_rows(video, ring, segment_frames, keeper.kept(), device,
                                    precision):
        s = keeper.slots[k][j]
        p = keeper.planes[s]
        rows.append(compare_one(p[0], p[1], p[2], keeper.scalars[s], res))
    numbers = worst(rows) if rows else {k: float("inf") for k in NUMBERS}
    numbers["compared"] = len(rows)
    judged = judge(numbers, limits)
    failed = sum(1 for r in rows if not passed(judge(r, {k: v for k, v in limits.items()
                                                         if k != "compared"})))
    return judged, rows, failed


def control_rows(video: Dict, ring: Sequence, segment_frames: int, kept: Sequence[tuple],
                 device, ieee: Optional[Dict] = None) -> List[Dict[str, float]]:
    """The control: the reference in TF32 put in the program's place,
    compared with the reference in float32 at the same results (``ieee``,
    {(segment, position): result}, where already worked out)."""
    if ieee is None:
        ieee = {(k, j): r for k, j, r in reference_rows(video, ring, segment_frames, kept,
                                                         device)}
    rows = []
    for k, j, r in reference_rows(video, ring, segment_frames, kept, device, "tf32"):
        ru, rv, g = r
        scalars = [float(g.detected), float(g.cx), float(g.cy), float(g.votes)]
        rows.append(compare_one(ru, rv, g.magnitude, scalars, ieee[(k, j)]))
    return rows
