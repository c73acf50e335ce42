"""Sliding-window bundle adjustment with track retirement (port of
optical_flow_tpu/slam/window.py).

Full-batch BA re-optimizes every camera and point forever; a real-time
mapper solves a SLIDING WINDOW instead:

  - only the last ``window`` keyframe poses are free; older poses are frozen
    (they still constrain the solve through their observations of active
    points, passed to ``bundle_adjust`` as ``fixed_cams``);
  - points with no observation inside the window are RETIRED: frozen at
    their current estimate and dropped from the live problem, so the solved
    problem is O(window), not O(trajectory).

The bookkeeping is host-side numpy, as in the JAX package; the solve is
``bundle_adjust`` on the instance's device (the card unless ``device``
names another; without a card the constructor raises). Every axis of the
solved problem is padded to a power of two, as JAX pads it for its compiled
programs: the padding (zero-weight observations, observation-less points,
fixed cameras) changes nothing in the solution.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from optical_flow_tpu_torch.slam.ba import BAProblem, bundle_adjust, reprojection_rmse
from optical_flow_tpu_torch.utils.device import canonical_device


def _bucket(n: int) -> int:
    """Smallest power of two >= n."""
    b = 1
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class WindowedBA:
    """Incremental mapper: add_keyframe() then optimize().

    Coordinates follow slam/ba.py: poses are (6,) axis-angle + translation
    world->camera, observations are pixel coordinates under ``focal``.
    """

    window: int = 5
    focal: float = 1.0
    ba_iters: int = 4
    lam: float = 1e-4
    dtype: type = np.float64
    device: Any = "cuda"

    def __post_init__(self):
        self.device = canonical_device(self.device)
        self.poses: List[np.ndarray] = []  # every keyframe pose, grows
        self.points: Dict[int, np.ndarray] = {}  # live points
        self.retired: Dict[int, np.ndarray] = {}  # frozen points
        # live observations: per point id, list of (cam_index, uv, baseline)
        self._tracks: Dict[int, List[Tuple[int, np.ndarray, float]]] = {}
        self._last_seen: Dict[int, int] = {}

    # ------------------------------------------------------------ building

    def add_keyframe(
        self,
        pose_init,
        observations: Sequence[Tuple],
        new_points: Optional[Dict[int, Sequence[float]]] = None,
    ) -> int:
        """Append a keyframe.

        pose_init: (6,) initial pose guess.
        observations: [(point_id, (u, v)), ...] for this keyframe; an entry
        may carry a third element, a rectified-rig eye offset
        (``BAProblem.baseline``): (point_id, (u, v), baseline).
        new_points: {point_id: (x, y, z)} initial positions for ids not seen
        before (must cover any observation of an unknown id).
        Returns the keyframe index.
        """
        k = len(self.poses)
        self.poses.append(np.asarray(pose_init, self.dtype).copy())
        if new_points:
            for pid, X in new_points.items():
                if pid in self.retired:
                    raise ValueError(f"point {pid} was retired; ids are single-use")
                self.points[pid] = np.asarray(X, self.dtype).copy()
                self._tracks.setdefault(pid, [])
                # registration counts for retirement even if no observation
                # ever arrives: an observation-less point ages out too
                self._last_seen.setdefault(pid, k)
        for entry in observations:
            pid, uv = entry[0], entry[1]
            b = float(entry[2]) if len(entry) > 2 else 0.0
            if pid in self.retired:
                continue  # stale track: the map already froze this point
            if pid not in self.points:
                raise ValueError(f"observation of unknown point {pid}")
            self._tracks[pid].append((k, np.asarray(uv, self.dtype), b))
            self._last_seen[pid] = k
        self._retire(k)
        return k

    def add_observation(self, pid: int, cam_index: int, uv, baseline: float = 0.0) -> None:
        """Attach an observation of live point ``pid`` from an EARLIER
        keyframe (e.g. the anchor view a track was triangulated against).
        Does not refresh the retirement clock."""
        if pid in self.retired:
            return
        if pid not in self.points:
            raise ValueError(f"observation of unknown point {pid}")
        self._tracks[pid].append((int(cam_index), np.asarray(uv, self.dtype), float(baseline)))

    def _retire(self, newest: int) -> None:
        """Freeze points whose tracks ended before the active window."""
        horizon = newest - self.window + 1
        for pid in [p for p, last in self._last_seen.items() if last < horizon]:
            self.retired[pid] = self.points.pop(pid)
            del self._tracks[pid]
            del self._last_seen[pid]

    # ---------------------------------------------------------- optimizing

    def _gather_problem(self):
        """Compact the live window into a BAProblem on the instance's device
        (+ index maps); None when no live point has an observation."""
        newest = len(self.poses) - 1
        horizon = max(newest - self.window + 1, 0)
        # only points with at least one observation enter the solve
        pids = sorted(p for p in self.points if self._tracks[p])
        if not pids:
            return None
        cam_set = sorted({t[0] for pid in pids for t in self._tracks[pid]})
        cam_map = {c: i for i, c in enumerate(cam_set)}
        pt_map = {p: i for i, p in enumerate(pids)}
        cam_idx, pt_idx, uvs, blines = [], [], [], []
        for pid in pids:
            for k, uv, b in self._tracks[pid]:
                cam_idx.append(cam_map[k])
                pt_idx.append(pt_map[pid])
                uvs.append(uv)
                blines.append(b)
        # out-of-window cameras take part (their observations anchor the
        # points) but stay fixed; index 0, bundle_adjust's gauge anchor, is
        # the oldest camera in cam_set: frozen history or the window's anchor
        fixed = np.array([c < horizon for c in cam_set])

        # Pad every axis to a power of two: padded observations carry weight
        # 0, padded points have no observations, padded cameras are fixed.
        C, P, M = len(cam_set), len(pids), len(cam_idx)
        C_b, P_b, M_b = _bucket(C), _bucket(P), _bucket(M)
        cams_arr = np.zeros((C_b, 6), self.dtype)
        cams_arr[:C] = np.stack([self.poses[c] for c in cam_set])
        pts_arr = np.zeros((P_b, 3), self.dtype)
        pts_arr[:P] = np.stack([self.points[p] for p in pids])
        pts_arr[P:, 2] = 1.0  # keep padded points off the z=0 singularity
        ci = np.zeros(M_b, np.int32)
        ci[:M] = cam_idx
        pi = np.zeros(M_b, np.int32)
        pi[:M] = pt_idx
        uv_arr = np.zeros((M_b, 2), self.dtype)
        uv_arr[:M] = np.stack(uvs)
        w = np.zeros(M_b, self.dtype)
        w[:M] = 1.0
        b_arr = np.zeros(M_b, self.dtype)
        b_arr[:M] = blines
        fixed_b = np.ones(C_b, bool)
        fixed_b[:C] = fixed

        def t(x):
            return torch.from_numpy(x).to(self.device)

        prob = BAProblem(t(cams_arr), t(pts_arr), t(ci), t(pi), t(uv_arr), self.focal, t(w),
                         t(b_arr))
        return prob, cam_set, pids, t(fixed_b)

    def optimize(self) -> Optional[float]:
        """One windowed BA solve; writes the results back. Returns the final
        reprojection RMSE over the live window (None if nothing to solve)."""
        gathered = self._gather_problem()
        if gathered is None:
            return None
        prob, cam_set, pids, fixed = gathered
        refined, _ = bundle_adjust(prob, iters=self.ba_iters, lam=self.lam, fixed_cams=fixed)
        cams = refined.cams.cpu().numpy()
        pts = refined.points.cpu().numpy()
        fixed_np = fixed.cpu().numpy()
        # index 0 is bundle_adjust's gauge anchor and never moves; fixed
        # (out-of-window / padded) cameras don't either
        for i, c in enumerate(cam_set):
            if not fixed_np[i] and i != 0:
                self.poses[c] = cams[i]
        for i, pid in enumerate(pids):
            self.points[pid] = pts[i]
        return float(reprojection_rmse(refined))

    # ------------------------------------------------------------- queries

    def all_points(self) -> Dict[int, np.ndarray]:
        out = dict(self.retired)
        out.update(self.points)
        return out

    @property
    def live_observation_count(self) -> int:
        return sum(len(t) for t in self._tracks.values())
