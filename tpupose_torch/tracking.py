"""Cross-frame person tracking for the video path.

The reference's ``demo_camera.py`` decodes every frame independently —
person N in one frame has no relation to person N in the next, so any
downstream consumer (action recognition, analytics, overlays) has to
re-identify people itself. ``PoseTracker`` assigns stable integer track
ids by greedy nearest-neighbour matching on normalised keypoint
distance, entirely host-side on the compact people tables the decoder
returns — the device path is untouched.

Matching cost between a detection and a track is the mean L2 distance
over their shared keypoint names, normalised by the track's bbox
diagonal (scale-invariant: a far-away person may move few pixels, a
close one many). Greedy lowest-cost-first assignment below
``max_cost``; unmatched detections open new tracks; tracks unseen for
``max_missed`` consecutive frames are retired. Optional exponential
smoothing steadies the overlay without adding latency.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any


@dataclasses.dataclass
class _Track:
    tid: int
    keypoints: dict[str, dict[str, float]]
    missed: int = 0


def _diag(kps: dict[str, dict[str, float]], floor: float) -> float:
    xs = [v["x"] for v in kps.values()]
    ys = [v["y"] for v in kps.values()]
    if not xs:
        return floor
    d = math.hypot(max(xs) - min(xs), max(ys) - min(ys))
    # floor: a sparse track (one visible keypoint -> zero extent)
    # under-represents body scale; without it the cost degenerates to
    # raw pixels and any motion at all exceeds max_cost (id churn)
    return max(d, floor)


def _cost(track: _Track, person: dict, min_diag: float) -> float | None:
    """Mean shared-keypoint L2 / track bbox diagonal; None if disjoint."""
    shared = set(track.keypoints) & set(person["keypoints"])
    if not shared:
        return None
    d = 0.0
    for name in shared:
        a = track.keypoints[name]
        b = person["keypoints"][name]
        d += math.hypot(a["x"] - b["x"], a["y"] - b["y"])
    return d / len(shared) / _diag(track.keypoints, min_diag)


class PoseTracker:
    """Stateful frame-to-frame id assignment over decoder output.

    ``update(people)`` returns the same people dicts (copies) with a
    ``track_id`` field added; ids are stable while a person stays
    matchable and are never reused after retirement.
    """

    def __init__(self, max_cost: float = 0.5, max_missed: int = 10,
                 smoothing: float = 0.0, min_diag: float = 32.0):
        if not 0.0 <= smoothing < 1.0:
            raise ValueError("smoothing must be in [0, 1)")
        self.max_cost = max_cost
        self.max_missed = max_missed
        self.smoothing = smoothing
        # matching radius floor for sparse tracks: a track whose visible
        # keypoints span less than min_diag px still matches motion up
        # to max_cost * min_diag px per frame
        self.min_diag = min_diag
        self._tracks: list[_Track] = []
        self._next_id = 0

    def update(self, people: list[dict]) -> list[dict]:
        # all candidate (cost, track index, person index) pairs
        cands = []
        for ti, tr in enumerate(self._tracks):
            for pi, p in enumerate(people):
                c = _cost(tr, p, self.min_diag)
                if c is not None and c <= self.max_cost:
                    cands.append((c, ti, pi))
        cands.sort(key=lambda t: t[0])
        taken_t: set[int] = set()
        taken_p: set[int] = set()
        assign: dict[int, int] = {}      # person idx -> track idx
        for c, ti, pi in cands:
            if ti in taken_t or pi in taken_p:
                continue
            taken_t.add(ti)
            taken_p.add(pi)
            assign[pi] = ti

        out: list[dict] = []
        for pi, p in enumerate(people):
            if pi in assign:
                tr = self._tracks[assign[pi]]
                tr.missed = 0
                kps = self._smooth(tr.keypoints, p["keypoints"])
                tr.keypoints = kps
            else:
                tr = _Track(self._next_id, dict(p["keypoints"]))
                self._next_id += 1
                self._tracks.append(tr)
                kps = tr.keypoints
            out.append({**p, "keypoints": kps, "track_id": tr.tid})

        live = {q["track_id"] for q in out}
        survivors = []
        for tr in self._tracks:
            if tr.tid in live:
                survivors.append(tr)
            else:
                tr.missed += 1
                if tr.missed <= self.max_missed:
                    survivors.append(tr)
        self._tracks = survivors
        return out

    def _smooth(
        self,
        prev: dict[str, dict[str, float]],
        cur: dict[str, dict[str, float]],
    ) -> dict[str, dict[str, float]]:
        if self.smoothing <= 0.0:
            return dict(cur)
        a = self.smoothing
        out = {}
        for name, kp in cur.items():
            if name in prev:
                pk = prev[name]
                out[name] = {
                    **kp,
                    "x": a * pk["x"] + (1 - a) * kp["x"],
                    "y": a * pk["y"] + (1 - a) * kp["y"],
                }
            else:
                out[name] = kp
        return out
