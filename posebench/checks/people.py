"""People of the program against the reference's maps and people.

A random network's maps hold many near-equal peaks, and the greedy
association turns the smallest change of a map (bf16 rounding in another
order) into other people downstream. So the numbers judge each of the
program's answers by what the reference's maps say of it, as a served
token is judged by the gap to the reference's best, and compare only
counts where whole people are concerned:

  ``heat_gap``: the widest gap between a keypoint's score in the
      program's answer and the reference's averaged heat map at the same
      pixel and part (the network's last-stage heat maps, the pyramid
      average and the peak readout, read where the program put the
      keypoint: a peak that moved by a pixel on a near tie reads nearly
      nothing);
  ``paf_gap``: over every connection the program's people certainly hold,
      the widest gap by which the reference's maps miss the acceptance
      rule at the program's keypoints: ``max(0, -score)`` of the limb score
      (mean of the PAF dotted with the limb's direction at ``mid_num``
      points, plus the distance prior) and ``max(0, thre2 - v)`` of the
      point value ``v`` that must exceed ``thre2`` for ``connect_min_ratio``
      of them to (the PAF readout, pair scoring and acceptance). The
      connections held for certain are the 10 limbs of the arms and legs
      and the neck-hip limbs: a merge of two partial people over a
      shoulder-ear limb can leave a neck-shoulder or head limb's two parts
      in one person without their connection, never these;
  ``short_images``: the sampled images on which the reference finds at
      least ``short_floor`` people and the program fewer than
      ``short_share`` of them (an image's answer lost, or half a batch's:
      the numbers above read only the people the program did return);
  ``reference_people``: the reference's people, which has a floor: a
      sample in which it finds nobody could show no fault of the decode.

``count_gap`` (|people of the program - people of the reference| over the
reference's, summed over the sampled images) and ``people_mismatch``
(people on either side without a partner holding the same parts within
``match_px``) are reported beside them and not judged.
"""

from __future__ import annotations

import math

import numpy as np

from posebench.reference import skeleton

# limbs of the decode order (indices into DECODE_PART_PAIRS) whose two parts
# in one person were joined by that limb's connection: the arms' and legs'
# and the neck-hip limbs, (2, 3) .. (12, 13)
CERTAIN_LIMBS = tuple(range(2, 12))


def heat_gap(people: list[dict], heat: np.ndarray) -> float:
    """``heat``: the reference's (H, W, 19) averaged map of the image."""
    h, w = heat.shape[:2]
    gap = 0.0
    for person in people:
        for name, kp in person["keypoints"].items():
            x, y = int(round(kp["x"])), int(round(kp["y"]))
            if not (0 <= x < w and 0 <= y < h) or not math.isfinite(kp["score"]):
                return math.inf
            gap = max(gap, abs(kp["score"] - float(heat[y, x, skeleton.PART_INDEX[name]])))
    return gap


def paf_gap(people: list[dict], paf: np.ndarray, cfg: dict) -> tuple[float, int]:
    """(widest gap, connections read) of the certain connections of
    ``people`` on the reference's (H, W, 38) PAF of the image."""
    h, w = paf.shape[:2]
    m = cfg["mid_num"]
    need = int(math.floor(cfg["connect_min_ratio"] * m)) + 1     # points above thre2
    t = np.linspace(0.0, 1.0, m)
    gap, n = 0.0, 0
    for person in people:
        kps = person["keypoints"]
        for k in CERTAIN_LIMBS:
            pa, pb = skeleton.DECODE_PART_PAIRS[k]
            cx, cy = skeleton.DECODE_PAF_CHANNELS[k]
            a, b = kps.get(skeleton.PARTS[pa]), kps.get(skeleton.PARTS[pb])
            if a is None or b is None:
                continue
            vx, vy = b["x"] - a["x"], b["y"] - a["y"]
            norm = math.hypot(vx, vy)
            if norm <= 1e-8:
                return math.inf, n
            mx = np.clip(np.round(a["x"] + vx * t).astype(int), 0, w - 1)
            my = np.clip(np.round(a["y"] + vy * t).astype(int), 0, h - 1)
            mid = paf[my, mx, cx] * (vx / norm) + paf[my, mx, cy] * (vy / norm)
            score = float(mid.mean()) + min(0.5 * h / norm - 1.0, 0.0)
            v = float(np.sort(mid)[-need])
            gap = max(gap, -score, cfg["thre2"] - v)
            n += 1
    return max(gap, 0.0), n


def _distance(a: dict, b: dict) -> float:
    ka, kb = a["keypoints"], b["keypoints"]
    if set(ka) != set(kb):
        return math.inf
    return max((math.hypot(ka[n]["x"] - kb[n]["x"], ka[n]["y"] - kb[n]["y"]) for n in ka),
               default=math.inf)


def partners(got: list[dict], want: list[dict], match_px: float) -> list[tuple[int, int]]:
    """Greedy one-to-one pairs (i in got, j in want), closest first."""
    pairs = sorted((d, i, j) for i, a in enumerate(got) for j, b in enumerate(want)
                   if (d := _distance(a, b)) <= match_px)
    used_i, used_j, out = set(), set(), []
    for _, i, j in pairs:
        if i not in used_i and j not in used_j:
            used_i.add(i)
            used_j.add(j)
            out.append((i, j))
    return out


class Tally:
    """Accumulates the numbers over images. ``check``: the workload's
    ``match_px``, ``short_share`` and ``short_floor``."""

    def __init__(self, cfg: dict, check: dict):
        self.cfg = cfg
        self.check = check
        self.heat = self.paf = 0.0
        self.connections = 0
        self.got = self.want = self.unmatched = 0
        self.per_image: list[tuple[int, int]] = []      # (program's, reference's) people

    def add(self, got: list[dict], want: list[dict], heat: np.ndarray, paf: np.ndarray) -> None:
        self.heat = max(self.heat, heat_gap(got, heat))
        gap, n = paf_gap(got, paf, self.cfg)
        self.paf = max(self.paf, gap)
        self.connections += n
        self.got += len(got)
        self.want += len(want)
        self.per_image.append((len(got), len(want)))
        self.unmatched += len(got) + len(want) - 2 * len(
            partners(got, want, self.check["match_px"]))

    def numbers(self) -> dict[str, float]:
        short = sum(w >= self.check["short_floor"] and g < self.check["short_share"] * w
                    for g, w in self.per_image)
        return {"heat_gap": self.heat, "paf_gap": self.paf, "short_images": float(short),
                "count_gap": abs(self.got - self.want) / max(self.want, 1),
                "reference_people": float(self.want),
                "people_mismatch": self.unmatched / max(self.got + self.want, 1),
                "connections": float(self.connections)}
