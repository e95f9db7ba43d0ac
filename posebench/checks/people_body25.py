"""People of the BODY_25 program against the reference's maps and people.

The numbers of ``checks/people.py`` (``heat_gap``, ``paf_gap``,
``short_images``, ``reference_people``, ``connections``, and beside them
``count_gap`` and ``people_mismatch``), over BODY_25's 25 parts and 26
limbs (``reference/body25.py``), judged the same way and for the same
reason: a random network's maps hold many near ties, so each answer is
judged by what the reference's maps say of it.

``paf_gap`` reads the connections the program's people certainly hold:
those of the 11 limbs whose two parts, where one person holds both, were
joined by that limb's own connection. They are Neck-MidHip (decode limb
0), the arms (3-6) and the legs (7-12). The argument, from the demo's
assembly (a connection extends the one row it matches with its B part,
merges the two rows it matches if they are disjoint, else extends the
older; a merge keeps every part where it was):

  * a part's slot of a row is written only by a connection of a limb
    whose B part it is, by a seed (both parts of a seeding connection),
    or by a merge of two disjoint rows (no slot is overwritten);
  * each of these limbs' B parts (MidHip, RElbow, RWrist, LElbow, LWrist,
    RHip, RKnee, RAnkle, LHip, LKnee, LAnkle) is the B part of that limb
    alone and first appears at it; a peak is used once a limb, so while
    the limb is walked no other row holds its B peak: its connection
    finds at most the row of its A peak, and extends it or seeds a row,
    both with the connection between the two;
  * a row that holds the B part without its A part (a seed of a later
    limb) never meets a row of that A part again: no later limb joins an
    arm's or a leg's parts to anything but the next part down the same
    arm or leg or a foot, whose parts first appear at their own limbs;
    and the A parts (Neck, the shoulders, the elbows, MidHip, the hips,
    the knees) are never written again after their limb: Neck is no limb's
    B part, the others are the B part of an earlier limb only.

The neck-shoulder limbs are not certain: a merge over a shoulder-ear limb
(18, 19, the last but the feet) can join a row holding a Neck to a row
holding a shoulder without their connection. The head limbs are not
either (a merge over those limbs can bring an eye and an ear of two
sources together); the feet are left out with them, as COCO-18 has none.
"""

from __future__ import annotations

import math

import numpy as np

from posebench.checks import people
from posebench.reference import body25

CERTAIN_LIMBS = (0, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12)


def heat_gap(found: list[dict], heat: np.ndarray) -> float:
    """``heat``: the reference's (H, W, 26) averaged map of the image."""
    h, w = heat.shape[:2]
    gap = 0.0
    for person in found:
        for name, kp in person["keypoints"].items():
            x, y = int(round(kp["x"])), int(round(kp["y"]))
            if not (0 <= x < w and 0 <= y < h) or not math.isfinite(kp["score"]):
                return math.inf
            gap = max(gap, abs(kp["score"] - float(heat[y, x, body25.PART_INDEX[name]])))
    return gap


def paf_gap(found: list[dict], paf: np.ndarray, cfg: dict) -> tuple[float, int]:
    """(widest gap, connections read) of the certain connections of
    ``found`` on the reference's (H, W, 52) PAF of the image."""
    h, w = paf.shape[:2]
    m = cfg["mid_num"]
    need = int(math.floor(cfg["connect_min_ratio"] * m)) + 1     # points above thre2
    t = np.linspace(0.0, 1.0, m)
    gap, n = 0.0, 0
    for person in found:
        kps = person["keypoints"]
        for k in CERTAIN_LIMBS:
            pa, pb = body25.PAIRS[k]
            cx, cy = body25.PAF[k]
            a, b = kps.get(body25.PARTS[pa]), kps.get(body25.PARTS[pb])
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


class Tally(people.Tally):
    """``checks.people.Tally`` over BODY_25's tables."""

    def add(self, got: list[dict], want: list[dict], heat: np.ndarray, paf: np.ndarray) -> None:
        self.heat = max(self.heat, heat_gap(got, heat))
        gap, n = paf_gap(got, paf, self.cfg)
        self.paf = max(self.paf, gap)
        self.connections += n
        self.got += len(got)
        self.want += len(want)
        self.per_image.append((len(got), len(want)))
        self.unmatched += len(got) + len(want) - 2 * len(
            people.partners(got, want, self.check["match_px"]))
