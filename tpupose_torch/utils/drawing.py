"""Skeleton drawing (host-side, cold path).

The port's own copy of ``tpupose/utils/drawing.py``: per-part coloured
circles and rotated-ellipse limb polygons alpha-blended onto the image.
Stays on the host — drawing is presentation, not compute. Needs cv2,
imported at call time.
"""

from __future__ import annotations

import math

import numpy as np

from tpupose_torch import topology

# Draw the first 17 decode limbs (the reference skips the shoulder->ear pair).
_DRAW_LIMBS = topology.DECODE_PART_PAIRS[:17]


def draw_people(
    image: np.ndarray, people: list[dict], stick_width: int = 4, alpha: float = 0.6
) -> np.ndarray:
    """Overlay skeletons; returns a new uint8 canvas."""
    import cv2

    canvas = image.copy()
    for person in people:
        kps = person["keypoints"]
        for i, part in enumerate(topology.PARTS):
            if part in kps:
                cv2.circle(
                    canvas,
                    (int(kps[part]["x"]), int(kps[part]["y"])),
                    4,
                    topology.DRAW_COLORS[i % len(topology.DRAW_COLORS)],
                    thickness=-1,
                )
    for person in people:
        kps = person["keypoints"]
        for li, (pa, pb) in enumerate(_DRAW_LIMBS):
            na, nb = topology.PARTS[pa], topology.PARTS[pb]
            if na not in kps or nb not in kps:
                continue
            cur = canvas.copy()
            ax, ay = kps[na]["x"], kps[na]["y"]
            bx, by = kps[nb]["x"], kps[nb]["y"]
            mx, my = (ax + bx) / 2.0, (ay + by) / 2.0
            length = math.hypot(ax - bx, ay - by)
            angle = math.degrees(math.atan2(ay - by, ax - bx))
            poly = cv2.ellipse2Poly(
                (int(mx), int(my)),
                (int(length / 2), stick_width),
                int(angle),
                0,
                360,
                1,
            )
            cv2.fillConvexPoly(
                cur, poly, topology.DRAW_COLORS[li % len(topology.DRAW_COLORS)]
            )
            canvas = cv2.addWeighted(canvas, 1 - alpha * 0.4, cur, alpha * 0.4, 0)
    return canvas
