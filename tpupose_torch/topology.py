"""Skeleton topology for the COCO-18 OpenPose/CPM model.

The port's own copy of the reference's ``tpupose/topology.py`` (the port
imports nothing of that package; ``tests/test_torch_imports.py`` holds the
two equal table for table). The single source of truth, inside the port,
for part names, limb connectivity and channel layout.

Channel layout (network outputs, NHWC):
  * branch L1 — part-affinity fields: 38 channels = 19 limbs x (x, y).
    PAF channels (2k, 2k+1) belong to ``LIMBS[k]``.
  * branch L2 — heatmaps: 19 channels = 18 parts + 1 background.
"""

from __future__ import annotations

import numpy as np

# --- Parts -----------------------------------------------------------------

PARTS: tuple[str, ...] = (
    "nose", "neck",
    "Rsho", "Relb", "Rwri",
    "Lsho", "Lelb", "Lwri",
    "Rhip", "Rkne", "Rank",
    "Lhip", "Lkne", "Lank",
    "Reye", "Leye", "Rear", "Lear",
)
NUM_PARTS: int = len(PARTS)                      # 18
NUM_HEAT_CHANNELS: int = NUM_PARTS + 1           # 19 (+ background)
BACKGROUND_CHANNEL: int = NUM_PARTS              # index 18

PART_INDEX: dict[str, int] = {name: i for i, name in enumerate(PARTS)}

# Left/right pairs, used for label swapping under horizontal flip.
LEFT_PARTS: tuple[int, ...] = tuple(
    PART_INDEX[p] for p in ("Lsho", "Lelb", "Lwri", "Lhip", "Lkne", "Lank", "Leye", "Lear")
)
RIGHT_PARTS: tuple[int, ...] = tuple(
    PART_INDEX[p] for p in ("Rsho", "Relb", "Rwri", "Rhip", "Rkne", "Rank", "Reye", "Rear")
)

# Permutation applied to the part axis when an image is h-flipped.
FLIP_PERMUTATION: tuple[int, ...] = tuple(
    (
        RIGHT_PARTS[LEFT_PARTS.index(i)]
        if i in LEFT_PARTS
        else LEFT_PARTS[RIGHT_PARTS.index(i)] if i in RIGHT_PARTS else i
    )
    for i in range(NUM_PARTS)
)

# --- Limbs (PAF channel order) ----------------------------------------------
# Limb k owns PAF channels (2k, 2k+1). This ordering matches the reference's
# RmpeGlobalConfig.limb_from/limb_to so GT rasterisation and decode agree.

_LIMB_FROM = ("neck", "Rhip", "Rkne", "neck", "Lhip", "Lkne", "neck",
              "Rsho", "Relb", "Rsho", "neck", "Lsho", "Lelb", "Lsho",
              "neck", "nose", "nose", "Reye", "Leye")
_LIMB_TO = ("Rhip", "Rkne", "Rank", "Lhip", "Lkne", "Lank", "Rsho",
            "Relb", "Rwri", "Rear", "Lsho", "Lelb", "Lwri", "Lear",
            "nose", "Reye", "Leye", "Rear", "Lear")

LIMBS: tuple[tuple[int, int], ...] = tuple(
    (PART_INDEX[a], PART_INDEX[b]) for a, b in zip(_LIMB_FROM, _LIMB_TO)
)
NUM_LIMBS: int = len(LIMBS)                      # 19
NUM_PAF_CHANNELS: int = 2 * NUM_LIMBS            # 38
NUM_GT_CHANNELS: int = NUM_PAF_CHANNELS + NUM_HEAT_CHANNELS  # 57

# --- Decode order -----------------------------------------------------------
# The reference's demo decode iterates limbs in its ``limbSeq`` order, which
# differs from the PAF channel order above. Greedy skeleton assembly is order
# sensitive, so we keep the same iteration order for output parity.
# Expressed here as (part_a, part_b) pairs; the limb/channel indices are
# derived, and tests pin them against the literal upstream mapIdx table.

_DECODE_PAIRS = (
    ("neck", "Rsho"), ("neck", "Lsho"),
    ("Rsho", "Relb"), ("Relb", "Rwri"),
    ("Lsho", "Lelb"), ("Lelb", "Lwri"),
    ("neck", "Rhip"), ("Rhip", "Rkne"), ("Rkne", "Rank"),
    ("neck", "Lhip"), ("Lhip", "Lkne"), ("Lkne", "Lank"),
    ("neck", "nose"),
    ("nose", "Reye"), ("Reye", "Rear"),
    ("nose", "Leye"), ("Leye", "Lear"),
    ("Rsho", "Rear"), ("Lsho", "Lear"),
)

_LIMB_OF_PAIR = {pair: k for k, pair in enumerate(LIMBS)}

DECODE_LIMB_ORDER: tuple[int, ...] = tuple(
    _LIMB_OF_PAIR[(PART_INDEX[a], PART_INDEX[b])] for a, b in _DECODE_PAIRS
)

# (part_a, part_b) per decode step, as indices.
DECODE_PART_PAIRS: tuple[tuple[int, int], ...] = tuple(LIMBS[k] for k in DECODE_LIMB_ORDER)
# (paf_x_channel, paf_y_channel) per decode step.
DECODE_PAF_CHANNELS: tuple[tuple[int, int], ...] = tuple(
    (2 * k, 2 * k + 1) for k in DECODE_LIMB_ORDER
)


def decode_limb_tables() -> tuple[np.ndarray, np.ndarray]:
    """(19, 2) part-pair and (19, 2) PAF-channel tables in decode order."""
    return (
        np.asarray(DECODE_PART_PAIRS, dtype=np.int32),
        np.asarray(DECODE_PAF_CHANNELS, dtype=np.int32),
    )


# Drawing palette: one colour per part, matching the reference's util.py hues.
DRAW_COLORS: tuple[tuple[int, int, int], ...] = (
    (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0), (170, 255, 0),
    (85, 255, 0), (0, 255, 0), (0, 255, 85), (0, 255, 170), (0, 255, 255),
    (0, 170, 255), (0, 85, 255), (0, 0, 255), (85, 0, 255), (170, 0, 255),
    (255, 0, 255), (255, 0, 170), (255, 0, 85), (255, 85, 85),
)
