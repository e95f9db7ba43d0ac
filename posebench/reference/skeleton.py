"""COCO-18 skeleton tables of the OpenPose model (Cao et al., CVPR 2017).

A frozen copy of the tables of ``tpupose_torch/topology.py``: part names,
drawn limbs, and the decode's limb order with its PAF channels.
"""

from __future__ import annotations

PARTS = (
    "nose", "neck",
    "Rsho", "Relb", "Rwri",
    "Lsho", "Lelb", "Lwri",
    "Rhip", "Rkne", "Rank",
    "Lhip", "Lkne", "Lank",
    "Reye", "Leye", "Rear", "Lear",
)
NUM_PARTS = len(PARTS)
PART_INDEX = {name: i for i, name in enumerate(PARTS)}

# limbs as drawn by the scene renderer
LIMBS = ((1, 8), (8, 9), (9, 10), (1, 11), (11, 12), (12, 13), (1, 2), (2, 3), (3, 4),
         (2, 16), (1, 5), (5, 6), (6, 7), (5, 17), (1, 0), (0, 14), (0, 15), (14, 16),
         (15, 17))

# the decode's limb order (the reference demo's limbSeq, 0-based) and the
# PAF channels (x, y) of each limb
DECODE_PART_PAIRS = ((1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9), (9, 10),
                     (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16), (0, 15), (15, 17),
                     (2, 16), (5, 17))
DECODE_PAF_CHANNELS = ((12, 13), (20, 21), (14, 15), (16, 17), (22, 23), (24, 25), (0, 1),
                       (2, 3), (4, 5), (6, 7), (8, 9), (10, 11), (28, 29), (30, 31), (34, 35),
                       (32, 33), (36, 37), (18, 19), (26, 27))
NUM_LIMBS = len(DECODE_PART_PAIRS)
NUM_PAF_CHANNELS = 2 * NUM_LIMBS
NUM_HEAT_CHANNELS = NUM_PARTS + 1
