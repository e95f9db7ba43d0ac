"""The skeletons the decode can run over, as values.

A ``Skeleton`` holds what the decode and the answers need of a model's
outputs: the part names (heat channels 0 .. parts - 1, background last),
the limbs in the order the greedy decode walks them, each with its part
pair and its PAF channel pair, the limbs that may seed a person, the
flip permutation and the draw colours.

``COCO18`` is built from ``topology.py``'s tables (the model of Cao et
al., CVPR 2017); ``BODY25`` is OpenPose's BODY_25 model (Cao et al.,
TPAMI 2019, arXiv:1812.08008): 25 parts and 26 limbs in OpenPose's pair
order, limb k owning PAF channels (2k, 2k + 1), the two shoulder-ear
limbs never seeding a person, as COCO's last two decode limbs do not.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpupose_torch import topology


@dataclasses.dataclass(frozen=True)
class Skeleton:
    name: str
    parts: tuple[str, ...]
    pairs: tuple[tuple[int, int], ...]          # per decode limb: (part a, part b)
    paf: tuple[tuple[int, int], ...]            # per decode limb: (PAF x, PAF y) channel
    seeds: frozenset[int]                       # decode limbs that may seed a person
    flip: tuple[int, ...]                       # part permutation under a horizontal flip
    colors: tuple[tuple[int, int, int], ...]

    @property
    def num_parts(self) -> int:
        return len(self.parts)

    @property
    def num_limbs(self) -> int:
        return len(self.pairs)

    @property
    def heat_channels(self) -> int:
        return self.num_parts + 1

    @property
    def paf_channels(self) -> int:
        return 2 * self.num_limbs

    @property
    def seed_mask(self) -> int:
        """Bit l set where decode limb l may seed a person."""
        return sum(1 << l for l in self.seeds)

    def limb_tables(self) -> tuple[np.ndarray, np.ndarray]:
        """(L, 2) part-pair and (L, 2) PAF-channel tables in decode order."""
        return np.asarray(self.pairs, dtype=np.int32), np.asarray(self.paf, dtype=np.int32)


COCO18 = Skeleton(
    name="coco18",
    parts=topology.PARTS,
    pairs=topology.DECODE_PART_PAIRS,
    paf=topology.DECODE_PAF_CHANNELS,
    seeds=frozenset(range(17)),
    flip=topology.FLIP_PERMUTATION,
    colors=topology.DRAW_COLORS,
)

_BODY25_PARTS = (
    "Nose", "Neck", "RShoulder", "RElbow", "RWrist", "LShoulder", "LElbow", "LWrist",
    "MidHip", "RHip", "RKnee", "RAnkle", "LHip", "LKnee", "LAnkle", "REye", "LEye", "REar",
    "LEar", "LBigToe", "LSmallToe", "LHeel", "RBigToe", "RSmallToe", "RHeel",
)
_BODY25_PAIRS = (
    (1, 8), (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (8, 9), (9, 10), (10, 11),
    (8, 12), (12, 13), (13, 14), (1, 0), (0, 15), (15, 17), (0, 16), (16, 18), (2, 17),
    (5, 18), (14, 19), (19, 20), (14, 21), (11, 22), (22, 23), (11, 24),
)
_BODY25_SIDES = (("RShoulder", "LShoulder"), ("RElbow", "LElbow"), ("RWrist", "LWrist"),
                 ("RHip", "LHip"), ("RKnee", "LKnee"), ("RAnkle", "LAnkle"), ("REye", "LEye"),
                 ("REar", "LEar"), ("RBigToe", "LBigToe"), ("RSmallToe", "LSmallToe"),
                 ("RHeel", "LHeel"))


def _flip(parts: tuple[str, ...], sides) -> tuple[int, ...]:
    index = {name: i for i, name in enumerate(parts)}
    swap = {}
    for r, l in sides:
        swap[index[r]], swap[index[l]] = index[l], index[r]
    return tuple(swap.get(i, i) for i in range(len(parts)))


BODY25 = Skeleton(
    name="body25",
    parts=_BODY25_PARTS,
    pairs=_BODY25_PAIRS,
    paf=tuple((2 * k, 2 * k + 1) for k in range(len(_BODY25_PAIRS))),
    seeds=frozenset(range(len(_BODY25_PAIRS))) - {18, 19},
    flip=_flip(_BODY25_PARTS, _BODY25_SIDES),
    # OpenPose's POSE_BODY_25_COLORS_RENDER, one a part
    colors=((255, 0, 85), (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0),
            (170, 255, 0), (85, 255, 0), (0, 255, 0), (255, 0, 0), (0, 255, 85),
            (0, 255, 170), (0, 255, 255), (0, 170, 255), (0, 85, 255), (0, 0, 255),
            (255, 0, 170), (170, 0, 255), (255, 0, 255), (85, 0, 255), (0, 0, 255),
            (0, 0, 255), (0, 0, 255), (0, 255, 255), (0, 255, 255), (0, 255, 255)),
)

SKELETONS = {s.name: s for s in (COCO18, BODY25)}
