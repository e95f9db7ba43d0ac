"""Synthetic inputs for checking the port where no weights or data exist.

``planted_scene`` builds per-scale low-res heat/PAF maps of a known
two-person scene from the numpy ground-truth rasteriser
(``tpupose.reference_impl.gt_np``), resized with the port's own bilinear
resize: decoding them must give the two people.
"""

from __future__ import annotations

import numpy as np
import torch

from tpupose import topology
from tpupose_torch.ops import image

# part offsets of an upright person, in units of its size
_BODY = {
    "nose": (0.0, -0.95), "neck": (0.0, -0.65),
    "Rsho": (-0.30, -0.65), "Relb": (-0.42, -0.30), "Rwri": (-0.45, 0.05),
    "Lsho": (0.30, -0.65), "Lelb": (0.42, -0.30), "Lwri": (0.45, 0.05),
    "Rhip": (-0.18, 0.10), "Rkne": (-0.20, 0.55), "Rank": (-0.20, 0.95),
    "Lhip": (0.18, 0.10), "Lkne": (0.20, 0.55), "Lank": (0.20, 0.95),
    "Reye": (-0.08, -1.02), "Leye": (0.08, -1.02),
    "Rear": (-0.17, -0.98), "Lear": (0.17, -0.98),
}


def person(cx: float, cy: float, size: float = 120.0) -> np.ndarray:
    """(18, 3) joints (x, y, visibility 0) of an upright person at (cx, cy)."""
    out = np.zeros((topology.NUM_PARTS, 3))
    for name, (dx, dy) in _BODY.items():
        out[topology.PART_INDEX[name]] = (cx + dx * size, cy + dy * size * 0.5, 0.0)
    return out


def planted_scene(sizes, seed: int = 3):
    """Two people on the 368x368 label grid, as per-scale (1, Hl, Wl, 19)
    heat and (1, Hl, Wl, 38) PAF maps for the pyramid ``sizes``
    ((rh, rw, ph, pw) per scale, as ``image.scale_sizes`` gives them)."""
    from tpupose.reference_impl import gt_np

    rng = np.random.default_rng(seed)
    joints = np.stack([person(110.0 + rng.normal() * 6, 200.0), person(255.0, 185.0)])
    labels = torch.from_numpy(gt_np.create_heatmaps_np(joints).astype(np.float32))
    heats, pafs = [], []
    for _, _, ph, pw in sizes:
        low = image.resize_bilinear(labels, ph // 8, pw // 8)
        heats.append(low[None, :, :, 38:].contiguous())
        pafs.append(low[None, :, :, :38].contiguous())
    return heats, pafs
