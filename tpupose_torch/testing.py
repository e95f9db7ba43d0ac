"""Synthetic inputs for checking the port where no weights or data exist.

``planted_scene`` builds per-scale low-res heat/PAF maps of a known
two-person scene from the port's ground-truth rasteriser
(``gt.rasterize.create_labels`` on the CPU), resized with the port's own
bilinear resize: decoding them must give the two people.
``crowded_scene`` does the same for a crowd of 30 or more people in a
720x1280 frame: the tables the association meets on a crowded frame.
"""

from __future__ import annotations

import numpy as np
import torch

from tpupose_torch import topology
from tpupose_torch.gt.rasterize import create_labels
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
    rng = np.random.default_rng(seed)
    joints = np.stack([person(110.0 + rng.normal() * 6, 200.0), person(255.0, 185.0)])
    paf, heat = create_labels(torch.from_numpy(joints.astype(np.float32))[None],
                              torch.ones((1, 46, 46)))
    labels = torch.cat([paf[0], heat[0]], dim=-1)                  # (46, 46, 57)
    heats, pafs = [], []
    for _, _, ph, pw in sizes:
        low = image.resize_bilinear(labels, ph // 8, pw // 8)
        heats.append(low[None, :, :, 38:].contiguous())
        pafs.append(low[None, :, :, :38].contiguous())
    return heats, pafs


def crowded_scene(sizes, n_people: int = 32, seed: int = 0, frame: tuple = (720, 1280)):
    """``n_people`` upright persons in a frame of (h, w) pixels, on a grid
    of 8 columns with sizes and places jittered from ``seed`` (neighbours
    overlap a little), rasterised with ``create_labels`` on the
    square stride-8 label grid that covers the frame, cropped to the frame
    and resized to each scale's low-res grid: per-scale (1, Hl, Wl, 19)
    heat and (1, Hl, Wl, 38) PAF maps for the pyramid ``sizes`` of the
    frame (``image.scale_sizes``), and the (n_people, 18, 3) joints."""
    h, w = frame
    rng = np.random.default_rng(seed)
    cols = 8
    rows = -(-n_people // cols)
    cell_h, cell_w = h / rows, w / cols
    cells = np.sort(rng.choice(rows * cols, n_people, replace=False))
    joints = []
    for cell in cells:
        r, c = divmod(int(cell), cols)
        size = rng.uniform(0.75, 1.0) * min(cell_h, cell_w / 0.9)
        cx = (c + 0.5 + rng.uniform(-0.15, 0.15)) * cell_w
        cy = (r + 0.5 + rng.uniform(-0.1, 0.1)) * cell_h
        joints.append(person(cx, cy, size))
    joints = np.stack(joints).astype(np.float32)
    label = -(-max(h, w) // 8)
    paf, heat = create_labels(torch.from_numpy(joints)[None], torch.ones((1, label, label)),
                              label_size=label, stride=8)
    labels = torch.cat([paf[0], heat[0]], dim=-1)[: -(-h // 8), : -(-w // 8)]
    heats, pafs = [], []
    for _, _, ph, pw in sizes:
        low = image.resize_bilinear(labels, ph // 8, pw // 8)
        heats.append(low[None, :, :, 38:].contiguous())
        pafs.append(low[None, :, :, :38].contiguous())
    return heats, pafs, joints
