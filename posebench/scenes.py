"""Seeded synthetic scenes of the fork's new domain, rendered on the device.

After ``make_person`` and ``render`` of
``tpupose_torch/data/make_synthetic_dataset.py`` (frozen here): humanoid
stick figures of 1 to ``max_persons`` people with known joints; the
"light" style: a bright noisy background, six distractor blobs, dark
limbs of width 3 and black joint dots of radius 4. Shapes are drawn with
anti-aliased coverage (one pixel of linear ramp) instead of cv2's
rasteriser, so the same seed gives the same frames on any host.

The discrete draws (counts, positions, sizes, colours) come from a numpy
generator, the pixel noise from a torch generator on the device, both
seeded from the run's seed.
"""

from __future__ import annotations

import numpy as np
import torch

from posebench.reference import skeleton

REL = {
    "nose": (0.0, -0.95), "neck": (0.0, -0.65),
    "Rsho": (-0.30, -0.65), "Relb": (-0.42, -0.30), "Rwri": (-0.45, 0.05),
    "Lsho": (0.30, -0.65), "Lelb": (0.42, -0.30), "Lwri": (0.45, 0.05),
    "Rhip": (-0.18, 0.10), "Rkne": (-0.20, 0.55), "Rank": (-0.20, 0.95),
    "Lhip": (0.18, 0.10), "Lkne": (0.20, 0.55), "Lank": (0.20, 0.95),
    "Reye": (-0.08, -1.02), "Leye": (0.08, -1.02),
    "Rear": (-0.17, -0.98), "Lear": (0.17, -0.98),
}


def make_person(rng: np.random.Generator, w: int, h: int) -> tuple[np.ndarray, float]:
    """(18, 3) joints (x, y, visibility 0) and the person's height."""
    hi = min(150.0, 0.8 * min(w, h))
    size = rng.uniform(min(70.0, hi * 0.6), hi)
    cx = rng.uniform(size * 0.5, max(w - size * 0.5, size * 0.5 + 1))
    cy = rng.uniform(size * 0.55, max(h - size * 0.55, size * 0.55 + 1))
    jitter = rng.normal(0, 0.02, (18, 2))
    joints = np.zeros((18, 3))
    for name, (dx, dy) in REL.items():
        i = skeleton.PART_INDEX[name]
        joints[i, 0] = cx + (dx + jitter[i, 0]) * size
        joints[i, 1] = cy + (dy + jitter[i, 1]) * size * 0.5
    return joints, size


class Canvas:
    """Pixel grids of one frame size on one device."""

    def __init__(self, h: int, w: int, device):
        self.h, self.w = h, w
        self.y = torch.arange(h, device=device, dtype=torch.float32)[:, None]
        self.x = torch.arange(w, device=device, dtype=torch.float32)[None, :]

    def disc(self, cx: float, cy: float, r: float) -> torch.Tensor:
        d = torch.sqrt((self.x - cx) ** 2 + (self.y - cy) ** 2)
        return (r + 0.5 - d).clamp(0.0, 1.0)

    def segment(self, a, b, width: float) -> torch.Tensor:
        ax, ay = float(a[0]), float(a[1])
        vx, vy = float(b[0]) - ax, float(b[1]) - ay
        t = ((self.x - ax) * vx + (self.y - ay) * vy) / max(vx * vx + vy * vy, 1e-9)
        t = t.clamp(0.0, 1.0)
        d = torch.sqrt((self.x - ax - t * vx) ** 2 + (self.y - ay - t * vy) ** 2)
        return (width / 2 + 0.5 - d).clamp(0.0, 1.0)


def _paint(img: torch.Tensor, cover: torch.Tensor, color) -> torch.Tensor:
    c = torch.as_tensor(color, dtype=torch.float32, device=img.device)
    return img * (1 - cover[..., None]) + c * cover[..., None]


def render_light(rng: np.random.Generator, gen: torch.Generator, canvas: Canvas,
                 people: list[np.ndarray]) -> torch.Tensor:
    """One "light" frame, float (H, W, 3) in [0, 255]."""
    h, w = canvas.h, canvas.w
    dev = canvas.x.device
    img = torch.empty((h, w, 3), device=dev).uniform_(160, 255, generator=gen)
    img = (img + torch.empty_like(img).normal_(0, 20, generator=gen)).clamp(0, 255)
    for _ in range(6):
        color = rng.integers(0, 255, 3)
        cx, cy, r = rng.uniform(0, w), rng.uniform(0, h), rng.uniform(8, 30)
        img = _paint(img, canvas.disc(cx, cy, r), color)
    for joints in people:
        color = rng.integers(0, 90, 3)
        for pa, pb in skeleton.LIMBS:
            img = _paint(img, canvas.segment(joints[pa], joints[pb], 3.0), color)
        for p in range(skeleton.NUM_PARTS):
            img = _paint(img, canvas.disc(joints[p, 0], joints[p, 1], 4.0), (0, 0, 0))
    return img


def frames(seed: int, count: int, h: int, w: int, max_persons: int, device) -> torch.Tensor:
    """``count`` seeded frames, uint8 (count, H, W, 3) on ``device``."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    canvas = Canvas(h, w, device)
    out = torch.empty((count, h, w, 3), dtype=torch.uint8, device=device)
    for i in range(count):
        n = int(rng.integers(1, max_persons + 1))
        people = [make_person(rng, w, h)[0] for _ in range(n)]
        out[i] = render_light(rng, gen, canvas, people).round().to(torch.uint8)
    return out


def records(seed: int, scenes: int, size: int, max_persons: int, device) -> list[dict]:
    """``scenes`` seeded square frames of ``size`` and one training record
    per person, as the fork's dataset tool writes them: the scene's image,
    a mask that keeps everything, every person's joints, the person's
    joint centre and height / 368 as its scale."""
    rng = np.random.default_rng([seed, 0x7EA1])
    gen = torch.Generator(device=device).manual_seed(int(seed) ^ 0x7EA1)
    canvas = Canvas(size, size, device)
    mask = np.full((size, size), 255, np.uint8)
    out = []
    for _ in range(scenes):
        n = int(rng.integers(1, max_persons + 1))
        people = [make_person(rng, size, size) for _ in range(n)]
        joints = np.stack([p[0] for p in people])
        image = render_light(rng, gen, canvas, [p[0] for p in people]).round().to(torch.uint8)
        image = image.cpu().numpy()
        xy = joints[..., :2]
        areas = [float(np.ptp(j[:, 0]) * np.ptp(j[:, 1])) for j in xy]
        for pj, size_px in people:
            out.append({"image": image, "mask": mask, "joints": joints,
                        "center": (float(pj[:, 0].mean()), float(pj[:, 1].mean())),
                        "scale_provided": size_px / 368.0, "areas": areas})
    return out
