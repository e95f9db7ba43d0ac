"""Synthetic inputs for checking the port where no weights or data exist.

``planted_scene`` builds per-scale low-res heat/PAF maps of a known
two-person scene from the port's ground-truth rasteriser
(``gt.rasterize.create_labels`` on the CPU), resized with the port's own
bilinear resize: decoding them must give the two people.
``crowded_scene`` does the same for a crowd of 30 or more people in a
720x1280 frame: the tables the association meets on a crowded frame.
``crowded_flats`` and ``adversarial_flats`` are masked peak scores, the
input of the sorted peak tables (``ops/peak_tables.py``).
``png_bytes`` encodes an image as a request body with ``zlib`` alone.
``coco_keypoint_set`` writes a COCO-format keypoint set (annotations and
PNG images) from a seed: the input of ``prepare`` and ``eval``.
``spawn_ranks`` runs a function in the processes of a fresh
``torch.distributed`` group on this host (a local TCP rendezvous).
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
import zlib

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


def limit_threads() -> None:
    """Give torch's intra-op pool this process's share of the host's cores
    when it is one of several pytest-xdist workers (each worker would
    otherwise start a thread per core, and the workers together many times
    more threads than cores). The port's test files call it at import."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


def free_port() -> int:
    """A TCP port on localhost that was free when asked."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn, world: int, address: str, args: tuple, out: str) -> None:
    result = fn(rank, world, address, *args)
    torch.save(result, os.path.join(out, f"{rank}.pt"))


def spawn_ranks(fn, world: int, *args, timeout: float = 600.0) -> list:
    """``fn(rank, world, address, *args)`` in ``world`` spawned processes,
    ``address`` a free ``127.0.0.1:<port>`` for their rendezvous (e.g.
    ``parallel.distributed.init_multihost(address, world, rank)``); their
    results (picklable) in rank order. A rank that raises fails the call
    with its traceback; past ``timeout`` seconds every rank is killed and
    the call raises. ``fn`` is pickled by name: a module-level function."""
    import tempfile

    import torch.multiprocessing as mp

    address = f"127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory() as out:
        ctx = mp.start_processes(_rank_main, args=(fn, world, address, args, out), nprocs=world,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawn_ranks: {world} ranks still running "
                                       f"after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(out, f"{r}.pt"), weights_only=False)
                for r in range(world)]


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


def crowded_flats(rows: int, n: int, seed: int = 0, device="cpu") -> torch.Tensor:
    """(rows, n) masked scores as a random crowd leaves them: -inf off-peak
    and, in each row, peaks at random places with a density of up to 1 in
    250 (a few rows hold fewer than a hundred), scores in [0.1, 1] on a
    grid of 1/4096, so that many are exactly equal. Made on ``device``
    from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    density = 4e-3 * torch.rand((rows, 1), generator=g, device=device) ** 2
    peak = torch.rand((rows, n), generator=g, device=device) < density
    scores = torch.round((0.1 + 0.9 * torch.rand((rows, n), generator=g, device=device)) * 4096)
    return torch.where(peak, scores / 4096, -torch.inf)


def adversarial_flats(n: int, seed: int = 0) -> torch.Tensor:
    """(10, n) masked scores, n >= 16, a row for each hard case of the
    sorted order: exact ties, ties of +0.0 and -0.0, +inf and NaN of
    both signs among a few peaks, all NaN, all -inf, fewer peaks than
    the tables hold (filler), -inf and NaN filler together, ascending
    scores (every score beats those before it), negative NaN in every
    third place, and a row of random peaks."""
    rng = np.random.default_rng(seed)
    nan = np.float32(np.nan)
    flat = np.full((10, n), -np.inf, np.float32)
    flat[0, rng.random(n) < 0.2] = 0.5
    flat[1, rng.random(n) < 0.2] = 0.0
    flat[1, rng.random(n) < 0.1] = -0.0
    flat[2, :8] = [np.inf, 1.0, nan, -nan, np.inf, 2.0, -np.inf, -0.0]
    flat[3] = nan
    flat[5, rng.choice(n, 5, replace=False)] = rng.random(5)
    flat[6, rng.choice(n, 8, replace=False)] = [0.5, -nan, nan, 0.25, -nan, 1.0, 0.75, nan]
    flat[7] = np.arange(n, dtype=np.float32) - n / 2
    flat[8, ::3] = -nan
    live = rng.random(n) < 0.3
    flat[9, live] = rng.random(int(live.sum()))
    return torch.from_numpy(flat)


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def png_bytes(image: np.ndarray, filters=(0, 1, 2), level: int = 1) -> bytes:
    """(H, W, 3) uint8 BGR -> an 8-bit RGB PNG, deflated at ``level``. Row y
    is filtered with ``filters[y % len(filters)]`` (0 None, 1 Sub, 2 Up,
    3 Average, 4 Paeth), or with ``filters="adaptive"`` as libpng chooses
    by default: the filter whose bytes, read as signed, sum to the least
    magnitude, the first of 0..4 on a tie (what ``cv2.imencode`` writes
    when given a compression level)."""
    rgb = np.ascontiguousarray(np.asarray(image, np.uint8)[:, :, ::-1]).astype(np.int32)
    h, w, bpp = rgb.shape
    rows = rgb.reshape(h, w * bpp)
    out = bytearray()
    for y in range(h):
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        preds = (0, left, up, (left + up) // 2, _paeth(left, up, up_left))
        if filters == "adaptive":
            residuals = [(x - pred) % 256 for pred in preds]
            kind = int(np.argmin([np.minimum(r, 256 - r).sum() for r in residuals]))
        else:
            kind = filters[y % len(filters)]
        out.append(kind)
        out += ((x - preds[kind]) % 256).astype(np.uint8).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out), level)) + chunk(b"IEND", b""))


# COCO's 17 keypoints in annotation order, as the port's part names
COCO_PARTS = ("nose", "Leye", "Reye", "Lear", "Rear", "Lsho", "Rsho", "Lelb", "Relb",
              "Lwri", "Rwri", "Lhip", "Rhip", "Lkne", "Rkne", "Lank", "Rank")


def coco_keypoint_set(directory: str, shapes, seed: int = 0) -> tuple[str, str]:
    """A COCO-format keypoint set under ``directory``: one random PNG per
    (h, w) of ``shapes`` in ``images/``, and ``annotations.json`` with 1-4
    upright persons on each image but the last, which has no annotation.
    Each person has the 17 COCO keypoints (about one in ten unlabelled and
    one in six occluded), ``num_keypoints``, a box polygon as its
    segmentation, and its box's area. The first image also holds a person
    with 3 keypoints (under-annotated: masked out, no training record), the
    second a crowd region given as a polygon, the third one given as a COCO
    RLE string. Returns (annotation path, image directory)."""
    import cv2

    from tpupose_torch.data import rle

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(directory, "images")
    os.makedirs(img_dir, exist_ok=True)
    images, anns = [], []

    def add(image_id, kps, box, num, iscrowd=0, segmentation=None):
        x, y, bw, bh = box
        anns.append({
            "id": len(anns) + 1, "image_id": image_id, "category_id": 1, "iscrowd": iscrowd,
            "keypoints": kps, "num_keypoints": num, "bbox": [x, y, bw, bh],
            "area": round(bw * bh * 0.6, 2),
            "segmentation": segmentation or [[x, y, x + bw, y, x + bw, y + bh, x, y + bh]],
        })

    for i, (h, w) in enumerate(shapes):
        image_id = 1000 + i
        name = f"{i:03d}.png"
        cv2.imwrite(os.path.join(img_dir, name), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        images.append({"id": image_id, "file_name": name, "height": h, "width": w})
        if i == len(shapes) - 1:
            continue
        for k in range(int(rng.integers(1, 5)) + (i == 0)):
            size = rng.uniform(0.4, 0.7) * min(h, w)
            cx = rng.uniform(0.5 * size, w - 0.5 * size)
            cy = rng.uniform(0.55 * size, h - 0.55 * size)
            joints = person(cx, cy, size)
            vis = rng.choice([2, 1, 0], p=[0.75, 0.15, 0.1], size=len(COCO_PARTS))
            if k == 0 and i == 0:
                vis[3:] = 0                           # the under-annotated person
            kps: list = []
            for v, part in zip(vis, COCO_PARTS):
                x, y = joints[topology.PART_INDEX[part], :2]
                kps += [round(float(x), 2), round(float(y), 2), int(v)] if v else [0, 0, 0]
            xs, ys = joints[:, 0], joints[:, 1]
            x0, y0 = max(float(xs.min()) - 4, 0.0), max(float(ys.min()) - 4, 0.0)
            box = [round(x0, 2), round(y0, 2), round(min(float(xs.max()) + 4, w - 1) - x0, 2),
                   round(min(float(ys.max()) + 4, h - 1) - y0, 2)]
            add(image_id, kps, box, int((vis > 0).sum()))
        if i in (1, 2):                               # a crowd region
            bw, bh = w // 4, h // 4
            x0, y0 = w - bw - 1, h - bh - 1
            seg = [[x0, y0, x0 + bw, y0, x0 + bw, y0 + bh, x0, y0 + bh]]
            if i == 2:
                mask = np.zeros((h, w), np.uint8)
                mask[y0:y0 + bh, x0:x0 + bw] = 1
                seg = {"size": [h, w],
                       "counts": rle.to_string_np(rle.encode_np(mask)).decode("ascii")}
            add(image_id, [0] * 51, [x0, y0, bw, bh], 0, iscrowd=1, segmentation=seg)
    ann_path = os.path.join(directory, "annotations.json")
    with open(ann_path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    return ann_path, img_dir


def people_from_gt(gt: list[dict]) -> list[dict]:
    """One image's evaluation GT (``coco_eval`` dicts) as detections: each
    person with labelled keypoints becomes a people-JSON entry holding them
    (score 1); ignore regions give none. Scored against the same GT, the
    detections of a whole set give AP 1.0."""
    people = []
    for g in gt:
        kp = np.asarray(g["keypoints"], np.float64)
        if g.get("iscrowd") or g.get("num_keypoints", 1) == 0 or not (kp[:, 2] < 2).any():
            continue
        people.append({
            "keypoints": {topology.PARTS[i]: {"x": float(kp[i, 0]), "y": float(kp[i, 1]),
                                              "score": 1.0}
                          for i in range(len(kp)) if kp[i, 2] < 2},
            "score": 1.0,
            "num_parts": int((kp[:, 2] < 2).sum()),
        })
    return people
