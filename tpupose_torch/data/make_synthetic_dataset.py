"""Generate a synthetic "new-domain" packed dataset of rendered figures.

The port's counterpart of ``tools/make_synthetic_dataset.py``. Lets the
whole domain-adaptation story (make a set -> finetune -> eval) run end to
end without COCO: humanoid stick figures with known joints are rendered
onto textured backgrounds and packed into a dataset the port's feeds and
``eval`` read. The rendering style (thick anti-aliased limbs on noise) is
the "new domain".

The output format follows the extension, as ``cli prepare --output`` does:
``.tpr`` (the native record container, ``data/tpr.py``) or an HDF5 file
(``data/hdf5.py``, which needs h5py). One seed gives the same records in
either format, and the same records as the reference tool.

Usage:
  python -m tpupose_torch.data.make_synthetic_dataset --output synth.tpr --count 64
  python -m tpupose_torch.data.pack_tpr --input synth.tpr --output synth368.tpr \\
      --pre-pad 368 368 --max-persons 24
"""

from __future__ import annotations

import argparse

import numpy as np

from tpupose_torch import topology


REL = {
    "nose": (0.0, -0.95), "neck": (0.0, -0.65),
    "Rsho": (-0.30, -0.65), "Relb": (-0.42, -0.30), "Rwri": (-0.45, 0.05),
    "Lsho": (0.30, -0.65), "Lelb": (0.42, -0.30), "Lwri": (0.45, 0.05),
    "Rhip": (-0.18, 0.10), "Rkne": (-0.20, 0.55), "Rank": (-0.20, 0.95),
    "Lhip": (0.18, 0.10), "Lkne": (0.20, 0.55), "Lank": (0.20, 0.95),
    "Reye": (-0.08, -1.02), "Leye": (0.08, -1.02),
    "Rear": (-0.17, -0.98), "Lear": (0.17, -0.98),
}


def make_person(rng, w, h):
    # person height scales with the canvas so small canvases stay valid
    hi = min(150.0, 0.8 * min(w, h))
    size = rng.uniform(min(70.0, hi * 0.6), hi)
    cx = rng.uniform(size * 0.5, max(w - size * 0.5, size * 0.5 + 1))
    cy = rng.uniform(size * 0.55, max(h - size * 0.55, size * 0.55 + 1))
    jitter = rng.normal(0, 0.02, (18, 2))
    joints = np.zeros((18, 3))
    for name, (dx, dy) in REL.items():
        i = topology.PART_INDEX[name]
        joints[i, 0] = cx + (dx + jitter[i, 0]) * size
        joints[i, 1] = cy + (dy + jitter[i, 1]) * size * 0.5
        joints[i, 2] = 0.0
    return joints, size


def render(rng, joints_list, w, h, style="dark"):
    """Render a scene. Styles are distinct "domains":

    dark   — bright figures on dark noise (domain A)
    light  — dark thin figures on bright textured background with
             distractor blobs (domain B, the adaptation target)
    varied — per-scene randomized background brightness/texture,
             figure color/thickness, and distractor count: a DIVERSE
             source domain whose features must be style-invariant
    """
    import cv2

    if style == "varied":
        base = rng.uniform(0, 230)
        img = (base + rng.uniform(-25, 25, (h, w, 3))
               + rng.normal(0, rng.uniform(4, 20), (h, w, 3))).clip(0, 255)
        img = img.astype(np.uint8)
        for _ in range(int(rng.integers(0, 8))):
            c = tuple(int(v) for v in rng.integers(0, 255, 3))
            cv2.circle(img, (int(rng.uniform(0, w)), int(rng.uniform(0, h))),
                       int(rng.uniform(6, 28)), c, -1, lineType=cv2.LINE_AA)
        # figure tone must contrast with the background or the sample is
        # unlearnable: sample brightness away from the base tone
        lo, hi = (140, 255) if base < 115 else (0, 115)

        def line_color(lo=lo, hi=hi):
            return tuple(int(c) for c in rng.integers(lo, hi, 3))

        dot_color = (255, 255, 255) if base < 115 else (0, 0, 0)
        thickness = int(rng.integers(2, 7))
    elif style == "dark":
        img = (rng.uniform(0, 60, (h, w, 3)) + rng.normal(0, 8, (h, w, 3))).clip(0, 255)
        img = img.astype(np.uint8)
        line_color = lambda: tuple(int(c) for c in rng.integers(120, 255, 3))
        dot_color = (255, 255, 255)
        thickness = 5
    elif style == "light":
        img = (rng.uniform(160, 255, (h, w, 3)) + rng.normal(0, 20, (h, w, 3))).clip(0, 255)
        img = img.astype(np.uint8)
        for _ in range(6):  # distractor blobs
            c = tuple(int(v) for v in rng.integers(0, 255, 3))
            cv2.circle(img, (int(rng.uniform(0, w)), int(rng.uniform(0, h))),
                       int(rng.uniform(8, 30)), c, -1, lineType=cv2.LINE_AA)
        line_color = lambda: tuple(int(c) for c in rng.integers(0, 90, 3))
        dot_color = (0, 0, 0)
        thickness = 3
    else:
        raise ValueError(f"unknown style {style!r}")

    for joints in joints_list:
        color = line_color()
        for pa, pb in topology.LIMBS:
            a = tuple(np.round(joints[pa, :2]).astype(int))
            b = tuple(np.round(joints[pb, :2]).astype(int))
            cv2.line(img, a, b, color, thickness=thickness, lineType=cv2.LINE_AA)
        for p in range(18):
            cv2.circle(
                img,
                tuple(np.round(joints[p, :2]).astype(int)),
                4,
                dot_color,
                -1,
                lineType=cv2.LINE_AA,
            )
    return img


def samples(args):
    """The records of the set as ``hdf5.read_samples`` dicts, one per
    person, in the reference tool's order of ``rng`` draws: per scene the
    person count, each ``make_person``, then ``render``."""
    from tpupose_torch.data import hdf5 as hdf5_io

    rng = np.random.default_rng(args.seed)
    w = h = args.size
    for _ in range(args.count):
        n_persons = int(rng.integers(1, args.max_persons + 1))
        people = [make_person(rng, w, h) for _ in range(n_persons)]
        joints = np.stack([p[0] for p in people])
        img = render(rng, joints, w, h, style=args.style)
        mask = np.full((h, w), 255, np.uint8)
        areas = hdf5_io.estimate_areas(joints)
        # one record per person (reference selection: main person)
        for pj, size in people:
            present = pj[:, 2] < 2
            cx, cy = pj[present, 0].mean(), pj[present, 1].mean()
            yield {"image": img, "mask": mask, "joints": joints, "center": (cx, cy),
                   "scale_provided": size / 368.0, "areas": areas}


def main(argv=None) -> int:
    from tpupose_torch.data import hdf5 as hdf5_io
    from tpupose_torch.data import tpr

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--output", required=True,
                    help=".tpr (the native record container) or .h5 (needs h5py)")
    ap.add_argument("--count", type=int, default=64)
    ap.add_argument("--size", type=int, default=368)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-persons", type=int, default=3)
    ap.add_argument("--style", default="dark",
                    choices=["dark", "light", "varied"])
    ap.add_argument("--compression", default="lzf",
                    choices=["lzf", "gzip", "none"],
                    help="HDF5 codec; 'none' maximises feed read rate. For .tpr, "
                         "'none' writes raw records and 'lzf' or 'gzip' zlib")
    args = ap.parse_args(argv)

    comp = None if args.compression == "none" else args.compression
    if args.output.endswith(".tpr"):
        n_written = tpr.write_samples(args.output, samples(args),
                                      compression=comp and "zlib")
    else:
        n_written = 0
        with hdf5_io.SampleWriter(args.output, compression=comp) as writer:
            for s in samples(args):
                writer.add(s["image"], s["mask"], s["joints"], s["center"],
                           s["scale_provided"], areas=s["areas"])
                n_written += 1
    print(f"wrote {n_written} records -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
