"""Stepwise decode walkthrough (the reference's demo.ipynb).

The port's counterpart of ``examples/walkthrough.py``. Visualises every
decode stage on a synthetic two-person scene: input, nose heatmap, a PAF
channel pair, NMS peaks, and the final skeletons. Writes one PNG panel per
stage. The scene's maps are ground-truth labels (the gt kernel on the card)
upsampled to 368x368, standing in for network output; the decode of the
full-res maps runs the peaks and assoc kernels on the card.

Run:  python -m tpupose_torch.examples.walkthrough --outdir /tmp/walkthrough [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

PANELS = ("0_input.png", "1_heatmap_nose.png", "2_paf_neck_rsho.png", "3_peaks.png",
          "4_skeletons.png")


def synthetic_person(cx, cy, size=120.0):
    from tpupose_torch import topology

    rel = {
        "nose": (0.0, -0.95), "neck": (0.0, -0.65),
        "Rsho": (-0.30, -0.65), "Relb": (-0.42, -0.30), "Rwri": (-0.45, 0.05),
        "Lsho": (0.30, -0.65), "Lelb": (0.42, -0.30), "Lwri": (0.45, 0.05),
        "Rhip": (-0.18, 0.10), "Rkne": (-0.20, 0.55), "Rank": (-0.20, 0.95),
        "Lhip": (0.18, 0.10), "Lkne": (0.20, 0.55), "Lank": (0.20, 0.95),
        "Reye": (-0.08, -1.02), "Leye": (0.08, -1.02),
        "Rear": (-0.17, -0.98), "Lear": (0.17, -0.98),
    }
    out = np.zeros((18, 3))
    for name, (dx, dy) in rel.items():
        out[topology.PART_INDEX[name]] = (cx + dx * size, cy + dy * size * 0.5, 0.0)
    return out


def colorize(gray: np.ndarray) -> np.ndarray:
    import cv2

    g = np.clip(gray, 0, 1)
    return cv2.applyColorMap((g * 255).astype(np.uint8), cv2.COLORMAP_JET)


def scene_joints() -> np.ndarray:
    """The two people of the scene, (2, 18, 3) (x, y, v) in 368x368 pixels."""
    return np.stack([synthetic_person(120.0, 200.0), synthetic_person(260.0, 180.0)])


def scene_labels(device) -> np.ndarray:
    """(46, 46, 57) = [38 PAF | 19 heat] labels of the scene, f64 on the
    host, rasterised by ``ops.gt.create_labels`` on ``device`` (the gt
    kernel on a CUDA device) with a mask of ones."""
    from tpupose_torch.ops.gt import create_labels

    joints = torch.from_numpy(scene_joints()[None]).to(device, torch.float32)
    mask = torch.ones((1, 46, 46), dtype=torch.float32, device=device)
    paf, heat = create_labels(joints, mask)
    return torch.cat([paf[0], heat[0]], dim=-1).cpu().numpy().astype(np.float64)


def scene_maps(labels: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The labels upsampled to (368, 368, 19) heat and (368, 368, 38) PAF
    maps, f32, the heat with the walkthrough's fixed noise of 1e-3."""
    import cv2

    heat = cv2.resize(labels[:, :, 38:], (368, 368), interpolation=cv2.INTER_CUBIC)
    paf = cv2.resize(labels[:, :, :38], (368, 368), interpolation=cv2.INTER_CUBIC)
    heat += np.random.default_rng(1).normal(size=heat.shape) * 1e-3
    return heat.astype(np.float32), paf.astype(np.float32)


def walkthrough(outdir: str, device="cuda") -> dict:
    """Build the scene, decode it on ``device`` and write the five panels
    into ``outdir``. Returns the labels, the peak tables of panel 3 (xs,
    ys, scores, valid as numpy arrays) and the people of panel 4."""
    import cv2

    from tpupose_torch import topology
    from tpupose_torch.config import DEFAULT
    from tpupose_torch.decode import decode_maps, to_people
    from tpupose_torch.decode.peaks import find_peaks
    from tpupose_torch.utils.drawing import draw_people

    os.makedirs(outdir, exist_ok=True)
    device = torch.device(device)

    # --- scene: GT-derived maps stand in for network output ----------------
    labels = scene_labels(device)
    heat, paf = scene_maps(labels)

    image = np.full((368, 368, 3), 40, np.uint8)
    cv2.imwrite(f"{outdir}/0_input.png", image)

    # --- stage 1: heatmap channel ------------------------------------------
    cv2.imwrite(f"{outdir}/1_heatmap_nose.png", colorize(heat[:, :, 0]))

    # --- stage 2: PAF channel pair (neck->Rsho = limb 6 -> channels 12/13) --
    mag = np.sqrt(paf[:, :, 12] ** 2 + paf[:, :, 13] ** 2)
    cv2.imwrite(f"{outdir}/2_paf_neck_rsho.png", colorize(mag))

    # --- stage 3: NMS peaks --------------------------------------------------
    cfg = DEFAULT.inference
    heat_t, paf_t = (torch.from_numpy(m).to(device) for m in (heat, paf))
    pk = {k: v.cpu().numpy() for k, v in find_peaks(
        heat_t, max_peaks=cfg.max_peaks, sigma=cfg.peak_sigma, thre1=cfg.thre1).items()}
    canvas = image.copy()
    xs, ys, va = pk["xs"], pk["ys"], pk["valid"]
    for part in range(18):
        for i in np.nonzero(va[part])[0]:
            cv2.circle(canvas, (int(xs[part, i]), int(ys[part, i])), 4,
                       topology.DRAW_COLORS[part], -1)
    cv2.imwrite(f"{outdir}/3_peaks.png", canvas)

    # --- stage 4+5: connections + assembled skeletons -----------------------
    tables = decode_maps(heat_t, paf_t, cfg)
    people = to_people({k: v.cpu().numpy() for k, v in tables.items()})
    overlay = draw_people(image, people)
    cv2.imwrite(f"{outdir}/4_skeletons.png", overlay)
    return {"labels": labels, "peaks": pk, "people": people}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--outdir", default="walkthrough_out")
    ap.add_argument("--device", default="cuda",
                    help="where the scene is rasterised and decoded: cuda (default) or cpu")
    args = ap.parse_args(argv)
    people = walkthrough(args.outdir, args.device)["people"]
    print(f"{len(people)} people decoded; panels in {args.outdir}/")
    for i, p in enumerate(people):
        print(f"  person {i}: {p['num_parts']} parts, score {p['score']:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
