"""Dataset preparation: COCO keypoint annotations -> packed HDF5 + masks.

The port's copy of ``tpupose/data/coco_prep.py``: the counterpart of the
reference's ``generate_masks.py`` and ``generate_hdf5.py`` (SURVEY.md
C18/C19):

  * per image, a **miss-mask** excluding crowd regions and persons whose
    keypoints are unannotated from the loss (union of their
    segmentations, inverted), built with the native RLE codec
    (tpupose_torch.data.rle) instead of pycocotools;
  * per sufficiently-annotated person, one training record: crop centre,
    ``scale_provided = bbox_h / boxsize``, and the joint arrays of ALL
    persons in the image converted to the 18-part topology (COCO's 17
    keypoints + synthesised neck = mid-shoulders).

COCO keypoint visibility v: 0 = unlabelled, 1 = occluded, 2 = visible.
Internal convention (SURVEY.md C12): 0 = visible, 1 = occluded but
present, 2 = absent.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Iterator

import numpy as np

from tpupose_torch import topology
from tpupose_torch.data import hdf5 as hdf5_io
from tpupose_torch.data import rle

# COCO keypoint order (17) -> our PARTS indices; neck is synthesised.
COCO_KEYPOINTS = (
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
)
_COCO_TO_PART = {
    "nose": "nose",
    "left_eye": "Leye", "right_eye": "Reye",
    "left_ear": "Lear", "right_ear": "Rear",
    "left_shoulder": "Lsho", "right_shoulder": "Rsho",
    "left_elbow": "Lelb", "right_elbow": "Relb",
    "left_wrist": "Lwri", "right_wrist": "Rwri",
    "left_hip": "Lhip", "right_hip": "Rhip",
    "left_knee": "Lkne", "right_knee": "Rkne",
    "left_ankle": "Lank", "right_ankle": "Rank",
}
MIN_KEYPOINTS = 5
MIN_AREA = 32 * 32


def coco_joints_to_parts(kps: list[float]) -> np.ndarray:
    """(51,) COCO keypoint triplets -> (18, 3) internal joints."""
    out = np.full((topology.NUM_PARTS, 3), 2.0, np.float64)
    arr = np.asarray(kps, np.float64).reshape(17, 3)
    for ci, name in enumerate(COCO_KEYPOINTS):
        x, y, v = arr[ci]
        pi = topology.PART_INDEX[_COCO_TO_PART[name]]
        if v == 2:
            out[pi] = (x, y, 0.0)   # visible
        elif v == 1:
            out[pi] = (x, y, 1.0)   # occluded but present
        # v == 0 stays absent
    ls, rs = topology.PART_INDEX["Lsho"], topology.PART_INDEX["Rsho"]
    if out[ls, 2] < 2 and out[rs, 2] < 2:
        neck = topology.PART_INDEX["neck"]
        out[neck, :2] = (out[ls, :2] + out[rs, :2]) / 2.0
        out[neck, 2] = max(out[ls, 2], out[rs, 2])
    return out


def people_to_coco_results(
    people: list[dict], image_id: int, category_id: int = 1
) -> list[dict]:
    """People JSON -> pycocotools keypoint *results* records.

    The inverse of :func:`coco_joints_to_parts` on the detection side:
    each person becomes ``{"image_id", "category_id", "keypoints":
    [x1, y1, s1, ... 17 triplets in COCO order], "score"}`` — the exact
    format ``COCO.loadRes`` ingests, so detections from this framework
    drop straight into a pycocotools evaluation or any COCO-results
    tooling. The synthesised neck has no COCO slot and is dropped;
    absent keypoints emit (0, 0, 0) like the reference lineage's
    exporters. Per-keypoint confidence rides the third slot (loadRes
    ignores it; the ranking signal is "score")."""
    out = []
    for person in people:
        kps: list[float] = []
        for name in COCO_KEYPOINTS:
            part = _COCO_TO_PART[name]
            v = person["keypoints"].get(part)
            if v is None:
                kps += [0.0, 0.0, 0.0]
            else:
                kps += [float(v["x"]), float(v["y"]),
                        float(v.get("score", 1.0))]
        out.append({
            "image_id": int(image_id),
            "category_id": int(category_id),
            "keypoints": kps,
            "score": float(person["score"]),
        })
    return out


def _segmentation_mask(seg, h: int, w: int) -> np.ndarray:
    """Any COCO segmentation (polygon list or RLE dict) -> binary mask."""
    if isinstance(seg, dict):
        return rle.decode_coco(seg)
    import cv2

    mask = np.zeros((h, w), np.uint8)
    for poly in seg:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        cv2.fillPoly(mask, [np.round(pts).astype(np.int32)], 1)
    return mask


def miss_mask_for_image(
    anns: list[dict], h: int, w: int
) -> np.ndarray:
    """(h, w) float mask: 0 over crowd/under-annotated persons, 1 elsewhere."""
    excluded = []
    for a in anns:
        under_annotated = a.get("num_keypoints", 0) < MIN_KEYPOINTS
        if a.get("iscrowd", 0) or under_annotated:
            try:
                excluded.append(_segmentation_mask(a.get("segmentation"), h, w))
            except (TypeError, ValueError):
                continue
    if not excluded:
        return np.ones((h, w), np.float32)
    return 1.0 - rle.merge(excluded).astype(np.float32)


def iter_records(
    annotation_json: str, image_dir: str, boxsize: int = 368
) -> Iterator[dict]:
    """One record per main person, reference selection rules."""
    import cv2

    with open(annotation_json) as f:
        coco = json.load(f)
    images = {im["id"]: im for im in coco["images"]}
    by_image: dict[int, list[dict]] = defaultdict(list)
    for a in coco["annotations"]:
        by_image[a["image_id"]].append(a)

    for image_id, anns in by_image.items():
        info = images[image_id]
        h, w = info["height"], info["width"]
        path = os.path.join(image_dir, info["file_name"])
        img = cv2.imread(path)
        if img is None:
            continue
        mask = miss_mask_for_image(anns, h, w)
        kept = [a for a in anns if a.get("num_keypoints", 0) > 0]
        all_joints = (
            np.stack([coco_joints_to_parts(a["keypoints"]) for a in kept])
            if kept else np.zeros((0, 18, 3))
        )
        # real GT segmentation areas, row-aligned with all_joints — OKS
        # evaluation is exponential in area
        all_areas = np.asarray([a.get("area", 0.0) for a in kept], np.float64)
        # COCOeval ignore regions (iscrowd=1 or num_keypoints==0): kept
        # OUT of the joint/area rows (they never rasterize GT) but carried
        # on the record as [x, y, w, h, area] so evaluation can reproduce
        # pycocotools' match-to-ignore semantics (data/coco_eval.py) —
        # without them, detections on crowds count as false positives.
        ignore_regions = [
            [float(v) for v in a["bbox"]] + [float(a.get("area", 0.0))]
            for a in anns
            if (a.get("iscrowd", 0) or a.get("num_keypoints", 0) == 0)
            and a.get("bbox") is not None
        ]

        for a in anns:
            if a.get("iscrowd", 0):
                continue
            if a.get("num_keypoints", 0) < MIN_KEYPOINTS:
                continue
            if a.get("area", 0) < MIN_AREA:
                continue
            x, y, bw, bh = a["bbox"]
            yield {
                "image": img,
                "mask": (mask * 255).astype(np.uint8),
                "joints": all_joints,
                "center": (x + bw / 2.0, y + bh / 2.0),
                "scale_provided": bh / float(boxsize),
                "areas": all_areas,
                # original COCO image id: results exported from an eval
                # over these records align with the real annotation file
                "image_id": int(image_id),
                "ignore_regions": ignore_regions,
            }


def iter_eval_images(
    annotation_json: str, image_dir: str
) -> Iterator[dict]:
    """One record per IMAGE for direct evaluation (no packing step).

    Unlike :func:`iter_records` (one record per qualifying main person,
    the training contract), this yields each annotated image exactly once
    with everything evaluation needs: ``image`` (BGR uint8), ``image_id``,
    ``gt`` — the keypointed persons as coco_eval GT dicts ({"keypoints"
    (18, 3) internal, "area", "num_keypoints"}) — and ``ignore_regions``
    ([x, y, w, h, area] rows for iscrowd/keypointless annotations, the
    match-to-ignore GT). Images that fail to load are skipped; images
    with no keypointed person — or no annotations at all — still
    evaluate (detections on them are false positives unless absorbed by
    an ignore region), exactly as pycocotools scores every image in the
    GT set."""
    import cv2

    with open(annotation_json) as f:
        coco = json.load(f)
    by_image: dict[int, list[dict]] = defaultdict(list)
    for a in coco["annotations"]:
        by_image[a["image_id"]].append(a)

    for info in coco["images"]:
        image_id = info["id"]
        anns = by_image.get(image_id, [])
        path = os.path.join(image_dir, info["file_name"])
        img = cv2.imread(path)
        if img is None:
            continue
        gt = [
            {
                "keypoints": coco_joints_to_parts(a["keypoints"]),
                "area": float(a.get("area", 0.0)),
                "num_keypoints": int(a.get("num_keypoints", 0)),
            }
            for a in anns
            if not a.get("iscrowd", 0) and a.get("num_keypoints", 0) > 0
        ]
        ignore = [
            [float(v) for v in a["bbox"]] + [float(a.get("area", 0.0))]
            for a in anns
            if (a.get("iscrowd", 0) or a.get("num_keypoints", 0) == 0)
            and a.get("bbox") is not None
        ]
        yield {
            "image": img,
            "image_id": int(image_id),
            "gt": gt,
            "ignore_regions": ignore,
        }


def pack(
    annotation_json: str, image_dir: str, out_path: str, boxsize: int = 368,
    compression: str | None = "lzf",
) -> int:
    """Full prep: annotations + images -> packed dataset. Returns #records.

    ``out_path`` ending in ``.tpr`` writes the native record container
    (read by `native/feed.cpp`'s threaded inflater — the production
    training feed; `tpupose_torch.data.pack_tpr --pre-pad` can further
    pre-pad it to the train geometry). Anything else writes packed HDF5, the
    reference-compatible format.

    ``compression``: see :class:`tpupose_torch.data.hdf5.SampleWriter` — the
    codec bounds training-feed read throughput; ``None`` maximises it.
    (For ``.tpr``, any non-None value selects zlib.)
    """
    if out_path.endswith(".tpr"):
        from tpupose_torch.data import tpr

        return tpr.write_samples(
            out_path, iter_records(annotation_json, image_dir, boxsize),
            compression=None if compression in (None, "none") else "zlib",
        )
    n = 0
    with hdf5_io.SampleWriter(out_path, compression=compression) as w:
        for rec in iter_records(annotation_json, image_dir, boxsize):
            w.add(
                rec["image"], rec["mask"], rec["joints"],
                rec["center"], rec["scale_provided"], areas=rec["areas"],
                image_id=rec.get("image_id"),
                ignore_regions=rec.get("ignore_regions"),
            )
            n += 1
    return n
