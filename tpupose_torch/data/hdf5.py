"""Packed-HDF5 dataset ingest (reference RawDataIterator contract).

The port's copy of ``tpupose/data/hdf5.py``. ``h5py`` is imported where a
file is opened; without it those calls raise ``ModuleNotFoundError``
naming ``h5py``.

The reference packs each training sample as an HDF5 record holding the
JPEG-decoded image, the miss-mask, and a JSON metadata blob (main-person
centre, scale_provided, all-person joints) — SURVEY.md C13/C19. This
module reads and writes that format so datasets prepared for the
reference drop straight into the training feed, and adds fixed-shape
padding (max_persons, letterboxing) so batches have static shapes.

Record layout (one HDF5 group per sample, this framework's writer):
  image  (H, W, 3) uint8
  mask   (H, W)    uint8 (255 = keep)
  meta   attrs: center (2,), scale_provided (), joints (P, 18, 3),
         areas (P,) GT segmentation areas; optional eval-side keys
         image_id (original COCO id) and ignore_regions
         ([x, y, w, h, area] rows for iscrowd/keypointless GT)

The reader ALSO parses the upstream lineage's packed-datum layout
(``py_rmpe_server/generate_hdf5.py``): ``/datum/<key>`` DATASETS (not
groups) of uint8 (H, W, 4..6) — BGR image + mask_miss channel
(+ mask_all) — with a JSON ``meta`` attribute carrying ``joints`` (or
``joint_self``/``joint_others``), ``objpos`` and ``scale_provided``.
The reference mount was empty when this was built (SURVEY.md section 0),
so the layout is reconstructed from the lineage; the parser is
field-tolerant (17-kp COCO joints are converted, missing areas are
bbox-estimated) and pinned by tests/test_data.py's synthetic
upstream-layout file.
"""

from __future__ import annotations

import json
from typing import Iterator

import numpy as np

from tpupose_torch import topology


class SampleWriter:
    """Writes the packed dataset (tools/coco prep use this).

    ``compression``: HDF5 filter for the image/mask datasets. The
    default is ``"lzf"`` — decompression speed bounds the training feed
    (the host must out-run the on-chip step rate; see
    ``experiments/feed_bench_r3.py``: gzip reads ~155 records/s vs the
    151 samples/s batch-16 train step, lzf ~1.5x that, ``None``
    (uncompressed) ~6x at ~20% more disk). Readers are codec-agnostic
    (h5py resolves the filter per dataset), so existing gzip files keep
    working.
    """

    def __init__(self, path: str, compression: str | None = "lzf"):
        import h5py

        self._f = h5py.File(path, "w")
        self._group = self._f.create_group("datum")
        self._n = 0
        if compression == "gzip":
            self._comp: dict = {"compression": "gzip", "compression_opts": 1}
        elif compression is None or compression == "none":
            self._comp = {}
        else:
            self._comp = {"compression": compression}

    def add(
        self,
        image: np.ndarray,
        mask: np.ndarray,
        joints: np.ndarray,
        center: tuple[float, float],
        scale_provided: float,
        areas: np.ndarray | None = None,
        image_id: int | None = None,
        ignore_regions: list | None = None,
    ) -> None:
        """``areas``: per-person GT segmentation areas aligned with the
        leading axis of ``joints`` — OKS evaluation is exponential in
        area, so real values (COCO ``ann["area"]``) must ride the record.

        ``image_id``: original COCO image id, so detections evaluated
        over this dataset export as results JSON aligned with the real
        annotation file. ``ignore_regions``: COCOeval ignore GT
        (iscrowd=1 / num_keypoints==0) as [x, y, w, h, area] rows —
        evaluation treats them as match-to-ignore (data/coco_eval.py)."""
        g = self._group.create_group(f"{self._n:07d}")
        g.create_dataset("image", data=np.asarray(image, np.uint8),
                         **self._comp)
        g.create_dataset("mask", data=np.asarray(mask, np.uint8),
                         **self._comp)
        meta = {
            "center": [float(center[0]), float(center[1])],
            "scale_provided": float(scale_provided),
            "joints": np.asarray(joints, np.float64).tolist(),
        }
        if areas is not None:
            meta["areas"] = np.asarray(areas, np.float64).tolist()
        if image_id is not None:
            meta["image_id"] = int(image_id)
        if ignore_regions:
            meta["ignore_regions"] = [
                [float(v) for v in r] for r in ignore_regions
            ]
        g.attrs["meta"] = json.dumps(meta)
        self._n += 1

    def close(self) -> None:
        self._f.attrs["count"] = self._n
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def num_samples(path: str) -> int:
    """Record count without reading any data (shard sizing)."""
    import h5py

    with h5py.File(path, "r") as f:
        return len(f["datum"].keys())


def read_samples(path: str, shuffle_seed: int | None = None) -> Iterator[dict]:
    """Yields raw dicts: image, mask, joints, center, scale_provided, areas.

    Accepts both this framework's group-per-sample layout and the
    upstream lineage's packed-datum layout (see module docstring)."""
    import h5py

    with h5py.File(path, "r") as f:
        group = f["datum"]
        keys = sorted(group.keys())
        if shuffle_seed is not None:
            rng = np.random.default_rng(shuffle_seed)
            keys = list(rng.permutation(keys))
        for k in keys:
            yield parse_record(group[k])


def parse_record(node) -> dict:
    """One HDF5 record (group or upstream packed dataset) -> sample dict.

    Shared by the streaming reader above and the random-access Grain
    source (``data/grain_pipeline.py``)."""
    import h5py

    if isinstance(node, h5py.Dataset):
        return _parse_upstream_datum(node)
    meta = json.loads(node.attrs["meta"])
    joints = np.asarray(meta["joints"], np.float32)
    if "areas" in meta:
        areas = np.asarray(meta["areas"], np.float32)
    else:
        areas = estimate_areas(joints)
    out = {
        "image": np.asarray(node["image"], np.uint8),
        "mask": np.asarray(node["mask"], np.uint8),
        "joints": joints,
        "center": np.asarray(meta["center"], np.float32),
        "scale_provided": np.float32(meta["scale_provided"]),
        "areas": areas,
    }
    # eval-side metadata (newer files); training pipelines
    # select their keys explicitly, so these ride along harmlessly
    if "image_id" in meta:
        out["image_id"] = int(meta["image_id"])
    if "ignore_regions" in meta:
        out["ignore_regions"] = [list(map(float, r))
                                 for r in meta["ignore_regions"]]
    return out


def _coerce_joints(raw: np.ndarray) -> np.ndarray:
    """Upstream joint arrays -> internal (P, 18, 3).

    Handles (18, 3) single person, (P, 18, 3) stacks, and 17-keypoint
    COCO-order rows (converted with a synthesised neck)."""
    arr = np.asarray(raw, np.float64)
    if arr.ndim == 2:
        arr = arr[None]
    if arr.shape[1] == 17:
        from tpupose_torch.data.coco_prep import coco_joints_to_parts

        arr = np.stack(
            [coco_joints_to_parts(p.reshape(-1).tolist()) for p in arr]
        ) if arr.shape[0] else np.zeros((0, 18, 3))
    return arr.astype(np.float32)


def _parse_upstream_datum(ds) -> dict:
    """One upstream packed-datum record -> the raw-sample dict contract."""
    data = np.asarray(ds, np.uint8)
    if data.ndim != 3 or data.shape[2] < 4:
        raise ValueError(
            f"upstream datum must be (H, W, >=4) uint8, got {data.shape}"
        )
    meta = json.loads(ds.attrs["meta"])
    image = data[:, :, :3]
    mask = data[:, :, 3]                      # mask_miss channel (255 = keep)

    if "joints" in meta:
        joints = _coerce_joints(meta["joints"])
    else:
        people = [np.asarray(meta["joint_self"], np.float64)]
        others = meta.get("joint_others") or []
        if isinstance(others, dict):          # some packers index by id
            others = list(others.values())
        people.extend(np.asarray(p, np.float64) for p in others)
        joints = _coerce_joints(np.stack(people)) if people else np.zeros(
            (0, 18, 3), np.float32
        )

    center = meta.get("objpos") or meta.get("center")
    center = np.asarray(center, np.float32).reshape(-1)[:2]

    areas = [meta.get("segment_area")]
    other_areas = meta.get("segment_area_other") or []
    if not isinstance(other_areas, (list, tuple)):
        other_areas = [other_areas]
    areas.extend(other_areas)
    if areas[0] is None or len(areas) != joints.shape[0]:
        areas_arr = estimate_areas(joints)
    else:
        areas_arr = np.asarray(areas, np.float32)

    return {
        "image": image,
        "mask": mask,
        "joints": joints,
        "center": center,
        "scale_provided": np.float32(meta["scale_provided"]),
        "areas": areas_arr,
    }


def estimate_areas(joints: np.ndarray) -> np.ndarray:
    """Bounding-box-based area estimate for records written without GT
    areas (older files): ~0.53 * keypoint-bbox area approximates a
    person's COCO segmentation area. Real areas from ``ann["area"]``
    should always be preferred — OKS is exponential in area."""
    joints = np.asarray(joints, np.float64)
    out = np.zeros((joints.shape[0],), np.float32)
    for i, j in enumerate(joints):
        lab = j[j[:, 2] < 2]
        if len(lab) < 2:
            continue
        bw = lab[:, 0].max() - lab[:, 0].min()
        bh = lab[:, 1].max() - lab[:, 1].min()
        out[i] = 0.53 * bw * bh
    return out


def pad_sample(
    sample: dict, target_h: int, target_w: int, max_persons: int
) -> dict:
    """Fixed-shape sample for the static-shape on-device augmentation.

    Images larger than the target are downscaled to fit (aspect
    preserved) with joints / centre / scale_provided rescaled by the
    same factor, so no content is lost; smaller images are letterboxed
    top-left with gray. Persons are padded to ``max_persons`` with
    absent rows. The reference warps directly from the variable-size
    original (SURVEY.md C11); this is the static-shape equivalent — the
    augmentation's scale term absorbs the fit factor exactly because
    scale_provided is rescaled with the pixels.
    """
    img = sample["image"]
    msk = np.asarray(sample["mask"], np.float32)
    if msk.max() > 1.0:
        msk = msk / 255.0
    h, w = img.shape[:2]

    f = min(target_h / h, target_w / w, 1.0)
    joints_src = np.asarray(sample["joints"], np.float32).copy()
    center = np.asarray(sample["center"], np.float32).copy()
    scale_provided = float(sample["scale_provided"])
    areas_src = np.asarray(
        sample.get("areas", np.zeros((joints_src.shape[0],))), np.float32
    ).copy()
    if f < 1.0:
        import cv2

        nh, nw = max(int(round(h * f)), 1), max(int(round(w * f)), 1)
        img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_AREA)
        msk = cv2.resize(msk, (nw, nh), interpolation=cv2.INTER_LINEAR)
        if joints_src.size:
            joints_src[:, :, :2] *= f
        center *= f
        scale_provided *= f
        areas_src *= f * f          # area scales quadratically with pixels
        h, w = nh, nw

    out_img = np.full((target_h, target_w, 3), 128, np.uint8)
    out_img[:h, :w] = img
    out_msk = np.zeros((target_h, target_w), np.float32)
    out_msk[:h, :w] = msk

    joints = np.full((max_persons, topology.NUM_PARTS, 3), 2.0, np.float32)
    src = joints_src[:max_persons]
    joints[: src.shape[0]] = src
    areas = np.zeros((max_persons,), np.float32)
    areas[: min(len(areas_src), max_persons)] = areas_src[:max_persons]
    off = (
        (joints[:, :, 0] < 0) | (joints[:, :, 0] >= w)
        | (joints[:, :, 1] < 0) | (joints[:, :, 1] >= h)
    )
    joints[:, :, 2] = np.where(off, 2.0, joints[:, :, 2])

    return {
        "image": out_img,
        "mask": out_msk,
        "joints": joints,
        "center": center,
        "scale_provided": np.float32(scale_provided),
        "areas": areas,
    }
