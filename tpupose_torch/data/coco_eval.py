"""COCO-style keypoint evaluation (OKS AP), dependency-free.

The port's copy of ``tpupose/data/coco_eval.py`` (numpy only; the code
is the reference's, held equal to it by ``tests/test_torch_imports.py``).

The reference quotes COCO AP from the paper and relies on pycocotools
for any actual evaluation (SURVEY.md section 4). pycocotools is absent
here, so this module implements the COCO keypoint metric directly:
object-keypoint-similarity matching, greedy per-image assignment
(highest-scored detections first, as COCOeval does), and AP averaged
over OKS thresholds .50:.05:.95.

Inputs use the framework's people-JSON contract plus COCO-style GT
(per-image list of persons with (17|18, 3) keypoint arrays and areas).
"""

from __future__ import annotations

import numpy as np

from tpupose_torch import topology

# COCO per-keypoint sigmas (17 kps) mapped onto our 18 parts; the
# synthesised neck reuses the shoulder sigma.
_COCO_SIGMAS = {
    "nose": 0.026, "Leye": 0.025, "Reye": 0.025, "Lear": 0.035, "Rear": 0.035,
    "Lsho": 0.079, "Rsho": 0.079, "Lelb": 0.072, "Relb": 0.072,
    "Lwri": 0.062, "Rwri": 0.062, "Lhip": 0.107, "Rhip": 0.107,
    "Lkne": 0.087, "Rkne": 0.087, "Lank": 0.089, "Rank": 0.089,
    "neck": 0.079,
}
SIGMAS = np.asarray([_COCO_SIGMAS[p] for p in topology.PARTS])

OKS_THRESHOLDS = np.arange(0.5, 1.0, 0.05)


def oks(
    pred: np.ndarray, gt: np.ndarray, area: float,
    bbox: "np.ndarray | None" = None,
) -> float:
    """Object keypoint similarity between one (18, 3) prediction
    [x, y, score] and one (18, 3) GT [x, y, v] (v < 2 = labelled).

    When the GT has NO labelled keypoints (a crowd / unannotated-person
    ignore region) pycocotools' computeOks falls back to measuring each
    detection keypoint's clamped distance to the GT box expanded 2x in
    every direction — that is how detections land ON crowd regions and
    match-to-ignore instead of counting as false positives. Reproduced
    here when ``bbox`` ([x, y, w, h]) is given; without a bbox such GT
    scores 0 (nothing to match against)."""
    labelled = gt[:, 2] < 2
    var = (2 * SIGMAS) ** 2
    if not labelled.any():
        if bbox is None:
            return 0.0
        x, y, w, h = (float(v) for v in bbox)
        x0, x1 = x - w, x + 2 * w
        y0, y1 = y - h, y + 2 * h
        dx = np.maximum(0.0, x0 - pred[:, 0]) + np.maximum(0.0, pred[:, 0] - x1)
        dy = np.maximum(0.0, y0 - pred[:, 1]) + np.maximum(0.0, pred[:, 1] - y1)
        e = (dx ** 2 + dy ** 2) / var / (max(area, 1.0) * 2.0)
        return float(np.exp(-e).mean())
    d2 = (pred[:, 0] - gt[:, 0]) ** 2 + (pred[:, 1] - gt[:, 1]) ** 2
    e = d2 / var / (max(area, 1.0) * 2.0)
    return float(np.exp(-e)[labelled].mean())


def people_to_array(people: list[dict]) -> tuple[np.ndarray, np.ndarray]:
    """people JSON -> ((N, 18, 3) keypoints [x, y, present], (N,) scores)."""
    n = len(people)
    kps = np.zeros((n, topology.NUM_PARTS, 3))
    kps[:, :, 2] = 2.0
    scores = np.zeros(n)
    for i, person in enumerate(people):
        for name, v in person["keypoints"].items():
            pi = topology.PART_INDEX[name]
            kps[i, pi] = (v["x"], v["y"], 0.0)
        scores[i] = person["score"]
    return kps, scores


# COCO keypoint evaluation parameters (pycocotools COCOeval.Params for
# iouType='keypoints'): detections capped at 20 per image; area ranges
# all / medium [32^2, 96^2] / large [96^2, 1e5^2].
MAX_DETS = 20
AREA_RNG = {
    "all": (0.0, 1e10),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def detection_area(kps: np.ndarray) -> float:
    """Keypoint-extent bbox area of one (18, 3) detection, exactly as
    pycocotools' ``COCO.loadRes`` computes it for keypoint results:
    the extent spans ALL keypoint slots, INCLUDING absent ones sitting
    at their (0, 0) placeholder. That loadRes quirk stretches the box
    toward the origin for partial detections; it is reproduced here so
    the area-partitioned metrics (AP_M/AP_L/AR_M/AR_L) match what a
    pycocotools summary would report on the same people JSON."""
    xs, ys = kps[:, 0], kps[:, 1]
    return float((xs.max() - xs.min()) * (ys.max() - ys.min()))


def _to_internal(kp) -> np.ndarray:
    kp = np.asarray(kp, np.float64)
    if kp.shape[0] == topology.NUM_PARTS:
        return kp
    if kp.shape[0] == 17:  # COCO order with COCO visibility codes
        from tpupose_torch.data.coco_prep import coco_joints_to_parts

        return coco_joints_to_parts(kp.reshape(-1).tolist())
    raise ValueError(f"GT keypoints must be (17|18, 3), got {kp.shape}")


def _eval_image(scores, ious, dt_areas, gt_areas, arng,
                gt_base_ig=None, gt_crowd=None):
    """COCOeval.evaluateImg for one image / one area range.

    ``scores`` (D,), ``ious`` (D, G) and ``dt_areas`` (D,) are
    precomputed once per image — the area range only affects ignore
    flags, never the similarities (the same hoist COCOeval makes:
    computeIoU runs once, evaluateImg per range). Returns
    (tp (D, T) bool, dt_ig (D, T) bool, npig) with D = min(#dets,
    max_dets) in score order. GT outside the area range are IGNORED:
    they can still absorb a detection (which then counts neither TP nor
    FP), and they don't count toward recall's denominator. Unmatched
    detections whose own (keypoint-extent) area falls outside the range
    are ignored too, exactly as COCOeval does.

    ``gt_base_ig`` (G,) marks GT ignored regardless of area — COCOeval's
    keypoint `_prepare` sets it for ``iscrowd=1`` and ``num_keypoints==0``
    annotations. ``gt_crowd`` (G,) marks crowd GT, which (unlike normal
    GT) may absorb ANY number of detections — COCOeval skips the
    already-matched check for them.
    """
    n_thr = len(OKS_THRESHOLDS)
    n_det = len(scores)
    n_gt = len(gt_areas)
    gt_ig = np.asarray(
        [not (arng[0] <= a <= arng[1]) for a in gt_areas], bool
    )
    if gt_base_ig is not None:
        gt_ig |= np.asarray(gt_base_ig, bool)
    if gt_crowd is None:
        gt_crowd = np.zeros(n_gt, bool)
    # gts sorted ignored-last (stable), COCOeval's gtind
    gt_order = np.argsort(gt_ig, kind="stable")

    tp = np.zeros((n_det, n_thr), bool)
    dt_ig = np.zeros((n_det, n_thr), bool)
    dt_out = ~((arng[0] <= dt_areas) & (dt_areas <= arng[1]))
    for thr_i, thr in enumerate(OKS_THRESHOLDS):
        gt_matched = np.zeros(n_gt, bool)
        for r in range(n_det):
            best_iou = min(thr, 1 - 1e-10)
            m = -1
            for gj in gt_order:
                # crowd GT may be matched repeatedly (COCOeval's
                # `gtm[tind,gind]>0 and not iscrowd[gind]` skip)
                if gt_matched[gj] and not gt_crowd[gj]:
                    continue
                # best match so far is a real gt; later gts are all
                # ignored (sorted last) — stop
                if m > -1 and not gt_ig[m] and gt_ig[gj]:
                    break
                if ious[r, gj] < best_iou:
                    continue
                best_iou = ious[r, gj]
                m = gj
            if m >= 0:
                gt_matched[m] = True
                tp[r, thr_i] = not gt_ig[m]
                dt_ig[r, thr_i] = gt_ig[m]
            else:
                dt_ig[r, thr_i] = dt_out[r]
    npig = int((~gt_ig).sum())
    return tp, dt_ig, npig


def _accumulate(scores, tps, igs, total_gt):
    """COCOeval.accumulate for one area range: 101-point AP per
    threshold + final recall (AR) per threshold."""
    n_thr = len(OKS_THRESHOLDS)
    if total_gt == 0:
        return [-1.0] * n_thr, [-1.0] * n_thr
    rank = sorted(range(len(scores)), key=lambda i: -scores[i])
    # (python sorted is stable: global ties keep per-image insertion
    # order, matching COCOeval's kind='mergesort')
    rec_points = np.linspace(0, 1, 101)
    aps, ars = [], []
    for thr_i in range(n_thr):
        keep = np.asarray([not igs[i][thr_i] for i in rank], bool)
        tp = np.asarray([tps[i][thr_i] for i in rank], bool)[keep]
        if len(tp) == 0:
            aps.append(0.0)
            ars.append(0.0)
            continue
        cum_tp = np.cumsum(tp)
        recall = cum_tp / total_gt
        precision = cum_tp / (np.arange(len(tp)) + 1)
        # COCO 101-point interpolation
        pr = np.maximum.accumulate(precision[::-1])[::-1]
        idxs = np.searchsorted(recall, rec_points, side="left")
        prec_interp = np.asarray(
            [pr[ix] if ix < len(pr) else 0.0 for ix in idxs]
        )
        aps.append(float(prec_interp.mean()))
        ars.append(float(recall[-1]))
    return aps, ars


def image_stats(
    predictions: list[list[dict]],
    gts: list[list[dict]],
    max_dets: int = MAX_DETS,
) -> list[dict]:
    """Per-image match statistics (COCOeval's evaluateImg stage).

    Returns one dict per image: {range_name: (scores, tp, ig, npig)}.
    Matching is per-image and independent across images, so these stats
    can be computed ONCE and pooled over any image subset afterwards —
    ``summarize_stats`` does the pooling, and ``bootstrap`` resamples
    images over the same stats without re-matching."""
    out = []
    for preds, gt_list in zip(predictions, gts):
        gt_kps = [_to_internal(g["keypoints"]) for g in gt_list]
        gt_areas = [float(g.get("area", 1.0)) for g in gt_list]
        gt_crowd = np.asarray(
            [bool(g.get("iscrowd", 0)) for g in gt_list], bool
        )
        # COCOeval keypoint _prepare: ignore = iscrowd or num_keypoints==0
        # (num_keypoints defaults to the labelled count, v < 2 internal)
        gt_nkp = [
            int(g["num_keypoints"]) if "num_keypoints" in g
            else int((kp[:, 2] < 2).sum())
            for g, kp in zip(gt_list, gt_kps)
        ]
        gt_base_ig = gt_crowd | np.asarray([n == 0 for n in gt_nkp], bool)
        gt_bboxes = [g.get("bbox") for g in gt_list]
        det_kps, det_scores = people_to_array(preds)
        # OKS matrix + detection areas once per image (range-independent)
        order = np.argsort(-det_scores, kind="stable")[:max_dets]
        ious = np.zeros((len(order), len(gt_kps)))
        for r, di in enumerate(order):
            for gj in range(len(gt_kps)):
                ious[r, gj] = oks(
                    det_kps[di], gt_kps[gj], gt_areas[gj], bbox=gt_bboxes[gj]
                )
        dt_areas = np.asarray([detection_area(det_kps[di]) for di in order])
        sc = det_scores[order]
        img = {}
        for name, arng in AREA_RNG.items():
            tp, ig, npig = _eval_image(sc, ious, dt_areas, gt_areas, arng,
                                       gt_base_ig=gt_base_ig,
                                       gt_crowd=gt_crowd)
            img[name] = ([float(s) for s in sc], tp, ig, npig)
        out.append(img)
    return out


def summarize_stats(
    stats: list[dict], indices: "np.ndarray | None" = None
) -> dict[str, float]:
    """Pool per-image stats (optionally an index subset, with repeats —
    the bootstrap resample case) into the COCO summary dict."""
    if indices is None:
        indices = range(len(stats))
    per_rng: dict[str, dict] = {
        name: {"scores": [], "tp": [], "ig": [], "ngt": 0}
        for name in AREA_RNG
    }
    for i in indices:
        img = stats[int(i)]
        for name in AREA_RNG:
            sc, tp, ig, npig = img[name]
            acc = per_rng[name]
            acc["scores"].extend(sc)
            acc["tp"].extend(tp)
            acc["ig"].extend(ig)
            acc["ngt"] += npig

    out: dict[str, float] = {}
    for name in AREA_RNG:
        acc = per_rng[name]
        aps, ars = _accumulate(acc["scores"], acc["tp"], acc["ig"], acc["ngt"])
        mean_ap = float(np.mean(aps))
        mean_ar = float(np.mean(ars))
        if name == "all":
            out.update(
                AP=mean_ap, AP50=aps[0], AP75=aps[5],
                AR=mean_ar, AR50=ars[0], AR75=ars[5],
            )
        else:
            suffix = "M" if name == "medium" else "L"
            out[f"AP_{suffix}"] = mean_ap
            out[f"AR_{suffix}"] = mean_ar
    return out


def bootstrap(
    pred_sets: dict[str, list[list[dict]]],
    gts: list[list[dict]],
    n_boot: int = 1000,
    seed: int = 0,
    metric: str = "AP",
    max_dets: int = MAX_DETS,
) -> dict:
    """Paired image-bootstrap of one COCO metric over named prediction
    sets sharing the same GT (the statistical backing for accuracy
    claims — SURVEY §6).

    One image resample (with replacement) per iteration is applied to
    EVERY set, so per-name CIs and any between-set delta CI come from
    the same resamples (paired — differences cancel shared image
    variance). Per-image matching runs once per set; resampling only
    re-pools, so 1000 iterations are cheap.

    Returns {"value": {name: float}, "ci": {name: (lo, hi)},
    "samples": {name: (n_boot,) array}} at the 2.5/97.5 percentiles.
    Delta CI between sets a, b: np.percentile(samples[a] - samples[b],
    [2.5, 97.5]).
    """
    stats = {
        name: image_stats(preds, gts, max_dets)
        for name, preds in pred_sets.items()
    }
    n_img = len(gts)
    rng = np.random.default_rng(seed)
    samples = {name: np.zeros(n_boot) for name in pred_sets}
    for b in range(n_boot):
        idx = rng.integers(0, n_img, n_img)
        for name in pred_sets:
            samples[name][b] = summarize_stats(stats[name], idx)[metric]
    return {
        "value": {
            name: summarize_stats(stats[name])[metric] for name in pred_sets
        },
        "ci": {
            name: tuple(np.percentile(samples[name], [2.5, 97.5]))
            for name in pred_sets
        },
        "samples": samples,
    }


def evaluate(
    predictions: list[list[dict]],
    gts: list[list[dict]],
    max_dets: int = MAX_DETS,
) -> dict[str, float]:
    """Full COCO keypoint metric summary over OKS thresholds .50:.05:.95.

    predictions[i]: people JSON for image i.
    gts[i]: list of {"keypoints": (18, 3) internal-order or (17, 3)
    COCO-order array-like, "area": float, and optionally "iscrowd"
    (0/1), "num_keypoints" (int, defaults to the labelled count) and
    "bbox" ([x, y, w, h])} for image i. 17-keypoint GT is converted
    (neck synthesised from the shoulders).

    Ignore semantics match pycocotools' keypoint `_prepare` exactly: a
    GT with ``iscrowd=1`` or ``num_keypoints==0`` is an ignore region —
    it never counts toward recall, detections matching it count neither
    TP nor FP, crowd regions may absorb any number of detections, and
    keypointless GT matches via the 2x-expanded-bbox OKS fallback (so a
    "bbox" should accompany such annotations; COCO's always have one).

    Returns the standard COCO keypoints summary (pycocotools
    ``COCOeval.summarize`` line set): AP, AP50, AP75, AP_M, AP_L, AR,
    AR50, AR75, AR_M, AR_L. Detections are capped at ``max_dets=20``
    per image (score-descending) like COCOeval; area-partitioned
    metrics follow its gt-ignore semantics. Ranges with no GT report
    -1.0, COCOeval's convention.
    """
    return summarize_stats(image_stats(predictions, gts, max_dets))
