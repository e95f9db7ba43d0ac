"""Decode composition: averaged maps -> people tables -> JSON.

Counterpart of ``tpupose/decode/api.py`` (``decode_impl``,
``decode_impl_batch``, ``decode_maps[_batch]`` and ``to_people``). The
heat and PAF inputs are each either a materialised full-res map or a
``ScaleSpace`` of per-scale low-res network outputs, and may be mixed:
a full-res heat map goes through ``ops.peaks`` and a full-res PAF is
indexed at the sample points; a ``ScaleSpace`` goes through
``ops.pyramid_peaks`` and ``ops.sample`` and is never upsampled.

One full-capacity path: peaks at ``max_peaks`` slots, pair scores on the
full K x K grid, greedy accept over the top min(512, K^2) candidates,
assembly into max(max_people, scan_people_capacity) partial people. The
reference's adaptive tiers and decode groups are bit-identical to this
path by construction, so their config fields change nothing here.

Every function takes the ``skeleton`` of the maps (``skeletons.COCO18``
by default; ``skeletons.BODY25``): its parts are the heat channels that
hold peaks, its limbs the PAF channel pairs read and the decode order.
"""

from __future__ import annotations

import numpy as np
import torch

from tpupose_torch.config import InferenceConfig
from tpupose_torch.decode import assemble as _assemble
from tpupose_torch.decode import paf as _paf
from tpupose_torch.decode import peaks as _peaks
from tpupose_torch.decode.scalespace import ScaleSpace
# the kernel modules, not their functions: ``ops.assoc`` imports this
# package's ``assemble`` and ``paf``, so either may be half-imported here
from tpupose_torch.ops import assoc as _assoc_op
from tpupose_torch.ops import peaks as _peaks_op
from tpupose_torch.ops import pyramid_peaks as _pyramid_op
from tpupose_torch.skeletons import COCO18, Skeleton


def peak_scores_batch(heatmaps, cfg: InferenceConfig, valid_hw=None,
                      skeleton: Skeleton = COCO18) -> tuple[torch.Tensor, int]:
    """The first half of ``decode_impl_batch``: the masked peak scores
    (B, parts, H*W) of the heat maps (full-res or a ScaleSpace), -inf
    off-peak and outside each image's ``valid_hw`` rectangle, and the map
    width."""
    parts = skeleton.num_parts
    if isinstance(heatmaps, ScaleSpace):
        flats = _pyramid_op.pyramid_peak_scores(heatmaps, parts, cfg.peak_sigma, cfg.thre1)
        w = heatmaps.out_hw[1]
    else:
        flats = _peaks_op.peak_scores(heatmaps, parts, cfg.peak_sigma, cfg.thre1)
        w = heatmaps.shape[2]
    b, c, n = flats.shape
    if valid_hw is not None:
        vhw = torch.as_tensor(valid_hw, dtype=torch.int64).to(flats.device)
        lin = torch.arange(n, device=flats.device)
        inside = ((lin // w)[None, :] < vhw[:, :1]) & ((lin % w)[None, :] < vhw[:, 1:])
        flats = torch.where(inside[:, None, :], flats, torch.full_like(flats, -torch.inf))
    return flats, w


def decode_scores_batch(flats: torch.Tensor, w: int, pafs, cfg: InferenceConfig,
                        overflow: bool | None = None,
                        skeleton: Skeleton = COCO18) -> dict[str, torch.Tensor]:
    """The second half of ``decode_impl_batch``: peak tables, pair scores,
    association and assembly from ``peak_scores_batch``'s output.
    ``overflow`` forces the peak tables' order (``decode.peaks.peak_tables``)
    where the caller decided it over a larger batch; None decides it over
    these images."""
    b, c, n = flats.shape
    k = cfg.max_peaks
    tables = _peaks.peak_tables(flats.reshape(b * c, n), w, k, overflow)
    peaks = {key: v.reshape(b, c, k) for key, v in tables.items()}

    prior, ok, n_a, n_b = _paf.pair_scores(
        pafs, peaks, mid_num=cfg.mid_num, thre2=cfg.thre2, min_ratio=cfg.connect_min_ratio,
        skeleton=skeleton)
    ts, ta, tb, sa, sb = _paf.candidates(prior, ok, peaks["scores"], min(512, k * k), skeleton)
    raw = _assoc_op.assoc(ts, ta, tb, sa, sb, torch.minimum(n_a, n_b), k_slots=k,
                          n_conn=min(cfg.max_connections, k),
                          max_people=max(cfg.max_people, cfg.scan_people_capacity),
                          skeleton=skeleton)
    people = _assemble.cull_and_compact(
        raw["rows"], raw["score"], raw["cnt"], raw["active"], raw["stamp"],
        cfg.min_subset_cnt, cfg.min_subset_score)
    return {
        **{key: v[:, : cfg.max_people] for key, v in people.items()},
        "peak_xs": peaks["xs"],
        "peak_ys": peaks["ys"],
        "peak_scores": peaks["scores"],
    }


def decode_impl_batch(heatmaps, pafs, cfg: InferenceConfig, valid_hw=None,
                      skeleton: Skeleton = COCO18) -> dict[str, torch.Tensor]:
    """Batched decode. ``heatmaps``: (B, H, W, 19) or a ScaleSpace of
    (B, Hl, Wl, 19) maps; ``pafs``: (B, H, W, 38) or a ScaleSpace of
    (B, Hl, Wl, 38) maps.

    ``valid_hw`` (optional (B, 2) int) restricts peaks to each image's
    top-left rectangle [0, vh) x [0, vw). Returns rows (B, max_people,
    18) int32 global peak ids (part * max_peaks + slot), score, cnt,
    valid per person, and the peak tables peak_xs/peak_ys/peak_scores
    (B, 18, max_peaks) that resolve the ids.
    """
    flats, w = peak_scores_batch(heatmaps, cfg, valid_hw, skeleton)
    return decode_scores_batch(flats, w, pafs, cfg, skeleton=skeleton)


def decode_impl(heatmap, paf, cfg: InferenceConfig,
                skeleton: Skeleton = COCO18) -> dict[str, torch.Tensor]:
    """One image's decode: (H, W, 19) / (H, W, 38) maps, or ScaleSpaces of
    (Hl, Wl, C) maps, or one of each -> the tables of
    ``decode_impl_batch`` without the batch axis."""
    def batched(m):
        return m.map_scales(lambda t: t[None]) if isinstance(m, ScaleSpace) else m[None]

    out = decode_impl_batch(batched(heatmap), batched(paf), cfg, skeleton=skeleton)
    return {key: v[0] for key, v in out.items()}


# the reference's public names (jitted there; eager here)
decode_maps = decode_impl
decode_maps_batch = decode_impl_batch


def to_people(result: dict[str, np.ndarray], skeleton: Skeleton = COCO18) -> list[dict]:
    """One image's tables (numpy) -> the reference's keypoint-JSON contract,
    keypoints named by the skeleton's parts."""
    rows = np.asarray(result["rows"])
    score = np.asarray(result["score"])
    cnt = np.asarray(result["cnt"])
    valid = np.asarray(result["valid"])
    xs = np.asarray(result["peak_xs"]).reshape(-1)
    ys = np.asarray(result["peak_ys"]).reshape(-1)
    ss = np.asarray(result["peak_scores"]).reshape(-1)

    people = []
    for j in range(rows.shape[0]):
        if not valid[j]:
            continue
        kps = {}
        for p, part in enumerate(skeleton.parts):
            pid = int(rows[j, p])
            if pid >= 0:
                kps[part] = {
                    "x": float(xs[pid]),
                    "y": float(ys[pid]),
                    "score": float(ss[pid]),
                }
        people.append(
            {"keypoints": kps, "score": float(score[j]), "num_parts": int(cnt[j])}
        )
    return people
