"""Decode composition: per-scale low-res maps -> people tables -> JSON.

Counterpart of ``tpupose/decode/api.py`` (``decode_impl_batch`` on the
scale-space path, and ``to_people``). One full-capacity path: peaks at
``max_peaks`` slots, pair scores on the full K x K grid, greedy accept
over the top min(512, K^2) candidates, assembly into
max(max_people, scan_people_capacity) partial people. The reference's
adaptive tiers and decode groups are bit-identical to this path by
construction, so their config fields change nothing here.
"""

from __future__ import annotations

import numpy as np
import torch

from tpupose import topology
from tpupose.config import InferenceConfig
from tpupose_torch.decode import assemble as _assemble
from tpupose_torch.decode import paf as _paf
from tpupose_torch.decode import peaks as _peaks
from tpupose_torch.decode.scalespace import ScaleSpace
from tpupose_torch.ops.assoc import assoc
from tpupose_torch.ops.pyramid_peaks import pyramid_peak_scores


def decode_impl_batch(heatmaps: ScaleSpace, pafs: ScaleSpace, cfg: InferenceConfig,
                      valid_hw=None) -> dict[str, torch.Tensor]:
    """Batched decode of per-scale (B, Hl, Wl, 19) heat and (B, Hl, Wl,
    38) PAF maps.

    ``valid_hw`` (optional (B, 2) int) restricts peaks to each image's
    top-left rectangle [0, vh) x [0, vw). Returns rows (B, max_people,
    18) int32 global peak ids (part * max_peaks + slot), score, cnt,
    valid per person, and the peak tables peak_xs/peak_ys/peak_scores
    (B, 18, max_peaks) that resolve the ids.
    """
    flats = pyramid_peak_scores(heatmaps, topology.NUM_PARTS, cfg.peak_sigma, cfg.thre1)
    b, c, n = flats.shape
    w = heatmaps.out_hw[1]
    if valid_hw is not None:
        vhw = torch.as_tensor(valid_hw, dtype=torch.int64).to(flats.device)
        lin = torch.arange(n, device=flats.device)
        inside = ((lin // w)[None, :] < vhw[:, :1]) & ((lin % w)[None, :] < vhw[:, 1:])
        flats = torch.where(inside[:, None, :], flats, torch.full_like(flats, -torch.inf))
    k = cfg.max_peaks
    tables = _peaks.peak_tables(flats.reshape(b * c, n), w, k)
    peaks = {key: v.reshape(b, c, k) for key, v in tables.items()}

    prior, ok, n_a, n_b = _paf.pair_scores(
        pafs, peaks, mid_num=cfg.mid_num, thre2=cfg.thre2, min_ratio=cfg.connect_min_ratio)
    ts, ta, tb, sa, sb = _paf.candidates(prior, ok, peaks["scores"], min(512, k * k))
    raw = assoc(ts, ta, tb, sa, sb, torch.minimum(n_a, n_b), k_slots=k,
                n_conn=min(cfg.max_connections, k),
                max_people=max(cfg.max_people, cfg.scan_people_capacity))
    people = _assemble.cull_and_compact(
        raw["rows"], raw["score"], raw["cnt"], raw["active"], raw["stamp"],
        cfg.min_subset_cnt, cfg.min_subset_score)
    return {
        **{key: v[:, : cfg.max_people] for key, v in people.items()},
        "peak_xs": peaks["xs"],
        "peak_ys": peaks["ys"],
        "peak_scores": peaks["scores"],
    }


def to_people(result: dict[str, np.ndarray]) -> list[dict]:
    """One image's tables (numpy) -> the reference's keypoint-JSON contract."""
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
        for p in range(topology.NUM_PARTS):
            pid = int(rows[j, p])
            if pid >= 0:
                kps[topology.PARTS[p]] = {
                    "x": float(xs[pid]),
                    "y": float(ys[pid]),
                    "score": float(ss[pid]),
                }
        people.append(
            {"keypoints": kps, "score": float(score[j]), "num_parts": int(cnt[j])}
        )
    return people
