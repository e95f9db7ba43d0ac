"""The multi-person decode of the OpenPose demo, on the averaged maps.

The stages of CMU's ``demo.ipynb`` / ``testing/python/demo_image.py`` on
full-resolution averaged maps, as the frozen numpy oracle
``tpupose_torch/reference_impl/decode_np.py`` writes them, with its
per-pixel and per-pair loops as tensor operations and the assembly loop
kept as it is:

  * peaks: the sigma-blurred map (scipy ``gaussian_filter``: truncate 4,
    'reflect' borders) is a local maximum against its 4 neighbours (zero
    outside) and above ``thre1``; a peak scores the unblurred value;
  * limbs: the PAF at ``mid_num`` rounded points of every candidate pair,
    dotted with the unit vector; mean plus min(0.5 H / length - 1, 0);
    kept where more than ``connect_min_ratio`` of the points exceed
    ``thre2`` and the score is positive; greedy acceptance in score order,
    each peak used once per limb, at most min(n_a, n_b) connections;
  * assembly: the demo's subset merge and its cull (``min_subset_cnt``,
    ``min_subset_score``).

The configuration's capacities hold here as in the program: at most
``max_peaks`` peaks of a part (where a part of any image of the batch has
more, every part of the batch keeps its strongest, ties lowest index
first; else the scan order), and the greedy acceptance reads the
``min(512, max_peaks**2)`` best candidates of a limb.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from posebench.reference import skeleton


def gaussian_taps(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _reflect_index(n: int, r: int, device) -> torch.Tensor:
    """scipy 'reflect' (d c b a | a b c d | d c b a) source indices."""
    j = torch.arange(-r, n + r, device=device) % (2 * n)
    return torch.where(j < n, j, 2 * n - 1 - j)


def blur(maps: torch.Tensor, sigma: float) -> torch.Tensor:
    """(N, H, W, C) -> its separable gaussian blur, rows first."""
    taps = torch.as_tensor(gaussian_taps(sigma), dtype=torch.float32, device=maps.device)
    r = (taps.numel() - 1) // 2
    n, h, w, c = maps.shape
    x = maps.permute(0, 3, 1, 2).reshape(n * c, 1, h, w)
    x = x.index_select(2, _reflect_index(h, r, maps.device))
    x = F.conv2d(x, taps.view(1, 1, -1, 1))
    x = x.index_select(3, _reflect_index(w, r, maps.device))
    x = F.conv2d(x, taps.view(1, 1, 1, -1))
    return x.reshape(n, c, h, w).permute(0, 2, 3, 1)


def peak_lists(heat: torch.Tensor, cfg: dict, valid=None
               ) -> list[list[tuple[np.ndarray, np.ndarray, np.ndarray]]]:
    """(N, H, W, 19) averaged heat -> per image, per part (xs, ys, scores)
    within the capacity, in the order the capacity rule gives. ``valid``:
    per image (vh, vw), the top-left rectangle of a padded canvas that may
    hold peaks."""
    parts = heat[..., :skeleton.NUM_PARTS].float()
    smooth = blur(parts, cfg["peak_sigma"])
    pad = F.pad(smooth, (0, 0, 1, 1, 1, 1))
    is_peak = ((smooth >= pad[:, :-2, 1:-1]) & (smooth >= pad[:, 2:, 1:-1])
               & (smooth >= pad[:, 1:-1, :-2]) & (smooth >= pad[:, 1:-1, 2:])
               & (smooth > cfg["thre1"]))
    n, h, w, c = parts.shape
    if valid is not None:
        vhw = torch.as_tensor(valid, device=heat.device)
        rows = torch.arange(h, device=heat.device)[None, :, None, None] < vhw[:, 0, None, None, None]
        cols = torch.arange(w, device=heat.device)[None, None, :, None] < vhw[:, 1, None, None, None]
        is_peak = is_peak & rows & cols
    k = cfg["max_peaks"]
    flat_mask = is_peak.permute(0, 3, 1, 2).reshape(n, c, h * w)
    flat_val = parts.permute(0, 3, 1, 2).reshape(n, c, h * w)
    overflow = bool((flat_mask.sum(-1) > k).any())
    out = []
    for i in range(n):
        per_part = []
        for p in range(c):
            idx = torch.nonzero(flat_mask[i, p]).flatten()        # scan order
            val = flat_val[i, p, idx]
            if overflow:
                order = torch.sort(val.double(), descending=True, stable=True).indices
                idx, val = idx[order], val[order]
            idx, val = idx[:k].cpu().numpy(), val[:k].cpu().numpy()
            per_part.append((idx % w, idx // w, val.astype(np.float64)))
        out.append(per_part)
    return out


def limb_connections(paf: torch.Tensor, peaks, cfg: dict, height: int) -> list[np.ndarray]:
    """One image: PAF (H, W, 38) and its peak lists -> per decode limb the
    accepted connections, rows [slot_a, slot_b, score]."""
    dev = paf.device
    m = cfg["mid_num"]
    h, w = paf.shape[:2]
    cap = min(512, cfg["max_peaks"] ** 2)
    t = torch.linspace(0.0, 1.0, m, dtype=torch.float64, device=dev)
    out = []
    for (pa, pb), (cx, cy) in zip(skeleton.DECODE_PART_PAIRS, skeleton.DECODE_PAF_CHANNELS):
        xa, ya, _ = peaks[pa]
        xb, yb, _ = peaks[pb]
        if len(xa) == 0 or len(xb) == 0:
            out.append(np.zeros((0, 3)))
            continue
        ax = torch.as_tensor(xa, dtype=torch.float64, device=dev)[:, None]
        ay = torch.as_tensor(ya, dtype=torch.float64, device=dev)[:, None]
        bx = torch.as_tensor(xb, dtype=torch.float64, device=dev)[None, :]
        by = torch.as_tensor(yb, dtype=torch.float64, device=dev)[None, :]
        vx, vy = bx - ax, by - ay
        norm = torch.sqrt(vx * vx + vy * vy)
        safe = torch.clamp(norm, min=1e-8)
        ux, uy = vx / safe, vy / safe
        mx = torch.round(ax[..., None] + vx[..., None] * t).long().clamp(0, w - 1)
        my = torch.round(ay[..., None] + vy[..., None] * t).long().clamp(0, h - 1)
        px = paf[my, mx, cx].double()
        py = paf[my, mx, cy].double()
        mid = px * ux[..., None] + py * uy[..., None]
        score = mid.mean(-1) + torch.clamp(0.5 * height / safe - 1.0, max=0.0)
        ok = ((mid > cfg["thre2"]).sum(-1) > cfg["connect_min_ratio"] * m) & (score > 0) \
            & (norm > 1e-8)
        flat = torch.where(ok, score, torch.full_like(score, -math.inf)).flatten()
        top, idx = torch.sort(flat, descending=True, stable=True)
        top, idx = top[:cap].cpu().numpy(), idx[:cap].cpu().numpy()
        nb = len(xb)
        limit = min(len(xa), len(xb))
        used_a, used_b, rows = set(), set(), []
        for s, f in zip(top, idx):
            if not np.isfinite(s):
                break
            i, j = divmod(int(f), nb)
            if i in used_a or j in used_b:
                continue
            rows.append((i, j, float(s)))
            used_a.add(i)
            used_b.add(j)
            if len(rows) >= limit:
                break
        out.append(np.asarray(rows, np.float64).reshape(-1, 3))
    return out


def assemble(peaks, connections, cfg: dict) -> list[dict]:
    """The demo's subset assembly and cull -> people in the keypoint-JSON
    contract ({"keypoints": {part: {x, y, score}}, "score", "num_parts"})."""
    offsets = np.cumsum([0] + [len(p[0]) for p in peaks])
    cand = np.concatenate([np.stack([p[0], p[1], p[2]], 1).astype(np.float64)
                           if len(p[0]) else np.zeros((0, 3)) for p in peaks])
    subset = -1 * np.ones((0, 20))
    for k, (index_a, index_b) in enumerate(skeleton.DECODE_PART_PAIRS):
        conn = connections[k]
        if len(conn) == 0:
            continue
        part_as = conn[:, 0] + offsets[index_a]
        part_bs = conn[:, 1] + offsets[index_b]
        for i in range(len(conn)):
            found = 0
            subset_idx = [-1, -1]
            for j in range(len(subset)):
                if subset[j][index_a] == part_as[i] or subset[j][index_b] == part_bs[i]:
                    if found < 2:
                        subset_idx[found] = j
                    found += 1
            if found == 1:
                j = subset_idx[0]
                if subset[j][index_b] != part_bs[i]:
                    subset[j][index_b] = part_bs[i]
                    subset[j][-1] += 1
                    subset[j][-2] += cand[int(part_bs[i]), 2] + conn[i][2]
            elif found == 2:
                j1, j2 = subset_idx
                membership = ((subset[j1] >= 0).astype(int) + (subset[j2] >= 0).astype(int))[:-2]
                if np.count_nonzero(membership == 2) == 0:
                    subset[j1][:-2] += subset[j2][:-2] + 1
                    subset[j1][-2:] += subset[j2][-2:]
                    subset[j1][-2] += conn[i][2]
                    subset = np.delete(subset, j2, 0)
                else:
                    subset[j1][index_b] = part_bs[i]
                    subset[j1][-1] += 1
                    subset[j1][-2] += cand[int(part_bs[i]), 2] + conn[i][2]
            elif not found and k < 17:
                row = -1 * np.ones(20)
                row[index_a] = part_as[i]
                row[index_b] = part_bs[i]
                row[-1] = 2
                row[-2] = cand[int(part_as[i]), 2] + cand[int(part_bs[i]), 2] + conn[i][2]
                subset = np.vstack([subset, row])
    people = []
    for row in subset:
        if row[-1] < cfg["min_subset_cnt"] or row[-2] / row[-1] < cfg["min_subset_score"]:
            continue
        kps = {}
        for p in range(skeleton.NUM_PARTS):
            pid = int(row[p])
            if pid >= 0:
                x, y, s = cand[pid]
                kps[skeleton.PARTS[p]] = {"x": float(x), "y": float(y), "score": float(s)}
        people.append({"keypoints": kps, "score": float(row[-2]), "num_parts": int(row[-1])})
    return people


def decode_batch(heat: torch.Tensor, paf: torch.Tensor, cfg: dict, valid=None
                 ) -> list[list[dict]]:
    """Averaged (N, H, W, 19) heat and (N, H, W, 38) PAF of one device batch
    -> the people of each image (``valid``: see ``peak_lists``)."""
    peaks = peak_lists(heat, cfg, valid)
    height = heat.shape[1]
    return [assemble(pk, limb_connections(paf[i], pk, cfg, height), cfg)
            for i, pk in enumerate(peaks)]
