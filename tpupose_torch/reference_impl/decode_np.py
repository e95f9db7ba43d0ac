"""NumPy/SciPy multi-person decode twin.

The port's own copy of ``tpupose/reference_impl/decode_np.py``: the
reference's ``demo_image.py::process`` decode stages on averaged
full-resolution heatmaps/PAFs:

  * ``find_peaks_np``   — gaussian-smoothed 4-neighbour NMS peak finding
  * ``score_limbs_np``  — PAF 10-point line-integral scoring + greedy
                          bipartite acceptance per limb
  * ``assemble_np``     — subset rows (18 part slots + score + count),
                          merge/cull, person extraction

Dynamic-shaped, single-threaded, CPU only — by design. It shares no code
with the tensor decode, so it is the independent oracle of
``ops.peaks`` and of the full-res decode wherever scipy is installed.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter

from tpupose_torch import topology
from tpupose_torch.config import InferenceConfig


def find_peaks_np(
    heatmap: np.ndarray, cfg: InferenceConfig | None = None
) -> list[list[tuple[int, int, float, int]]]:
    """Per-part peak lists [(x, y, score, global_id), ...].

    ``heatmap`` is (H, W, 19) float. Peaks are local maxima of the
    sigma-smoothed map against its 4 shifted neighbours, scoring with the
    *unsmoothed* value, thresholded at thre1.
    """
    cfg = cfg or InferenceConfig()
    all_peaks: list[list[tuple[int, int, float, int]]] = []
    peak_counter = 0
    for part in range(topology.NUM_PARTS):
        map_ori = heatmap[:, :, part]
        one_map = gaussian_filter(map_ori, sigma=cfg.peak_sigma)

        map_left = np.zeros_like(one_map)
        map_left[1:, :] = one_map[:-1, :]
        map_right = np.zeros_like(one_map)
        map_right[:-1, :] = one_map[1:, :]
        map_up = np.zeros_like(one_map)
        map_up[:, 1:] = one_map[:, :-1]
        map_down = np.zeros_like(one_map)
        map_down[:, :-1] = one_map[:, 1:]

        peaks_binary = np.logical_and.reduce(
            (
                one_map >= map_left,
                one_map >= map_right,
                one_map >= map_up,
                one_map >= map_down,
                one_map > cfg.thre1,
            )
        )
        ys, xs = np.nonzero(peaks_binary)
        peaks = list(zip(xs.tolist(), ys.tolist()))
        peaks_with_score = [p + (float(map_ori[p[1], p[0]]),) for p in peaks]
        ids = range(peak_counter, peak_counter + len(peaks))
        all_peaks.append(
            [peaks_with_score[i] + (pid,) for i, pid in enumerate(ids)]
        )
        peak_counter += len(peaks)
    return all_peaks


def score_limbs_np(
    paf: np.ndarray,
    all_peaks: list[list[tuple[int, int, float, int]]],
    cfg: InferenceConfig | None = None,
) -> tuple[list[np.ndarray], list[int]]:
    """Greedy-accepted connections per decode-order limb.

    Returns (connection_all, special_k). ``connection_all[k]`` is an
    (n, 5) array of rows [peak_id_a, peak_id_b, score, idx_a, idx_b];
    ``special_k`` lists limbs with no candidates on either end.
    """
    cfg = cfg or InferenceConfig()
    H = paf.shape[0]
    connection_all: list[np.ndarray] = []
    special_k: list[int] = []
    part_pairs, paf_chans = topology.decode_limb_tables()

    for k in range(topology.NUM_LIMBS):
        score_mid = paf[:, :, paf_chans[k]]
        cand_a = all_peaks[part_pairs[k][0]]
        cand_b = all_peaks[part_pairs[k][1]]
        if not cand_a or not cand_b:
            special_k.append(k)
            connection_all.append(np.zeros((0, 5)))
            continue

        connection_candidate = []
        for i, a in enumerate(cand_a):
            for j, b in enumerate(cand_b):
                vec = np.subtract(b[:2], a[:2]).astype(np.float64)
                norm = max(np.sqrt(vec @ vec), 1e-8)
                vec_unit = vec / norm

                mids = list(
                    zip(
                        np.linspace(a[0], b[0], num=cfg.mid_num),
                        np.linspace(a[1], b[1], num=cfg.mid_num),
                    )
                )
                vec_x = np.array(
                    [score_mid[int(round(my)), int(round(mx)), 0] for mx, my in mids]
                )
                vec_y = np.array(
                    [score_mid[int(round(my)), int(round(mx)), 1] for mx, my in mids]
                )
                score_midpts = vec_x * vec_unit[0] + vec_y * vec_unit[1]
                score_with_dist_prior = score_midpts.mean() + min(
                    0.5 * H / norm - 1, 0
                )
                criterion1 = (
                    np.count_nonzero(score_midpts > cfg.thre2)
                    > cfg.connect_min_ratio * cfg.mid_num
                )
                criterion2 = score_with_dist_prior > 0
                if criterion1 and criterion2:
                    connection_candidate.append(
                        (i, j, score_with_dist_prior,
                         score_with_dist_prior + a[2] + b[2])
                    )

        connection_candidate.sort(key=lambda x: x[2], reverse=True)
        connection = np.zeros((0, 5))
        used_a: set[int] = set()
        used_b: set[int] = set()
        for i, j, s, _ in connection_candidate:
            if i not in used_a and j not in used_b:
                connection = np.vstack(
                    [connection, [cand_a[i][3], cand_b[j][3], s, i, j]]
                )
                used_a.add(i)
                used_b.add(j)
                if len(connection) >= min(len(cand_a), len(cand_b)):
                    break
        connection_all.append(connection)
    return connection_all, special_k


def assemble_np(
    all_peaks: list[list[tuple[int, int, float, int]]],
    connection_all: list[np.ndarray],
    special_k: list[int],
    cfg: InferenceConfig | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Merge per-limb connections into people.

    Returns (subset, candidate): subset is (P, 20) rows — 18 global peak
    ids (-1 = missing), total score, part count; candidate is the (N, 4)
    flattened peak table [x, y, score, id].
    """
    cfg = cfg or InferenceConfig()
    part_pairs, _ = topology.decode_limb_tables()
    candidate = np.array(
        [item for sublist in all_peaks for item in sublist], dtype=np.float64
    ).reshape(-1, 4)

    subset = -1 * np.ones((0, 20))
    for k in range(topology.NUM_LIMBS):
        if k in special_k:
            continue
        part_as = connection_all[k][:, 0]
        part_bs = connection_all[k][:, 1]
        index_a, index_b = part_pairs[k]

        for i in range(len(connection_all[k])):
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
                    subset[j][-2] += (
                        candidate[int(part_bs[i]), 2] + connection_all[k][i][2]
                    )
            elif found == 2:
                j1, j2 = subset_idx
                membership = (
                    (subset[j1] >= 0).astype(int) + (subset[j2] >= 0).astype(int)
                )[:-2]
                if np.count_nonzero(membership == 2) == 0:
                    # disjoint -> merge rows
                    subset[j1][:-2] += subset[j2][:-2] + 1
                    subset[j1][-2:] += subset[j2][-2:]
                    subset[j1][-2] += connection_all[k][i][2]
                    subset = np.delete(subset, j2, 0)
                else:
                    subset[j1][index_b] = part_bs[i]
                    subset[j1][-1] += 1
                    subset[j1][-2] += (
                        candidate[int(part_bs[i]), 2] + connection_all[k][i][2]
                    )
            elif not found and k < 17:
                # the last two decode limbs (shoulder->ear) never seed people
                row = -1 * np.ones(20)
                row[index_a] = part_as[i]
                row[index_b] = part_bs[i]
                row[-1] = 2
                row[-2] = (
                    candidate[part_as[i].astype(int), 2]
                    + candidate[part_bs[i].astype(int), 2]
                    + connection_all[k][i][2]
                )
                subset = np.vstack([subset, row])

    keep = [
        j
        for j in range(len(subset))
        if subset[j][-1] >= cfg.min_subset_cnt
        and subset[j][-2] / subset[j][-1] >= cfg.min_subset_score
    ]
    return subset[keep], candidate


def decode_np(
    heatmap: np.ndarray,
    paf: np.ndarray,
    cfg: InferenceConfig | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Full decode: averaged maps -> (subset, candidate)."""
    cfg = cfg or InferenceConfig()
    all_peaks = find_peaks_np(heatmap, cfg)
    connection_all, special_k = score_limbs_np(paf, all_peaks, cfg)
    return assemble_np(all_peaks, connection_all, special_k, cfg)


def people_json(subset: np.ndarray, candidate: np.ndarray) -> list[dict]:
    """Keypoint JSON per person, the reference's output contract."""
    people = []
    for row in subset:
        kps = {}
        for p in range(topology.NUM_PARTS):
            pid = int(row[p])
            if pid >= 0:
                x, y, s, _ = candidate[pid]
                kps[topology.PARTS[p]] = {
                    "x": float(x), "y": float(y), "score": float(s)
                }
        people.append(
            {
                "keypoints": kps,
                "score": float(row[-2]),
                "num_parts": int(row[-1]),
            }
        )
    return people
