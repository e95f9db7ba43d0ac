"""Greedy skeleton assembly + culling.

Counterpart of ``tpupose/decode/assemble.py``. Accepted limb connections
are folded, limb-major in decode order, into a fixed table of
``max_people`` partial people (rows of 18 global peak ids, running score
and part count, a creation stamp): a connection extends the one row it
matches, merges the two rows it matches if they are disjoint, or seeds a
row at the first free slot (the first 17 decode limbs only; seeds are
dropped once the table is full).
"""

from __future__ import annotations

import torch

from tpupose import topology

BIG_STAMP = 1 << 30
SEED_LIMBS = 17     # the last two decode limbs never seed people


def assemble(conns: dict[str, torch.Tensor], max_people: int) -> dict[str, torch.Tensor]:
    """Fold ``paf.greedy_accept`` tables into the raw people table,
    vectorised over images: rows (B, P, 18) int32, score (B, P) f32, cnt
    (B, P) int32, active (B, P) bool, stamp (B, P) int32 (BIG_STAMP =
    never seeded). Same tie-breaks and f32 addition order as the
    reference's ``lax.scan``."""
    b, n_limbs, _ = conns["pa"].shape
    dev = conns["pa"].device
    pairs = topology.decode_limb_tables()[0]
    p = max_people
    n_valid = conns["n_valid"]
    rows = torch.full((b, p, topology.NUM_PARTS), -1, dtype=torch.int32, device=dev)
    score = torch.zeros((b, p), dtype=torch.float32, device=dev)
    cnt = torch.zeros((b, p), dtype=torch.int32, device=dev)
    active = torch.zeros((b, p), dtype=torch.bool, device=dev)
    stamp = torch.full((b, p), BIG_STAMP, dtype=torch.int32, device=dev)
    next_stamp = torch.zeros((b,), dtype=torch.int32, device=dev)
    ar = torch.arange(b, device=dev)
    ar_p = torch.arange(p, device=dev)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    # only valid connections change the table; visit up to the most any
    # image accepted for each limb (one host sync)
    per_limb = n_valid.amax(dim=0).tolist() if b else [0] * n_limbs
    for l in range(n_limbs):
        ap, bp = int(pairs[l, 0]), int(pairs[l, 1])
        for q in range(per_limb[l]):
            valid = q < n_valid[:, l]
            pa, pb = conns["pa"][:, l, q], conns["pb"][:, l, q]
            cs, sa, sb = conns["cs"][:, l, q], conns["sa"][:, l, q], conns["sb"][:, l, q]

            match = active & ((rows[:, :, ap] == pa[:, None]) | (rows[:, :, bp] == pb[:, None]))
            found = match.sum(dim=-1)
            # the two oldest matching rows (argmin: first minimum)
            j1 = torch.where(match, stamp, BIG_STAMP).argmin(dim=-1)
            j2 = torch.where(match & (ar_p != j1[:, None]), stamp, BIG_STAMP).argmin(dim=-1)
            row1, row2 = rows[ar, j1], rows[ar, j2]
            needs_b = row1[:, bp] != pb
            overlap = ((row1 >= 0) & (row2 >= 0)).any(dim=-1)
            free = active.to(torch.int8).argmin(dim=-1)     # first inactive row
            has_free = ~active[ar, free]

            do_new = valid & (found == 0) & (l < SEED_LIMBS) & has_free
            do_one = valid & (((found == 1) & needs_b) | ((found == 2) & overlap))
            do_merge = valid & (found == 2) & ~overlap

            # extend row j1 with endpoint B
            rows[ar, j1, bp] = torch.where(do_one, pb, rows[ar, j1, bp])
            cnt[ar, j1] = cnt[ar, j1] + do_one.to(torch.int32)
            score[ar, j1] = score[ar, j1] + torch.where(do_one, sb + cs, zero)

            # merge row j2 into row j1 (j1 != j2 whenever found == 2)
            row1, row2 = rows[ar, j1], rows[ar, j2]
            cnt2, score2 = cnt[ar, j2], score[ar, j2]
            rows[ar, j1] = torch.where(do_merge[:, None], torch.where(row2 >= 0, row2, row1), row1)
            cnt[ar, j1] = cnt[ar, j1] + torch.where(do_merge, cnt2, 0)
            score[ar, j1] = score[ar, j1] + torch.where(do_merge, score2 + cs, zero)
            rows[ar, j2] = torch.where(do_merge[:, None], -1, rows[ar, j2])
            cnt[ar, j2] = torch.where(do_merge, 0, cnt[ar, j2])
            score[ar, j2] = torch.where(do_merge, zero, score[ar, j2])
            active[ar, j2] = active[ar, j2] & ~do_merge

            # seed a new row at the first free slot
            new_row = torch.full((b, topology.NUM_PARTS), -1, dtype=torch.int32, device=dev)
            new_row[:, ap] = pa
            new_row[:, bp] = pb
            rows[ar, free] = torch.where(do_new[:, None], new_row, rows[ar, free])
            cnt[ar, free] = torch.where(do_new, 2, cnt[ar, free])
            score[ar, free] = torch.where(do_new, (sa + sb) + cs, score[ar, free])
            active[ar, free] = active[ar, free] | do_new
            stamp[ar, free] = torch.where(do_new, next_stamp, stamp[ar, free])
            next_stamp = next_stamp + do_new.to(torch.int32)
    return {"rows": rows, "score": score, "cnt": cnt, "active": active, "stamp": stamp}


def cull_and_compact(rows, score, cnt, active, stamp, min_cnt: int,
                     min_score: float) -> dict[str, torch.Tensor]:
    """Reference culling (cnt < min_cnt or score/cnt < min_score) +
    compaction of kept rows to the front in creation (stamp) order.
    Supports leading batch dims."""
    keep = active & (cnt >= min_cnt) & (score / torch.clamp(cnt, min=1) >= min_score)
    order = torch.argsort(torch.where(keep, stamp, BIG_STAMP), dim=-1, stable=True)
    return {
        "rows": torch.gather(rows, -2, order[..., None].expand(*order.shape, rows.shape[-1])),
        "score": torch.gather(torch.where(keep, score, 0.0), -1, order),
        "cnt": torch.gather(torch.where(keep, cnt, 0), -1, order),
        "valid": torch.gather(keep, -1, order),
    }
