"""PAF line-integral limb scoring + greedy connection accept.

Counterpart of ``tpupose/decode/paf.py``: every candidate (A, B) peak
pair of every limb is scored by sampling the limb's PAF channel pair at
``mid_num`` rounded, clipped points along the segment, dotted with the
unit direction; a pair passes if more than ``min_ratio`` of the samples
exceed ``thre2`` and the distance-priored mean is positive. All images
and limbs go through one batched call. The two readouts differ only in
where a point's value comes from: a ``ScaleSpace`` of low-res maps is
evaluated at the points (``ops.sample``), a materialised full-res map is
indexed there (``paf[iy, ix]``).
"""

from __future__ import annotations

import torch

from tpupose_torch.decode.scalespace import ScaleSpace
from tpupose_torch.ops.sample import sample_avg
from tpupose_torch.skeletons import COCO18, Skeleton


def sample_fullres(paf: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                   chans) -> torch.Tensor:
    """``paf[b, iy, ix, chans[l]]``: (B, H, W, C) map, int (B, L, *S)
    points, (L, 2) channel pairs -> (B, L, *S, 2) f32."""
    b, n_limbs = iy.shape[:2]
    lead = (1,) * (iy.dim() - 2)
    bi = torch.arange(b, device=paf.device).view(b, 1, *lead, 1)
    ch = torch.as_tensor(chans, dtype=torch.int64, device=paf.device).view(1, n_limbs, *lead, 2)
    return paf[bi, iy[..., None].to(torch.int64), ix[..., None].to(torch.int64), ch].to(
        torch.float32)


def limb_points(peaks: dict[str, torch.Tensor], out_hw, mid_num: int = 10,
                skeleton: Skeleton = COCO18):
    """The sample points of every candidate pair of every limb.

    peaks: (B, parts, K) tables. Returns (iy, ix, ux, uy, norm): int32 (B,
    limbs, K, K, mid_num) rounded, clipped points along each A -> B
    segment, and per pair (B, limbs, K, K) the unit direction and the
    length, in the skeleton's decode limb order. Empty peak slots hold
    (0, 0), so their pairs' points all coincide.
    """
    part_pairs, _ = skeleton.limb_tables()
    pairs = torch.as_tensor(part_pairs, dtype=torch.int64, device=peaks["xs"].device)
    out_h, out_w = out_hw
    axf, ayf = (peaks[k][:, pairs[:, 0]].to(torch.float32) for k in ("xs", "ys"))   # (B, L, K)
    bxf, byf = (peaks[k][:, pairs[:, 1]].to(torch.float32) for k in ("xs", "ys"))
    dx = bxf[..., None, :] - axf[..., :, None]     # (B, L, K, K)
    dy = byf[..., None, :] - ayf[..., :, None]
    norm = torch.sqrt(dx * dx + dy * dy)
    norm_safe = torch.clamp(norm, min=1e-8)

    # built on the CPU, where it equals jnp.linspace bit for bit
    t = torch.linspace(0.0, 1.0, mid_num, dtype=torch.float32).to(dx.device)
    my = ayf[..., :, None, None] + dy[..., None] * t   # (B, L, K, K, M)
    mx = axf[..., :, None, None] + dx[..., None] * t
    iy = torch.clamp(torch.round(my).to(torch.int32), 0, out_h - 1)
    ix = torch.clamp(torch.round(mx).to(torch.int32), 0, out_w - 1)
    return iy, ix, dx / norm_safe, dy / norm_safe, norm


def pair_scores(paf, peaks: dict[str, torch.Tensor], mid_num: int = 10,
                thre2: float = 0.05, min_ratio: float = 0.8, skeleton: Skeleton = COCO18):
    """All-limb pair tables of a batch.

    paf: a materialised (B, H, W, C) map, or a ScaleSpace of per-scale
    (B, Hl, Wl, C) maps (C: the skeleton's PAF channels, 38 for COCO-18);
    peaks: (B, parts, K) tables. Returns (prior (B, L, K, K) f32, ok (B, L,
    K, K) bool, n_a (B, L), n_b (B, L)) in the skeleton's decode limb order.
    """
    part_pairs, paf_chans = skeleton.limb_tables()
    pairs = torch.as_tensor(part_pairs, dtype=torch.int64, device=peaks["xs"].device)
    scale_space = isinstance(paf, ScaleSpace)
    out_h, out_w = paf.out_hw if scale_space else paf.shape[1:3]
    height = float(out_h)
    av = peaks["valid"][:, pairs[:, 0]]     # (B, L, K)
    bv = peaks["valid"][:, pairs[:, 1]]
    iy, ix, ux, uy, norm = limb_points(peaks, (out_h, out_w), mid_num, skeleton)
    norm_safe = torch.clamp(norm, min=1e-8)
    sample = sample_avg if scale_space else sample_fullres
    sampled = sample(paf, iy, ix, paf_chans)           # (B, L, K, K, M, 2)
    score_mid = sampled[..., 0] * ux[..., None] + sampled[..., 1] * uy[..., None]

    mean = score_mid.mean(dim=-1)
    prior = mean + torch.clamp(0.5 * height / norm_safe - 1.0, max=0.0)
    crit1 = (score_mid > thre2).sum(dim=-1) > min_ratio * mid_num
    ok = (
        crit1
        & (prior > 0)
        & av[..., :, None]
        & bv[..., None, :]
        & (norm > 1e-8)
    )
    return prior, ok, av.sum(dim=-1).to(torch.int32), bv.sum(dim=-1).to(torch.int32)


def candidates(prior, ok, scores, cap: int, skeleton: Skeleton = COCO18):
    """Top-``cap`` candidate pairs per limb, score-descending, ties lowest
    flat index first (``lax.top_k`` order).

    Returns (ts, ta, tb, sa, sb), each (B, L, cap): prior (-inf where not
    ok), A slot, B slot and the two endpoint peak scores.
    """
    b, n_limbs, k, _ = prior.shape
    part_pairs, _ = skeleton.limb_tables()
    flat = torch.where(ok, prior, torch.full_like(prior, -torch.inf)).reshape(b, n_limbs, k * k)
    ts, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    ts, idx = ts[..., :cap], idx[..., :cap]
    ta = idx // k
    tb = idx % k
    # columns copied out: under torch.export each becomes a constant of its own
    pa = torch.as_tensor(part_pairs[:, 0].copy(), dtype=torch.int64, device=scores.device)
    pb = torch.as_tensor(part_pairs[:, 1].copy(), dtype=torch.int64, device=scores.device)
    sa = torch.gather(scores[:, pa], -1, ta)
    sb = torch.gather(scores[:, pb], -1, tb)
    return ts, ta.to(torch.int32), tb.to(torch.int32), sa, sb


def greedy_accept(ts, ta, tb, sa, sb, limits, k_slots: int, n_conn: int,
                  skeleton: Skeleton = COCO18):
    """Greedy accept over score-sorted candidates, all images and limbs in
    lockstep (the reference's ``_greedy_accept`` per limb).

    A candidate is accepted when its score is finite, neither endpoint
    slot is used yet and the limb has accepted fewer than ``limits``;
    accepted connections fill slots 0.. of the limb's table in order
    (at most ``n_conn`` kept). Returns the tables: pa/pb (B, L, n_conn)
    int32 global peak ids (part * k_slots + slot), cs/sa/sb f32
    (connection prior, endpoint peak scores) and n_valid (B, L) int64.
    """
    b, n_limbs, cap = ts.shape
    dev = ts.device
    pairs = skeleton.limb_tables()[0]
    ap_k = torch.as_tensor(pairs[:, 0], device=dev).to(torch.int32) * k_slots
    bp_k = torch.as_tensor(pairs[:, 1], device=dev).to(torch.int32) * k_slots
    ib = torch.arange(b, device=dev)[:, None]
    il = torch.arange(n_limbs, device=dev)[None, :]
    used_a = torch.zeros((b, n_limbs, k_slots), dtype=torch.bool, device=dev)
    used_b = torch.zeros_like(used_a)
    nacc = torch.zeros((b, n_limbs), dtype=torch.int64, device=dev)
    conn = {
        key: torch.zeros((b, n_limbs, n_conn), dtype=dtype, device=dev)
        for key, dtype in (("pa", torch.int32), ("pb", torch.int32), ("cs", torch.float32),
                           ("sa", torch.float32), ("sb", torch.float32))
    }
    lim = limits.to(torch.int64)
    finite = torch.isfinite(ts)
    # the candidates are sorted, so the scan can stop after the last finite one
    steps = int((finite * torch.arange(1, cap + 1, device=dev)).amax()) if ts.numel() else 0
    for t in range(steps):
        ai = ta[..., t].to(torch.int64)
        bi = tb[..., t].to(torch.int64)
        hit_a = used_a[ib, il, ai]
        hit_b = used_b[ib, il, bi]
        accept = finite[..., t] & ~hit_a & ~hit_b & (nacc < lim)
        used_a[ib, il, ai] = hit_a | accept
        used_b[ib, il, bi] = hit_b | accept
        write = accept & (nacc < n_conn)
        slot = nacc.clamp(max=n_conn - 1)
        new = {
            "pa": ap_k + ai.to(torch.int32), "pb": bp_k + bi.to(torch.int32),
            "cs": ts[..., t], "sa": sa[..., t], "sb": sb[..., t],
        }
        for key, table in conn.items():
            table[ib, il, slot] = torch.where(write, new[key], table[ib, il, slot])
        nacc = nacc + accept.to(torch.int64)
    conn["n_valid"] = nacc.clamp(max=n_conn)
    return conn
