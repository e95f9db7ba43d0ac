"""The plain PyTorch versions of the port's five kernels against the JAX
functions they stand for, on the CPU, at tiny shapes (same numpy inputs).

  block1         ops/block1.py        vs block1_reference / fused_block1
  pyramid peaks  ops/pyramid_peaks.py vs pyramid_heat_maps + masked_scores
  sample         ops/sample.py        vs scalespace.sample_avg (1e-5)
  assoc          ops/assoc.py         vs paf._greedy_accept + assemble
                                         (bit-equal) / assoc_pallas
  peak tables    ops/peak_tables.py   vs lax.top_k (peak_tables_tiered);
                                         its kernel's selection in numpy

The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupose import topology
from tpupose.config import InferenceConfig
from tpupose.decode import assemble as jasm
from tpupose.decode import paf as jpaf
from tpupose.decode.peaks import masked_scores as j_masked_scores
from tpupose.decode.scalespace import ScaleSpace as JSpace
from tpupose.decode.scalespace import pyramid_heat_maps, sample_avg as j_sample_avg
from tpupose.ops.image import scale_sizes
from tpupose.ops.pallas_assoc import assoc_pallas
from tpupose.ops.pallas_block1 import block1_reference, fused_block1
from tpupose_torch.decode import assemble as tasm
from tpupose_torch.decode import paf as tpaf
from tpupose_torch.decode.scalespace import ScaleSpace as TSpace
from tpupose_torch.ops.assoc import assoc
from tpupose_torch.ops.block1 import block1
from tpupose_torch.ops.pyramid_peaks import pyramid_peak_scores
from tpupose_torch.ops.sample import sample_avg
from tpupose_torch.testing import limit_threads

limit_threads()


def _rand(shape, scale, seed):
    return np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)


def _block1_inputs(n, h, w):
    return (_rand((n, h, w, 3), 0.3, 9), _rand((3, 3, 3, 64), 0.2, 0),
            _rand((64,), 0.1, 1), _rand((3, 3, 64, 64), 0.05, 2), _rand((64,), 0.1, 3))


@pytest.mark.parametrize("shape", [(1, 16, 16), (2, 24, 40)])
def test_block1_plain_matches_reference(shape):
    args = _block1_inputs(*shape)
    truth = np.asarray(block1_reference(*args, dtype=jnp.float32), np.float32)
    ref = np.asarray(block1_reference(*args), np.float32)
    got = block1(*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert got.shape == ref.shape == (shape[0], shape[1] // 2, shape[2] // 2, 64)
    d_ref = np.abs(ref - truth).max()
    assert np.abs(got - truth).max() <= 2 * d_ref + 1e-3
    # one bf16 rounding step apart at most: same ops, another summation order
    np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=1e-2)


def test_block1_plain_matches_pallas_interpret():
    args = _block1_inputs(1, 16, 16)
    truth = np.asarray(block1_reference(*args, dtype=jnp.float32), np.float32)
    pallas = np.asarray(fused_block1(*args, interpret=True), np.float32)
    got = block1(*(torch.from_numpy(a) for a in args)).float().numpy()
    d_pallas = np.abs(pallas - truth).max()
    assert np.abs(got - truth).max() <= 2 * d_pallas + 1e-3
    np.testing.assert_allclose(got, pallas, rtol=2 ** -7, atol=1e-2)


def test_block1_rejects_odd_geometry():
    args = _block1_inputs(1, 15, 16)
    with pytest.raises(ValueError):
        block1(*(torch.from_numpy(a) for a in args))


def _low_maps(rng, sizes, c, batch):
    out = []
    for _, _, ph, pw in sizes:
        m = rng.normal(size=(batch, ph // 8, pw // 8, c)).astype(np.float32)
        m = (m + np.roll(m, 1, 1) + np.roll(m, 1, 2)) / 3.0
        out.append(m * 0.6)
    return out


@pytest.mark.parametrize("hw,scales", [((64, 64), (0.5, 1.0, 1.5, 2.0)),
                                       ((48, 80), (0.5, 1.0, 1.5))])
def test_pyramid_peaks_plain_matches_matrix_path(hw, scales):
    h, w = hw
    sizes = scale_sizes(h, w, scales, 64, 8)
    geoms = [s[:2] for s in sizes]
    maps = _low_maps(np.random.default_rng(4), sizes, 19, 2)
    got = pyramid_peak_scores(TSpace([torch.from_numpy(m) for m in maps], geoms, (h, w)),
                              18, 3.0, 0.1).numpy()
    assert got.shape == (2, 18, h * w)
    for b in range(2):
        space = JSpace([jnp.asarray(m[b, ..., :18]) for m in maps], geoms, (h, w))
        parts, smooth = pyramid_heat_maps(space, 3.0)
        want = np.asarray(j_masked_scores(parts, smooth, 0.1))
        mask = np.isfinite(want)
        assert mask.sum() > 10
        np.testing.assert_array_equal(np.isfinite(got[b]), mask)
        np.testing.assert_allclose(got[b][mask], want[mask], rtol=0, atol=1e-5)


def test_sample_plain_matches_sample_avg():
    rng = np.random.default_rng(5)
    h, w = 72, 56
    sizes = scale_sizes(h, w, (0.5, 1.0, 1.5, 2.0), 64, 8)
    geoms = [s[:2] for s in sizes]
    b, groups, c = 2, 3, 6
    maps = [rng.normal(0, 0.3, (b, ph // 8, pw // 8, c)).astype(np.float32)
            for _, _, ph, pw in sizes]
    chans = np.array([[0, 1], [4, 5], [3, 2]], np.int32)
    iy = rng.integers(0, h, (b, groups, 5, 5, 10)).astype(np.int32)
    ix = rng.integers(0, w, (b, groups, 5, 5, 10)).astype(np.int32)
    iy[:, :, 0, 0, :4] = [0, h - 1, 0, h - 1]     # the image corners
    ix[:, :, 0, 0, :4] = [0, 0, w - 1, w - 1]
    got = sample_avg(TSpace([torch.from_numpy(m) for m in maps], geoms, (h, w)),
                     torch.from_numpy(iy), torch.from_numpy(ix), chans).numpy()
    assert got.shape == (b, groups, 5, 5, 10, 2)
    for i in range(b):
        for g in range(groups):
            space = JSpace([jnp.asarray(m[i][..., chans[g]]) for m in maps], geoms, (h, w))
            want = np.asarray(j_sample_avg(space, jnp.asarray(iy[i, g]), jnp.asarray(ix[i, g])))
            np.testing.assert_allclose(got[i, g], want, rtol=0, atol=1e-5)


def _random_problem(seed, b, k, density):
    rng = np.random.default_rng(seed)
    prior = rng.normal(size=(b, 19, k, k)).astype(np.float32)
    ok = rng.random((b, 19, k, k)) < density
    n_a = rng.integers(1, k + 1, (b, 19)).astype(np.int32)
    n_b = rng.integers(1, k + 1, (b, 19)).astype(np.int32)
    scores = rng.random((b, 18, k)).astype(np.float32)
    return prior, ok, n_a, n_b, scores


def _crowded_problem(k):
    """The pair-score problem of two small crowded scenes (12 people each in
    a 184x328 frame, scale 1.0; ``testing.crowded_scene``), as the port's
    scale-space decode builds it with K = ``k`` peak slots: prior, ok,
    n_a, n_b (B, 19, ...) and the peak scores (B, 18, K), numpy."""
    from tpupose_torch.decode import peaks as tpeaks
    from tpupose_torch.ops.image import scale_sizes as t_scale_sizes
    from tpupose_torch.testing import crowded_scene

    cfg = InferenceConfig()
    frame = (184, 328)
    sizes = t_scale_sizes(*frame, (1.0,), 368, 8)
    geoms = [s[:2] for s in sizes]
    scenes = [crowded_scene(sizes, 12, seed, frame) for seed in (0, 1)]
    heat = TSpace([torch.cat([sc[0][0] for sc in scenes])], geoms, frame)
    pafs = TSpace([torch.cat([sc[1][0] for sc in scenes])], geoms, frame)
    flats = pyramid_peak_scores(heat, 18, cfg.peak_sigma, cfg.thre1)
    pk = {key: v.reshape(2, 18, k)
          for key, v in tpeaks.peak_tables(flats.reshape(36, -1), frame[1], k).items()}
    prior, ok, n_a, n_b = tpaf.pair_scores(pafs, pk, cfg.mid_num, cfg.thre2, cfg.connect_min_ratio)
    return (prior.numpy(), ok.numpy(), n_a.numpy().astype(np.int32),
            n_b.numpy().astype(np.int32), pk["scores"].numpy())


def _problem(seed, k, density):
    """A random problem at ``density``, or the crowded one ("crowd")."""
    if density == "crowd":
        return _crowded_problem(k)
    return _random_problem(seed, 2, k, density)


def _port_people(prior, ok, n_a, n_b, scores, k, cap, p, cfg):
    ts, ta, tb, sa, sb = tpaf.candidates(torch.from_numpy(prior), torch.from_numpy(ok),
                                         torch.from_numpy(scores), cap)
    raw = assoc(ts, ta, tb, sa, sb, torch.minimum(torch.from_numpy(n_a), torch.from_numpy(n_b)),
                k_slots=k, n_conn=k, max_people=p)
    return raw, tasm.cull_and_compact(raw["rows"], raw["score"], raw["cnt"], raw["active"],
                                      raw["stamp"], cfg.min_subset_cnt, cfg.min_subset_score)


def _assert_people_equal(got, want, msg):
    for key in ("valid", "rows", "cnt", "score"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=f"{msg}: {key}")


@pytest.mark.parametrize("seed,k,density,p", [(0, 8, 0.15, 64), (1, 8, 0.6, 64),
                                              (2, 16, 0.08, 64), (3, 8, 0.95, 16),
                                              (4, 16, "crowd", 64)])
def test_assoc_plain_bit_equal_to_greedy_and_assemble(seed, k, density, p):
    """The port's assoc against the JAX package's greedy_all + assemble, on
    random pair scores and on the pair scores of two small crowded scenes
    (12 people each)."""
    cfg = InferenceConfig()
    prior, ok, n_a, n_b, scores = _problem(seed, k, density)
    cap = min(512, k * k)
    _, got = _port_people(prior, ok, n_a, n_b, scores, k, cap, p, cfg)

    def one(pr, o, na, nb, sc):
        conns = jpaf.greedy_all(pr, o, na, nb, k, cap)
        peaks = {"scores": sc, "xs": jnp.zeros((18, k), jnp.int32),
                 "ys": jnp.zeros((18, k), jnp.int32), "valid": jnp.ones((18, k), bool)}
        return jasm.assemble(peaks, conns, max_people=p, min_cnt=cfg.min_subset_cnt,
                             min_score=cfg.min_subset_score)

    want = jax.device_get(jax.vmap(one)(*(jnp.asarray(a) for a in (prior, ok, n_a, n_b, scores))))
    assert np.asarray(want["valid"]).any() or seed == 0
    _assert_people_equal(got, want, f"seed={seed}")


def _chunked_accept(ts, ta, tb, sa, sb, limits, k, n_conn):
    """csrc/assoc.cu's phase 1 in numpy, a limb of an image at a time: 32
    candidates a chunk, each lane tested against the used-slot sets as the
    chunk starts, then the lowest live lane accepted, its slots marked and
    the later lanes that share one of them dropped, until none is live or
    the limit is reached; the walk ends with the chunk that holds the first
    -inf. Returns greedy_accept's tables."""
    from tpupose_torch import topology as ttop

    b, n_limbs, cap = ts.shape
    pairs = ttop.decode_limb_tables()[0]
    out = {key: np.zeros((b, n_limbs, n_conn), dtype)
           for key, dtype in (("pa", np.int32), ("pb", np.int32), ("cs", np.float32),
                              ("sa", np.float32), ("sb", np.float32))}
    out["n_valid"] = np.zeros((b, n_limbs), np.int64)
    for i in range(b):
        for l in range(n_limbs):
            used_a, used_b = np.zeros(k, bool), np.zeros(k, bool)
            n, limit, done, t0 = 0, int(limits[i, l]), int(limits[i, l]) <= 0, 0
            while t0 < cap and not done:
                t = np.arange(t0, min(t0 + 32, cap))
                neg = np.flatnonzero(ts[i, l, t] == -np.inf)
                live = np.isfinite(ts[i, l, t])
                if len(neg):
                    live[neg[0]:] = False
                live &= ~used_a[ta[i, l, t]] & ~used_b[tb[i, l, t]]
                while live.any():
                    src = int(np.flatnonzero(live)[0])
                    a, bb = ta[i, l, t[src]], tb[i, l, t[src]]
                    if n < n_conn:
                        out["pa"][i, l, n] = pairs[l, 0] * k + a
                        out["pb"][i, l, n] = pairs[l, 1] * k + bb
                        for key, table in (("cs", ts), ("sa", sa), ("sb", sb)):
                            out[key][i, l, n] = table[i, l, t[src]]
                    used_a[a] = used_b[bb] = True
                    n += 1
                    if n >= limit:
                        done = True
                        break
                    live &= (np.arange(len(t)) > src) & (ta[i, l, t] != a) & (tb[i, l, t] != bb)
                done = done or len(neg) > 0
                t0 += 32
            out["n_valid"][i, l] = min(n, n_conn)
    return out


@pytest.mark.parametrize("seed,k,density", [(5, 8, 0.3), (6, 16, 0.05), (7, 96, 0.02),
                                            (8, 16, "crowd")])
def test_assoc_chunked_phase1_bit_equal_to_greedy_accept(seed, k, density):
    """The kernel's phase-1 order (chunks of 32, accepts resolved within a
    chunk) against the port's greedy_accept, which walks one candidate at
    a time: the same tables bit for bit, with limits below, at and above
    the candidates, on random pair scores (K = 8, 16, 96; at 96 the 512
    candidates make 16 chunks) and on two crowded scenes."""
    prior, ok, n_a, n_b, scores = _problem(seed, k, density)
    cap = min(512, k * k)
    ts, ta, tb, sa, sb = tpaf.candidates(torch.from_numpy(prior), torch.from_numpy(ok),
                                         torch.from_numpy(scores), cap)
    limits = torch.minimum(torch.from_numpy(n_a), torch.from_numpy(n_b))
    limits[0, :3] = torch.tensor([0, 1, k])
    n_conn = max(k // 2, 1)
    want = tpaf.greedy_accept(ts, ta, tb, sa, sb, limits, k, n_conn)
    got = _chunked_accept(*(t.numpy() for t in (ts, ta, tb, sa, sb, limits)), k, n_conn)
    assert int(want["n_valid"].sum()) > 0
    for key, v in want.items():
        np.testing.assert_array_equal(got[key], v.numpy(), err_msg=key)


_DUP = -2


def _indexed_assemble(conns, k, p, scan_always):
    """csrc/assoc.cu's phase 2 in numpy, an image at a time: a step finds
    its matched rows through the index from peaks to rows, or by a scan
    where the index marks one of its peaks as held by several rows (every
    step with ``scan_always``), and keeps the index as the kernel keeps it.
    Returns assemble's raw table."""
    from tpupose_torch import topology as ttop

    pairs = ttop.decode_limb_tables()[0]
    b, n_limbs, _ = conns["pa"].shape
    out = {"rows": np.full((b, p, 18), -1, np.int32), "score": np.zeros((b, p), np.float32),
           "cnt": np.zeros((b, p), np.int32), "active": np.zeros((b, p), bool),
           "stamp": np.full((b, p), 1 << 30, np.int32)}
    f32 = np.float32
    for i in range(b):
        rows, score, cnt, act, stamp = (out[key][i] for key in
                                        ("rows", "score", "cnt", "active", "stamp"))
        idx = np.full(18 * k, -1, np.int64)
        seeded = next_stamp = 0
        for l in range(n_limbs):
            ap, bp = pairs[l]
            for q in range(int(conns["n_valid"][i, l])):
                pa, pb = int(conns["pa"][i, l, q]), int(conns["pb"][i, l, q])
                cs, sa, sb = (f32(conns[key][i, l, q]) for key in ("cs", "sa", "sb"))
                ra, rb = idx[pa], idx[pb]
                if not scan_always and ra != _DUP and rb != _DUP:
                    match = sorted({r for r in (ra, rb) if r >= 0})
                else:
                    match = [j for j in range(seeded)
                             if act[j] and (rows[j, ap] == pa or rows[j, bp] == pb)]
                if len(match) == 2 and stamp[match[1]] < stamp[match[0]]:
                    match = match[::-1]
                if len(match) in (1, 2):
                    j1, old = match[0], rows[match[0], bp]
                    merge = len(match) == 2 and not ((rows[j1] >= 0) & (rows[match[1]] >= 0)).any()
                    if merge:
                        j2 = match[1]
                        for t in np.flatnonzero(rows[j2] >= 0):
                            rows[j1, t] = rows[j2, t]
                            if idx[rows[j2, t]] == j2:
                                idx[rows[j2, t]] = j1
                        rows[j2] = -1
                        cnt[j1] += cnt[j2]
                        score[j1] = f32(score[j1] + f32(score[j2] + cs))
                        cnt[j2], score[j2], act[j2] = 0, 0.0, False
                    elif len(match) == 2 or old != pb:
                        rows[j1, bp] = pb
                        cnt[j1] += 1
                        score[j1] = f32(score[j1] + f32(sb + cs))
                        if old != pb:
                            if old >= 0 and idx[old] == j1:
                                idx[old] = -1
                            held = len(match) == 2 and rows[match[1], bp] == pb
                            idx[pb] = _DUP if held else j1
                elif not match and l < 17:
                    j = min([j for j in range(seeded) if not act[j]] + [seeded])
                    if j < p:
                        rows[j] = -1
                        rows[j, ap], rows[j, bp] = pa, pb
                        cnt[j], score[j], act[j] = 2, f32(f32(sa + sb) + cs), True
                        stamp[j], next_stamp = next_stamp, next_stamp + 1
                        seeded = max(seeded, j + 1)
                        idx[pa] = idx[pb] = j
    return out


@pytest.mark.parametrize("seed,k,density,p", [(9, 8, 0.6, 64), (10, 96, 0.02, 256),
                                              (11, 8, 0.99, 8), (12, 16, "crowd", 64)])
def test_assoc_indexed_phase2_bit_equal_to_assemble(seed, k, density, p):
    """The kernel's phase-2 order (matched rows from the index, a scan
    where a peak sits in several rows) and its scan on every step, both
    against the port's assemble: the same raw table bit for bit, on random
    pair scores (a full table of 8 rows too) and on two crowded scenes."""
    prior, ok, n_a, n_b, scores = _problem(seed, k, density)
    cap = min(512, k * k)
    ts, ta, tb, sa, sb = tpaf.candidates(torch.from_numpy(prior), torch.from_numpy(ok),
                                         torch.from_numpy(scores), cap)
    limits = torch.minimum(torch.from_numpy(n_a), torch.from_numpy(n_b))
    conns = tpaf.greedy_accept(ts, ta, tb, sa, sb, limits, k, k)
    want = tasm.assemble(conns, p)
    assert int(want["active"].sum()) > 0
    for scan_always in (False, True):
        got = _indexed_assemble({key: v.numpy() for key, v in conns.items()}, k, p, scan_always)
        for key, v in want.items():
            np.testing.assert_array_equal(got[key], v.numpy(), err_msg=f"{key} {scan_always}")


def test_assoc_plain_bit_equal_to_pallas_interpret():
    cfg = InferenceConfig()
    k, p, cap = 8, 32, 64
    prior, ok, n_a, n_b, scores = _random_problem(7, 2, k, 0.5)
    raw, _ = _port_people(prior, ok, n_a, n_b, scores, k, cap, p, cfg)
    part_pairs, _ = topology.decode_limb_tables()
    pp = jnp.asarray(part_pairs)
    flat = jnp.where(jnp.asarray(ok), jnp.asarray(prior), -jnp.inf).reshape(2, 19, k * k)
    ts, idx = jax.lax.top_k(flat, cap)
    ta, tb = idx // k, idx % k
    sc = jnp.asarray(scores)
    sa = jnp.take_along_axis(sc[:, pp[:, 0]], ta, axis=-1)
    sb = jnp.take_along_axis(sc[:, pp[:, 1]], tb, axis=-1)
    want = jax.device_get(assoc_pallas(ts, ta, tb, sa, sb, jnp.minimum(n_a, n_b), k_slots=k,
                                       n_conn=k, max_people=p, interpret=True))
    for key in ("rows", "score", "cnt", "active", "stamp"):
        np.testing.assert_array_equal(raw[key].numpy(), np.asarray(want[key]), err_msg=key)


# --- host-side code of the redesigned kernels: weight packing, tap table ----


def _unpack_block1_weights(w1, w2):
    """HWIO (k1, k2) back from ops.block1.pack_weights' w1 and w2, in bf16."""
    from tpupose_torch.ops.block1 import _ROW_CHANNEL

    k1 = w1.permute(0, 2, 1).reshape(32, 64)[:27].reshape(3, 3, 3, 64)
    k2 = torch.empty((3, 3, 64, 64), dtype=w2.dtype)
    k2[..., torch.as_tensor(_ROW_CHANNEL)] = w2.permute(0, 1, 3, 2).reshape(3, 3, 64, 64)
    return k1, k2


def test_block1_packed_weights_round_trip():
    """pack_weights lays the two kernels out as wgmma B operands
    ([tap][ci // 8][row][ci % 8], conv1_2's rows permuted): unpacking
    gives the HWIO tensors' bf16 values back, every entry of the layout is
    the entry of the HWIO tensor it names, and conv1_1's K pads with zeros."""
    from tpupose_torch.ops import block1 as b1

    k1, c1, k2, c2 = (torch.from_numpy(a) for a in (
        _rand((3, 3, 3, 64), 0.2, 0), _rand((64,), 0.1, 1), _rand((3, 3, 64, 64), 0.05, 2),
        _rand((64,), 0.1, 3)))
    w1, p1, w2, p2 = b1.pack_weights(k1, c1, k2, c2)
    assert w1.shape == (4, 64, 8) and w2.shape == (9, 8, 64, 8)
    assert w1.dtype == w2.dtype == torch.bfloat16 and w1.is_contiguous() and w2.is_contiguous()
    assert torch.equal(p1, c1) and torch.equal(p2, c2) and p1.dtype == torch.float32
    u1, u2 = _unpack_block1_weights(w1, w2)
    assert torch.equal(u1, k1.to(torch.bfloat16)) and torch.equal(u2, k2.to(torch.bfloat16))
    assert sorted(b1._ROW_CHANNEL) == list(range(64))
    rng = np.random.default_rng(4)
    for tap, chunk, row, i in rng.integers(0, (9, 8, 64, 8), (50, 4)):
        want = k2[tap // 3, tap % 3, chunk * 8 + i, b1._ROW_CHANNEL[row]].to(torch.bfloat16)
        assert w2[tap, chunk, row, i] == want
    # a thread's accumulator rows 16 w + g and 16 w + g + 8 are a channel pair,
    # a warp's 16 rows the 16 channels 16 w .. 16 w + 15
    for w in range(4):
        for g in range(8):
            pair = [b1._ROW_CHANNEL[16 * w + g], b1._ROW_CHANNEL[16 * w + g + 8]]
            assert pair == [16 * w + 2 * g, 16 * w + 2 * g + 1]
    flat1 = w1.permute(0, 2, 1).reshape(32, 64)
    assert torch.equal(flat1[:27], k1.to(torch.bfloat16).reshape(27, 64))
    assert not flat1[27:].any()


def test_block1_packed_weights_follow_the_parameters():
    """packed_weights keeps its result while the parameters stand (a view
    of the same storage hits too) and packs anew after an in-place update
    of any of the four."""
    from tpupose_torch.ops import block1 as b1

    conv = torch.from_numpy(_rand((64, 64, 3, 3), 0.05, 2))          # OIHW, as a Conv holds it
    k1, c1, c2 = (torch.from_numpy(a) for a in (
        _rand((3, 3, 3, 64), 0.2, 0), _rand((64,), 0.1, 1), _rand((64,), 0.1, 3)))
    first = b1.packed_weights(k1, c1, conv.permute(2, 3, 1, 0), c2)
    again = b1.packed_weights(k1, c1, conv.permute(2, 3, 1, 0), c2)
    assert all(a is b for a, b in zip(first, again))
    with torch.no_grad():
        conv.mul_(2.0)
    after = b1.packed_weights(k1, c1, conv.permute(2, 3, 1, 0), c2)
    assert after[2] is not first[2]
    assert torch.equal(_unpack_block1_weights(after[0], after[2])[1],
                       conv.permute(2, 3, 1, 0).to(torch.bfloat16))
    c2.add_(1.0)
    assert torch.equal(b1.packed_weights(k1, c1, conv.permute(2, 3, 1, 0), c2)[3], c2)
    other = conv.clone()                                # other storage, same values
    assert b1.packed_weights(k1, c1, other.permute(2, 3, 1, 0), c2)[2] is not after[2]


def test_block1_packed_weights_of_inference_tensors():
    """Inference tensors have no version counter: they are packed on every
    call, rightly after an in-place change, and the first call warns."""
    from tpupose_torch.ops import block1 as b1

    with torch.inference_mode():
        k1, c1, k2, c2 = (torch.from_numpy(a).clone() for a in (
            _rand((3, 3, 3, 64), 0.2, 0), _rand((64,), 0.1, 1), _rand((3, 3, 64, 64), 0.05, 2),
            _rand((64,), 0.1, 3)))
        b1._WARNED_INFERENCE = False
        with pytest.warns(RuntimeWarning, match="inference tensors"):
            first = b1.packed_weights(k1, c1, k2, c2)
        k2.mul_(2.0)
        after = b1.packed_weights(k1, c1, k2, c2)
    assert torch.equal(_unpack_block1_weights(first[0], first[2])[1] * 2,
                       _unpack_block1_weights(after[0], after[2])[1])
    assert torch.equal(_unpack_block1_weights(after[0], after[2])[1], k2.to(torch.bfloat16))


@pytest.mark.parametrize("hw,scales", [((368, 368), (0.5, 1.0, 1.5, 2.0)),
                                       ((48, 80), (0.5, 1.0, 2.0))])
def test_sample_tap_table_matches_axis_taps(hw, scales):
    """The kernel's tap table, built once per geometry on the host, against
    the port's axis_taps and the JAX package's _axis_taps at every
    coordinate of every pyramid geometry and one beyond each edge: indices
    equal, weights bit-equal."""
    from tpupose.decode.scalespace import _axis_taps
    from tpupose_torch.ops import sample as sample_mod

    out_h, out_w = hw
    sizes = scale_sizes(out_h, out_w, scales, 368, 8)
    geoms = [s[:2] for s in sizes]
    low = [(s[2] // 8, s[3] // 8) for s in sizes]
    w, idx = sample_mod.tap_table(geoms, low, hw)
    per_scale = out_h + out_w + 4
    assert w.shape == idx.shape == (len(sizes) * per_scale, 4)
    assert w.dtype == torch.float32 and idx.dtype == torch.int16
    for s, ((rh, rw), (hl, wl)) in enumerate(zip(geoms, low)):
        for first, n, mid, size in ((0, out_h, rh, hl), (out_h + 2, out_w, rw, wl)):
            at = slice(s * per_scale + first, s * per_scale + first + n + 2)
            t_idx, t_w = sample_mod.axis_taps(torch.arange(-1, n + 1), mid, size, n)
            j_idx, j_w = _axis_taps(jnp.arange(-1, n + 1), mid, size, n)
            assert torch.equal(idx[at].to(torch.int32), t_idx)
            assert torch.equal(w[at], t_w)
            np.testing.assert_array_equal(idx[at].numpy(), np.asarray(j_idx))
            np.testing.assert_array_equal(w[at].numpy(), np.asarray(j_w))
            assert int(idx[at].min()) >= 0 and int(idx[at].max()) < size
            # beyond an edge the taps have settled on the edge's pixels (both
            # steps of the chain at one place): a point farther out has the
            # same pixels and, to rounding, the same weight on each
            far_idx, far_w = sample_mod.axis_taps(torch.tensor([-9, n + 9]), mid, size, n)
            ends = w[at][[0, -1]]
            assert torch.equal(idx[at][[0, -1]].to(torch.int32), far_idx)
            assert torch.equal(far_idx[:, :2], far_idx[:, 2:])
            assert (ends[:, :2] + ends[:, 2:] - far_w[:, :2] - far_w[:, 2:]).abs().max() <= 1e-6


def test_sample_tap_table_reproduces_the_plain_readout():
    """The table's layout and the kernel's order of summation (table
    look-up by coordinate + 1, x taps, then y taps, then scales), evaluated
    in torch with separately rounded products and sums, equal
    sample_avg_plain bit for bit, at points one beyond each edge too, and
    one table serves every call of a geometry. The kernel's own arithmetic
    (fused multiply-adds) is held to 1e-5 on the card."""
    from tpupose_torch.ops import sample as sample_mod

    rng = np.random.default_rng(2)
    sizes = scale_sizes(48, 80, (0.5, 1.0, 2.0), 368, 8)
    geoms = [s[:2] for s in sizes]
    maps = [torch.from_numpy(m) for m in _low_maps(rng, sizes, 38, 2)]
    space = TSpace(maps, geoms, (48, 80))
    iy = torch.from_numpy(rng.integers(0, 48, (2, 19, 7)).astype(np.int32))
    ix = torch.from_numpy(rng.integers(0, 80, (2, 19, 7)).astype(np.int32))
    iy[:, :, :2] = torch.tensor([-1, 48], dtype=torch.int32)
    ix[:, :, 1:3] = torch.tensor([80, -1], dtype=torch.int32)
    chans = torch.as_tensor(topology.decode_limb_tables()[1])
    w, idx = sample_mod._device_tap_table(space, "cpu")
    assert sample_mod._device_tap_table(space, "cpu")[0] is w
    acc = torch.zeros((2, 19, 7, 2))
    for s, m in enumerate(maps):
        hl, wl = m.shape[1:3]
        ey = (s * 132 + iy + 1).long()
        ex = (s * 132 + 50 + ix + 1).long()
        pair = m[torch.arange(2)[:, None, None, None, None, None],
                 idx[ey].long()[..., :, None, None], idx[ex].long()[..., None, :, None],
                 chans.long()[None, :, None, None, None, :]]          # (B, L, P, 4, 4, 2)
        v = torch.zeros((2, 19, 7, 2))
        for a in range(4):
            r = torch.zeros((2, 19, 7, 2))
            for e in range(4):
                r = r + w[ex][..., e, None] * pair[..., a, e, :]
            v = v + w[ey][..., a, None] * r
        acc = acc + v
    assert torch.equal(acc / 3.0, sample_mod.sample_avg_plain(space, iy, ix, chans))


@pytest.mark.parametrize("hw,scales,fits", [((368, 368), (0.5, 1.0, 1.5, 2.0), True),
                                            ((496, 656), (0.5, 1.0, 1.5, 2.0), False),
                                            ((496, 656), (1.0,), True),
                                            ((240, 960), (0.5, 1.0, 1.5), False)])
def test_sample_staged_bytes(hw, scales, fits):
    """The shared memory the staged variant asks for, against the 227 KB a
    block of the H100 may opt in to: the pyramid's maps, table and the
    census records of a channel pair fit (198 KB), the 496 x 656 bucket's
    four scales do not."""
    from tpupose_torch.ops import sample as sample_mod

    sizes = scale_sizes(*hw, scales, 368, 8)
    maps = [torch.zeros((1, ph // 8, pw // 8, 38)) for _, _, ph, pw in sizes]
    need = sample_mod.staged_bytes(TSpace(maps, [s[:2] for s in sizes], hw))
    table = len(sizes) * (sum(hw) + 4) * (4 * 4 + 4 * 2)
    records = 2 * 4 * sample_mod.census_words([m.shape[1:3] for m in maps])
    assert need == sum(m[0, :, :, :2].numel() * 4 for m in maps) + table + 32 + records
    assert (need <= 227 * 1024) == fits


# --- host-side code of the redesigned peak kernels: band tables, budgets ----


def _pyramid_shapes(hw, scales):
    sizes = scale_sizes(*hw, scales, 368, 8)
    return tuple((ph // 8, pw // 8, rh, rw) for rh, rw, ph, pw in sizes)


@pytest.mark.parametrize("hw,scales", [((368, 368), (0.5, 1.0, 1.5, 2.0)),
                                       ((368, 368), (1.0,)),
                                       ((496, 656), (0.5, 1.0, 1.5, 2.0)),
                                       ((656, 496), (0.5, 1.0, 1.5, 2.0))])
def test_pyramid_band_tables_are_exact(hw, scales):
    """Each scale's band tables, scattered back, give chain_matrices' f32
    Wy, WxT, Ay and BxT entry for entry (so no non-zero entry lies outside
    a band); starts never decrease and every run fits its axis; each padded
    run of the plain chain lies inside the blurred run of its row (or
    column), so a block that stages the blurred runs holds it. At the
    4-scale pyramid geometry the blurred operators are 4/5/7/8 wide."""
    from tpupose_torch.decode.scalespace import chain_matrices
    from tpupose_torch.ops import pyramid_peaks as pp

    shapes = _pyramid_shapes(hw, scales)
    tables = pp.bands(shapes, hw, 3.0)
    for tab, mats in zip(tables, chain_matrices(shapes, hw, 3.0)):
        for name, mat in zip(("wy", "wx", "ay", "bx"), mats):
            start, coef = tab[name]
            width = coef.shape[0]
            assert start.dtype == np.int32 and coef.dtype == np.float32
            assert (np.diff(start) >= 0).all() and start.min() >= 0
            assert start.max() + width <= mat.shape[1]
            back = np.zeros_like(mat)
            rows = np.arange(mat.shape[0])
            for k in range(width):
                back[rows, start + k] = coef[k]
            np.testing.assert_array_equal(back, mat, err_msg=name)
            if name in ("wx", "bx"):                  # the kernel reads them as WxT, BxT
                np.testing.assert_array_equal(back.T, np.ascontiguousarray(mat.T))
        for inner, outer in (("wy", "ay"), ("wx", "bx")):
            (i_start, i_coef), (o_start, o_coef) = tab[inner], tab[outer]
            assert (i_start >= o_start).all() and (i_start + len(i_coef) <= o_start + len(o_coef)).all()
    if len(scales) == 4 and hw == (368, 368):
        assert [t["ay"][1].shape[0] for t in tables] == [4, 5, 7, 8]
        assert [t["bx"][1].shape[0] for t in tables] == [4, 5, 7, 8]


def _fma(a, b, c):
    """A multiply-add rounded once into f32, as an FMA with f32 operands
    whose exact product f64 holds (0 * x + c == c for every finite x)."""
    return (a.double() * b.double() + c.double()).float()


def _staged_left_products(m, tab, left, h, width_of=None):
    """The kernel's left products of one scale for every output row: per
    block of 16 rows (14 and a halo row each side) the low-res rows it
    stages (the reach of its blurred runs), summed in index order with the
    row's coefficient where the row's run of ``left`` covers the low-res
    row and zero elsewhere. Asserts that the loop of ``left`` stays inside
    the staged rows and that a halo row equals the block before's."""
    from tpupose_torch.ops import pyramid_peaks as pp

    start, coef = (torch.from_numpy(a) for a in tab[left])
    a_start, a_width = tab["ay"][0], len(tab["ay"][1])
    width, wl = coef.shape[0], m.shape[-1]
    lp_rows = {}
    for y0 in range(0, h, pp._OUT_ROWS):
        block = [y for y in range(y0 - 1, y0 + pp._OUT_ROWS + 1) if 0 <= y < h]
        staged = range(int(a_start[block[0]]), int(a_start[block[-1]]) + a_width)
        assert len(staged) <= tab["hcap"]
        reach = range(int(start[block[0]]), int(start[block[-1]]) + width)
        assert staged.start <= reach.start and reach.stop <= staged.stop, (left, y0)
        acc = torch.zeros((*m.shape[:2], len(block), wl))
        for i in reach:
            k = i - start[block]
            a = torch.where((k >= 0) & (k < width),
                            coef[k.clamp(0, width - 1), torch.as_tensor(block)], 0.0)
            acc = _fma(a[:, None], m[:, :, i][:, :, None, :], acc)
        for n, y in enumerate(block):
            if y in lp_rows:                        # a halo row of the block before
                assert torch.equal(lp_rows[y], acc[:, :, n]), y
            lp_rows[y] = acc[:, :, n]
    return torch.stack([lp_rows[y] for y in range(h)], dim=2)


def _staged_columns(tab, right, w):
    """Per output column, its run of ``right`` as offsets into the low-res
    columns its tile of 382 stages (the reach of the blurred runs);
    asserts that every run lies inside."""
    from tpupose_torch.ops import pyramid_peaks as pp

    start, width = tab[right][0], len(tab[right][1])
    b_start, b_width = tab["bx"][0], len(tab["bx"][1])
    for x0 in range(0, w, pp._COL_TILE):
        xa, xb = max(x0 - 1, 0), min(x0 + pp._COL_TILE, w - 1)
        staged = range(int(b_start[xa]), int(b_start[xb]) + b_width)
        assert len(staged) <= tab["wcap"]
        cols = np.arange(xa, xb + 1)
        assert (start[cols] >= staged.start).all(), (right, x0)
        assert (start[cols] + width <= staged.stop).all(), (right, x0)


@pytest.mark.parametrize("hw,boxsize,batch,parts", [((64, 64), 64, 2, 18), ((656, 496), 32, 1, 3)])
def test_pyramid_banded_arithmetic_bit_equal_to_dense(hw, boxsize, batch, parts):
    """The kernel's arithmetic emulated in torch on the CPU: per block of
    16 rows the left products (blurred and plain chain) over the low-res
    rows the block stages, zero coefficients outside each row's band; the
    right product over each column's band; the average from the plain
    chain's left products over each column's 2- or 3-tap band; against the
    dense sums of the first kernel (every low-res row and column, in
    order). Bit for bit equal, halo rows too; against the plain version the
    same mask and values within 1e-5. 2 images at 64x64 and a tall 656x496
    image (the bucket canvas, at boxsize 32), 4 scales: at 656x496 the
    plain chain's runs, padded on the right, once reached past the staged
    rows (the emulation asserts that every run lies inside them)."""
    from tpupose_torch.decode.peaks import masked_scores
    from tpupose_torch.decode.scalespace import chain_matrices
    from tpupose_torch.ops import pyramid_peaks as pp

    h, w = hw
    sizes = scale_sizes(h, w, (0.5, 1.0, 1.5, 2.0), boxsize, 8)
    geoms = [s[:2] for s in sizes]
    low = _low_maps(np.random.default_rng(4), sizes, 19, batch)
    maps = [torch.from_numpy(m[..., :parts]).permute(0, 3, 1, 2) for m in low]  # (B, C, Hl, Wl)
    shapes = tuple((ph // 8, pw // 8, rh, rw) for rh, rw, ph, pw in sizes)
    inv_n = torch.tensor(1.0 / len(maps))
    tables = pp.bands(shapes, (h, w), 3.0)
    dense, banded = {}, {}
    for key in ("avg", "smooth"):
        dense[key] = torch.zeros((batch, parts, h, w))
        banded[key] = torch.zeros((batch, parts, h, w))
    for m, (wy, wx, ay, bx), tab in zip(maps, chain_matrices(shapes, (h, w), 3.0), tables):
        hl, wl = m.shape[2:]
        for key, left, right in (("avg", wy, wx), ("smooth", ay, bx)):
            lt, rt = torch.from_numpy(left), torch.from_numpy(right)
            lp = torch.zeros((batch, parts, h, wl))
            for i in range(hl):
                lp = _fma(lt[:, i][:, None], m[:, :, i][:, :, None, :], lp)
            part = torch.zeros((batch, parts, h, w))
            for j in range(wl):
                part = _fma(lp[..., j:j + 1], rt[:, j], part)
            dense[key] = _fma(part, inv_n, dense[key])
        for key, left, right in (("smooth", "ay", "bx"), ("avg", "wy", "wx")):
            lp = _staged_left_products(m, tab, left, h)
            _staged_columns(tab, right, w)
            cstart, ccoef = (torch.from_numpy(a) for a in tab[right])
            part = torch.zeros((batch, parts, h, w))
            for k in range(ccoef.shape[0]):
                part = _fma(lp[..., cstart + k], ccoef[k], part)
            banded[key] = _fma(part, inv_n, banded[key])
    for key in ("avg", "smooth"):
        assert torch.equal(banded[key], dense[key]), key
    got = masked_scores(banded["avg"].permute(0, 2, 3, 1), banded["smooth"].permute(0, 2, 3, 1),
                        0.1)
    space = TSpace([torch.from_numpy(m) for m in low], geoms, (h, w))
    want = pp.pyramid_peak_scores_plain(space, parts, 3.0, 0.1)
    mask = torch.isfinite(want)
    assert int(mask.sum()) > 10
    assert torch.equal(torch.isfinite(got), mask)
    assert (got[mask] - want[mask]).abs().max().item() <= 1e-5


# the image sizes the estimator meets: every DEFAULT_BUCKETS canvas
# (tpupose_torch/buckets.py) and the common photo and video frames, (h, w)
_ESTIMATOR_HW = ((368, 368), (368, 496), (496, 368), (368, 656), (656, 368), (496, 656),
                 (656, 496), (640, 480), (480, 640), (720, 1280), (1280, 720), (1080, 1920))


@pytest.mark.parametrize("hw,scales", [(hw, scales) for hw in _ESTIMATOR_HW
                                       for scales in ((0.5, 1.0, 1.5, 2.0), (1.0,))]
                         + [((240, 960), (0.5, 1.0, 1.5))])
def test_peak_kernel_budgets_accept_the_main_path(hw, scales):
    """Both wrappers' shared-memory budgets at the geometries the decode
    runs (the pyramid's tables and staged rows take 110 KB at 368x368):
    every bucket canvas and the common frames, portrait and landscape, at
    the four scales and at scale 1.0."""
    from tpupose_torch.decode.peaks import gaussian_kernel1d
    from tpupose_torch.ops import peaks as pk
    from tpupose_torch.ops import pyramid_peaks as pp

    need = pp.smem_bytes(_pyramid_shapes(hw, scales), hw, 3.0)
    assert 0 < need <= 227 * 1024
    if scales == (0.5, 1.0, 1.5, 2.0) and hw == (368, 368):
        assert need == 112428
    r = (len(gaussian_kernel1d(3.0)) - 1) // 2
    assert r == 12 and pk.smem_bytes(r) == 4 * 16 * 18 * 98 <= 227 * 1024


def test_peak_kernel_budgets_reject_what_a_block_cannot_hold():
    """Eight scales up to 7x reach more low-res columns than a block's
    shared memory holds; so do the generic peaks path's rings beyond
    radius 50 (sigma 13). Both raise ValueError. Sigma 4.5 and 6.0 (radius
    18 and 24, past the templated radii) fit."""
    from tpupose_torch.decode.peaks import gaussian_kernel1d
    from tpupose_torch.ops import peaks as pk
    from tpupose_torch.ops import pyramid_peaks as pp

    with pytest.raises(ValueError, match="shared memory"):
        pp.smem_bytes(_pyramid_shapes((368, 368), (0.5, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0)),
                      (368, 368), 3.0)
    radius = {sigma: (len(gaussian_kernel1d(sigma)) - 1) // 2 for sigma in (4.5, 6.0, 13.0)}
    assert radius == {4.5: 18, 6.0: 24, 13.0: 52}
    for sigma in (4.5, 6.0):
        assert 0 < pk.smem_bytes(radius[sigma]) <= 227 * 1024
    assert pk.smem_bytes(16) <= 227 * 1024 and pk.smem_bytes(50) <= 227 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        pk.smem_bytes(radius[13.0])


@pytest.mark.parametrize("seed", [0, 1])
def test_gt_row_boxes_hold_every_pixel_the_exact_tests_pass(seed):
    """ops/gt.reach_rows, the label rows for which the gt kernel lists a
    (part, person) or (limb, person) pair, holds every row where
    create_labels_plain's exact tests pass for that pair: 16 persons of
    random joints on and off the 368-pixel image of the 46x46 grid, person
    0's parts placed on grid columns at the cut-off distance above or below
    a grid row (the Gaussian's last row is the box's edge)."""
    from tpupose_torch.ops import gt as gt_mod

    rng = np.random.default_rng(seed)
    j = np.zeros((16, 18, 3), np.float32)
    j[..., :2] = rng.uniform(-60.0, 428.0, (16, 18, 2))
    j[..., 2] = rng.choice([0.0, 1.0, 2.0], (16, 18), p=[0.6, 0.2, 0.2])
    rad = np.sqrt(4.6052 * 2 * 7.0 ** 2)
    parts = np.arange(18)
    j[0, :, 0] = (parts * 2 + 3) * 8 + 3.5
    j[0, :, 1] = (parts * 2 + 4) * 8 + 3.5 + rad * np.where(parts % 2, 1.0, -1.0)
    j[0, :, 2] = 0.0
    box = gt_mod.reach_rows(j)
    rows = np.arange(46, dtype=np.float32)
    hits = 0
    for q in range(16):
        paf, heat = gt_mod.create_labels_plain(torch.from_numpy(j[q][None, None]),
                                               torch.ones((1, 46, 46)))
        heat_rows = (heat[0, ..., :18] > 0).any(dim=1).numpy()                  # (46, 18)
        band_rows = (paf[0].reshape(46, 46, 19, 2) != 0).any(-1).any(1).numpy()  # (46, 19)
        for name, hit in (("part", heat_rows), ("limb", band_rows)):
            lo, hi = box[f"{name}_lo"][q], box[f"{name}_hi"][q]
            for c in range(hit.shape[1]):
                at = rows[hit[:, c]]
                if len(at):
                    hits += 1
                    assert lo[c] <= at.min() and at.max() <= hi[c], (name, q, c)
    assert hits > 100


def test_pyramid_peaks_plain_matches_pallas_interpret():
    """The plain version against the JAX kernel itself, run in interpret
    mode as tests/test_pallas_pyramid_peaks.py runs it: 64x64, 4 scales,
    one image, the same peak mask and values within 1e-5."""
    from tpupose.ops.pallas_pyramid_peaks import pyramid_peak_scores_pallas

    h = w = 64
    sizes = scale_sizes(h, w, (0.5, 1.0, 1.5, 2.0), 64, 8)
    geoms = tuple(s[:2] for s in sizes)
    maps = _low_maps(np.random.default_rng(11), sizes, 18, 1)
    want = np.asarray(pyramid_peak_scores_pallas(
        tuple(jnp.moveaxis(jnp.asarray(m[0]), -1, 0) for m in maps), geoms, (h, w),
        sigma=3.0, thre1=0.1, interpret=True))
    got = pyramid_peak_scores(TSpace([torch.from_numpy(m) for m in maps], geoms, (h, w)),
                              18, 3.0, 0.1)[0].numpy()
    mask = np.isfinite(want)
    assert mask.sum() > 10
    np.testing.assert_array_equal(np.isfinite(got), mask)
    np.testing.assert_allclose(got[mask], want[mask], rtol=0, atol=1e-5)


# --- the sorted peak tables: the plain version against lax.top_k, the kernel's ---
# --- selection in numpy against the plain version --------------------------------


@functools.lru_cache(maxsize=None)
def _top_k_pair(n: int = 300, w: int = 25, k: int = 96):
    """The adversarial rows with every NaN's sign bit set (the NaN that
    ``0 * inf`` makes, the only one that reaches a peak), through the
    reference's guarded tables (a row overflows, so ``lax.top_k``) and the
    port's, as numpy."""
    from tpupose.decode.peaks import peak_tables_tiered
    from tpupose_torch.decode import peaks as tpeaks
    from tpupose_torch.testing import adversarial_flats

    flat = adversarial_flats(n).numpy()
    bits = flat.view(np.uint32)
    bits[np.isnan(flat)] |= np.uint32(0x80000000)
    assert (np.isfinite(flat).sum(-1) > k).any()
    want = jax.device_get(peak_tables_tiered(jnp.asarray(flat), w, k))
    got = tpeaks.peak_tables(torch.from_numpy(flat), w, k)
    plain = tpeaks.sorted_tables_plain(torch.from_numpy(flat), w, k)
    return flat, {key: np.asarray(v) for key, v in want.items()}, \
        {key: v.numpy() for key, v in got.items()}, {key: v.numpy() for key, v in plain.items()}


@pytest.mark.parametrize("row", range(10))
def test_sorted_tables_plain_matches_lax_top_k(row):
    """Each adversarial row (ties, +-0.0, +-inf, NaN, filler coordinates,
    all NaN, all -inf, ascending) through the port's sorted tables equals
    the reference's ``lax.top_k`` tables, slot for slot, with one
    exception: ``lax.top_k`` ranks +0.0 above -0.0 (the bits' total
    order), the port ranks them equal, lowest index first. Among zeros
    the two hold the same pixels; the port's scores keep each input's
    bits."""
    flat, want, got, plain = _top_k_pair()
    for key in want:
        np.testing.assert_array_equal(got[key][row], plain[key][row], err_msg=key)
    w = 25
    idx = got["ys"][row].astype(np.int64) * w + got["xs"][row]
    zero = want["valid"][row] & (want["scores"][row] == 0)
    assert np.array_equal(zero, got["valid"][row] & (got["scores"][row] == 0))
    for key in want:
        np.testing.assert_array_equal(got[key][row][~zero], want[key][row][~zero], err_msg=key)
    want_idx = want["ys"][row].astype(np.int64) * w + want["xs"][row]
    assert sorted(idx[zero]) == sorted(want_idx[zero]) == list(idx[zero])
    np.testing.assert_array_equal(got["scores"][row].view(np.uint32),
                                  np.where(got["valid"][row], flat[row, idx], 0).view(np.uint32))


_K_SORT, _K_TILE = 4096, 2048     # csrc/peak_tables.cu kSort, kTile


def _image(v: np.ndarray) -> np.ndarray:
    """csrc/peak_tables.cu score_image."""
    b = np.ascontiguousarray(v, np.float32).view(np.uint32).copy()
    nan = (b & 0x7fffffff) > 0x7f800000
    b[b == 0x80000000] = 0
    img = np.where(b & 0x80000000, ~b, b | 0x80000000)
    img[nan] = 0
    return img.astype(np.uint64)


def _select_best(load, n: int, k: int, stage1: bool) -> np.ndarray:
    """csrc/peak_tables.cu select_best: the first k keys sorted, then tiles
    filtered against the threshold (the first stage by the images alone),
    a merge when the buffer could not take another tile, and at the end."""
    top = np.zeros(k, np.uint64)
    first = load(0, min(k, n))
    top[:len(first)] = first
    top = np.sort(top)[::-1]
    buf: list = []
    for base in range(k, n, _K_TILE):
        keys = load(base, min(base + _K_TILE, n))
        thr = top[k - 1]
        beats = (keys >> np.uint64(32)) > (thr >> np.uint64(32)) if stage1 else keys > thr
        buf.extend(keys[beats].tolist())
        assert k + len(buf) <= _K_SORT
        if len(buf) > _K_SORT - k - _K_TILE:
            top = np.sort(np.concatenate([top, np.asarray(buf, np.uint64)]))[::-1][:k]
            buf = []
    if buf:
        top = np.sort(np.concatenate([top, np.asarray(buf, np.uint64)]))[::-1][:k]
    return top


def _kernel_in_numpy(flat: np.ndarray, w: int, k: int, chunks: int) -> dict:
    """csrc/peak_tables.cu's two stages in numpy."""
    rows, n = flat.shape
    chunk_len, k_out = -(-n // chunks), min(n, k)
    out = {"xs": np.zeros((rows, k_out), np.int32), "ys": np.zeros((rows, k_out), np.int32),
           "scores": np.zeros((rows, k_out), np.float32), "valid": np.zeros((rows, k_out), bool)}
    for r in range(rows):
        lists = []
        for c in range(chunks):
            lo = c * chunk_len

            def load(a, b, lo=lo):
                return (_image(flat[r, lo + a:lo + b]) << np.uint64(32)) | (
                    np.uint64(0xffffffff) - np.arange(lo + a, lo + b, dtype=np.uint64))

            lists.append(_select_best(load, max(0, min(chunk_len, n - lo)), k, True))
        lists = np.concatenate(lists)
        top = _select_best(lambda a, b: lists[a:b], len(lists), k, False)[:k_out]
        idx = (np.uint64(0xffffffff) - (top & np.uint64(0xffffffff))).astype(np.int64)
        v = flat[r, idx]
        ok = np.isfinite(v)
        out["xs"][r], out["ys"][r] = idx % w, idx // w
        out["scores"][r], out["valid"][r] = np.where(ok, v, np.float32(0)), ok
    return out


@pytest.mark.parametrize("case", [("adversarial", 2003, 1, 3), ("adversarial", 2003, 96, 1),
                                  ("adversarial", 5003, 96, 40), ("adversarial", 5003, 256, 7),
                                  ("crowded", 64, 8, 3), ("crowded", 50, 96, 4),
                                  ("crowded", 20_003, 16, 5)])
def test_peak_tables_kernel_selection_in_numpy(case):
    """csrc/peak_tables.cu's keys and two-stage selection, written out in
    numpy, give sorted_tables_plain's four outputs bit for bit: ties of
    every kind, NaN of both signs, filler, ascending rows (a merge every
    tile), N < K, and a second stage over more keys than one sort holds."""
    from tpupose_torch.decode.peaks import sorted_tables_plain
    from tpupose_torch.testing import adversarial_flats, crowded_flats

    kind, n, k, chunks = case
    flat = adversarial_flats(n) if kind == "adversarial" else crowded_flats(12, n, seed=n)
    want = sorted_tables_plain(flat, 41, k)
    got = _kernel_in_numpy(flat.numpy(), 41, k, chunks)
    for key, v in want.items():
        v = v.numpy()
        assert got[key].shape == v.shape, key
        np.testing.assert_array_equal(got[key].view(np.uint32) if key == "scores" else got[key],
                                      v.view(np.uint32) if key == "scores" else v, err_msg=key)


def test_cpu_scores_take_the_plain_tables_and_launch_nothing(monkeypatch):
    """A CPU tensor goes through the operator's CPU kernel, the plain
    version: the same tables bit for bit, no kernel built or launched."""
    from tpupose_torch import ops
    from tpupose_torch.decode import peaks as tpeaks
    from tpupose_torch.ops import peak_tables as pt
    from tpupose_torch.testing import crowded_flats

    def refuse():
        raise AssertionError("a CPU tensor built the kernel")

    monkeypatch.setattr(pt.KERNEL, "build", refuse)
    flat = crowded_flats(18, 30_000, seed=2)
    flat[3, 7] = -0.0
    before = ops.launch_counts()
    got = tpeaks.sorted_tables(flat, 200, 96)
    guarded = tpeaks.peak_tables(flat, 200, 96)
    want = tpeaks.sorted_tables_plain(flat, 200, 96)
    assert ops.launch_counts() == before
    assert bool(tpeaks.overflowed(flat, 96))
    for key in want:
        g, gg, w = got[key], guarded[key], want[key]
        if key == "scores":
            g, gg, w = (t.view(torch.int32) for t in (g, gg, w))
        assert torch.equal(g, w) and torch.equal(gg, w), key


def test_chunk_count_fills_the_card_and_keeps_chunks_long():
    """The first stage's split: about 8 blocks an SM where the rows are
    long (an HD and a VGA batch of 8: 8 chunks; one HD image: 59), never a
    chunk under MIN_CHUNK scores, one chunk for short rows."""
    from tpupose_torch.ops import peak_tables as pt

    assert pt.chunk_count(144, 921_600, 132) == 8 and pt.chunk_count(144, 307_200, 132) == 8
    assert pt.chunk_count(18, 921_600, 132) == 59
    assert pt.chunk_count(36, 64, 132) == pt.chunk_count(5000, 921_600, 132) == 1
    for rows, n in ((144, 921_600), (18, 921_600), (8, 20_000), (1, 10 ** 7)):
        c = pt.chunk_count(rows, n, 132)
        assert n // c >= pt.MIN_CHUNK and (rows * c >= 2 * 132 or c == n // pt.MIN_CHUNK)
