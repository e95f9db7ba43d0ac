"""The plain PyTorch versions of the port's four kernels against the JAX
functions they stand for, on the CPU, at tiny shapes (same numpy inputs).

  block1         ops/block1.py        vs block1_reference / fused_block1
  pyramid peaks  ops/pyramid_peaks.py vs pyramid_heat_maps + masked_scores
  sample         ops/sample.py        vs scalespace.sample_avg (1e-5)
  assoc          ops/assoc.py         vs paf._greedy_accept + assemble
                                         (bit-equal) / assoc_pallas

The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

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
                                              (2, 16, 0.08, 64), (3, 8, 0.95, 16)])
def test_assoc_plain_bit_equal_to_greedy_and_assemble(seed, k, density, p):
    cfg = InferenceConfig()
    prior, ok, n_a, n_b, scores = _random_problem(seed, 2, k, density)
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
