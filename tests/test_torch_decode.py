"""Port decode (tpupose_torch.decode.api.decode_impl_batch) against the
reference's decode_impl_batch on scale-space inputs.

Planted two-person scenes (``tpupose_torch.testing.planted_scene``, the
tests/test_scalespace.py ``_scene`` recipe), a small crowd
(``testing.crowded_scene``), random smooth fields (with the valid_hw
margin mask) and a peak-capacity overflow: integer tables equal, float
fields within 1e-4.
The reference runs its adaptive tiers; the port one full-capacity path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpupose.config import InferenceConfig
from tpupose.decode.api import decode_impl_batch as j_decode
from tpupose.decode.scalespace import ScaleSpace as JSpace
from tpupose.ops.image import scale_sizes
from tpupose_torch.decode.api import decode_impl_batch as t_decode
from tpupose_torch.decode.api import to_people
from tpupose_torch.decode.scalespace import ScaleSpace as TSpace
from tpupose_torch.ops.pyramid_peaks import pyramid_peak_scores
from tpupose_torch.testing import crowded_scene, limit_threads, planted_scene

limit_threads()

# max_peaks=16 with an 8-slot compaction tier keeps the reference's
# batch-global overflow guard active (it runs only when a tier exists)
CFG = InferenceConfig(max_peaks=16, peak_compact_tiers=(8,))


def _random_fields(rng, sizes, batch):
    def one(c):
        out = []
        for _, _, ph, pw in sizes:
            m = rng.normal(size=(batch, ph // 8, pw // 8, c)).astype(np.float32)
            out.append((m + np.roll(m, 1, 1) + np.roll(m, 1, 2)) / 3.0 * 0.6)
        return out
    return one(19), one(38)


def _run_both(heats, pafs, sizes, out_hw, cfg, valid_hw=None, culled_rows_as_set=False,
              reference=j_decode):
    """Both decodes on the same maps: every table equal (floats within
    1e-4). With ``culled_rows_as_set`` the rows that the cull drops (after
    the kept ones) are compared as a set of rows, not in order.
    ``reference`` is the JAX decode run: eager by default, or a jitted one."""
    geoms = [s[:2] for s in sizes]
    want = jax.device_get(reference(
        JSpace([jnp.asarray(m) for m in heats], geoms, out_hw),
        JSpace([jnp.asarray(m) for m in pafs], geoms, out_hw), cfg,
        None if valid_hw is None else jnp.asarray(valid_hw)))
    got = t_decode(TSpace([torch.from_numpy(m) for m in heats], geoms, out_hw),
                   TSpace([torch.from_numpy(m) for m in pafs], geoms, out_hw), cfg,
                   None if valid_hw is None else torch.from_numpy(valid_hw))
    assert set(got) == set(want)
    for key in want:
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape, key
        if key == "rows" and culled_rows_as_set:
            kept = np.asarray(want["valid"])
            np.testing.assert_array_equal(got["valid"].numpy(), kept)
            np.testing.assert_array_equal(g[kept], w[kept], err_msg=key)
            for gi, wi, ki in zip(g, w, kept):
                assert sorted(map(tuple, gi[~ki])) == sorted(map(tuple, wi[~ki])), key
        elif w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)
    return got


def test_planted_two_person_scenes():
    sizes = scale_sizes(368, 368, (0.5, 1.0, 1.5, 2.0), 368, 8)
    scenes = [planted_scene(sizes, seed) for seed in (11, 12)]
    heats = [np.concatenate([s[0][i].numpy() for s in scenes]) for i in range(len(sizes))]
    pafs = [np.concatenate([s[1][i].numpy() for s in scenes]) for i in range(len(sizes))]
    got = _run_both(heats, pafs, sizes, (368, 368), CFG)
    for b in range(2):
        people = to_people({k: v[b].numpy() for k, v in got.items()})
        assert len(people) == 2
        assert all(p["num_parts"] == 18 for p in people)


def test_crowded_scene():
    """12 people in a 184x328 frame at two scales: the port's decode equals
    the reference's and finds every one of them, each with 15 or more
    parts. The people of the scene are drawn alike, so two candidates of a
    limb can have pair priors one ulp apart, which the two frameworks round
    differently (the priors' contract is 1e-5): two nose-eye seeds then
    trade places. Both seeds are culled, so the culled rows are compared as
    a set and every kept row in order."""
    frame = (184, 328)
    sizes = scale_sizes(*frame, (0.5, 1.0), 368, 8)
    heats, pafs, joints = crowded_scene(sizes, 12, 5, frame)
    got = _run_both([h.numpy() for h in heats], [p.numpy() for p in pafs], sizes, frame, CFG,
                    culled_rows_as_set=True)
    people = to_people({k: v[0].numpy() for k, v in got.items()})
    assert len(joints) == 12 and len(people) == 12
    assert min(p["num_parts"] for p in people) >= 15


def test_random_fields_with_margin_mask():
    """Image 0 keeps its whole canvas, image 1 a 50x61 top-left region."""
    rng = np.random.default_rng(101)
    sizes = scale_sizes(64, 80, (0.5, 1.0, 1.5), 64, 8)
    heats, pafs = _random_fields(rng, sizes, 2)
    valid_hw = np.array([[64, 80], [50, 61]], np.int32)
    got = _run_both(heats, pafs, sizes, (64, 80), CFG, valid_hw)
    assert int(got["peak_scores"].ne(0).sum()) > 20
    assert int(got["valid"].sum()) > 0
    inside = got["peak_scores"][1].ne(0)
    assert bool((got["peak_ys"][1][inside] < 50).all() & (got["peak_xs"][1][inside] < 61).all())
    outside = got["peak_scores"][0].ne(0) & ((got["peak_ys"][0] >= 50) | (got["peak_xs"][0] >= 61))
    assert bool(outside.any())      # the unmasked image does have peaks there


def test_peak_capacity_overflow_switches_to_top_scores():
    rng = np.random.default_rng(7)
    sizes = scale_sizes(64, 80, (0.5, 1.0, 1.5), 64, 8)
    heats, pafs = _random_fields(rng, sizes, 2)
    cfg = dataclasses.replace(CFG, max_peaks=4, peak_compact_tiers=(2,), pair_tiers=(2,))
    flats = pyramid_peak_scores(
        TSpace([torch.from_numpy(m) for m in heats], [s[:2] for s in sizes], (64, 80)))
    assert int(torch.isfinite(flats).sum(dim=-1).max()) > cfg.max_peaks
    got = _run_both(heats, pafs, sizes, (64, 80), cfg)
    scores = got["peak_scores"]     # top-score mode: each row score-descending
    assert bool((scores[..., :-1] >= scores[..., 1:]).all())
