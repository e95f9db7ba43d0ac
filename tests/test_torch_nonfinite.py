"""Non-finite network output through the port and the JAX package, on the CPU.

The reference evaluates the decode's linear readouts as dense
contractions, so one NaN or inf in a low-res channel reaches the whole
channel; the port computes them locally and follows the contract stated
in ``tpupose_torch/decode/scalespace.py`` instead. The same poisoned
numpy maps go through both packages:

  upsample_to_batch     ops/image.py vs tpupose.ops.image: NaN, +inf and
                        -inf at the same positions, finite values 1e-6;
                        pyramid geometries, resizes that keep an axis,
                        and maps so small that an inf survives; on
                        finite maps bit-equal to the interpolations alone
  pyramid_heat_maps     decode/scalespace.py vs the reference's: classes
                        equal, finite values 1e-6
  sample_avg_plain      ops/sample.py vs the reference's sample_avg
                        (sample_chain per scale): classes equal at every
                        pixel of the image, finite values 1e-5
  assoc                 ops/assoc.py vs greedy_all + assemble on priors
                        that hold NaN and +-inf: tables equal
  the decode            both readouts (scale-space and full-res) x heat
                        or PAF x NaN, +inf, -inf x a pixel of the first or
                        the last scale, on the geometry of fuzz case 3
                        (tests/test_torch_decode_fuzz.py): every table
                        equal, floats within 1e-4, NaN equal to NaN
                        (``_run_both``, ``_assert_decodes_equal``); a NaN
                        PAF pixel leaves no person in either package; a
                        poisoned image beside two clean ones leaves their
                        tables as they were

The CUDA kernels are held bit-equal to these plain versions on poisoned
maps on the card (chip_smoke.py, phase b).
"""

import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_decode import _run_both
from tests.test_torch_decode_fuzz import JIT_DECODE, _case
from tests.test_torch_fullres import _assert_decodes_equal, _j_decode_batch, _materialise
from tests.test_torch_kernels import _assert_people_equal, _port_people, _random_problem
from tpupose.config import InferenceConfig
from tpupose.decode import assemble as jasm
from tpupose.decode import paf as jpaf
from tpupose.decode.scalespace import ScaleSpace as JSpace
from tpupose.decode.scalespace import pyramid_heat_maps as j_heat_maps
from tpupose.decode.scalespace import sample_avg as j_sample_avg
from tpupose.ops import image as jimage
from tpupose_torch.decode import decode_maps_batch
from tpupose_torch.decode.scalespace import ScaleSpace as TSpace
from tpupose_torch.decode.scalespace import pyramid_heat_maps as t_heat_maps
from tpupose_torch.ops import image as timage
from tpupose_torch.ops.sample import sample_avg_plain
from tpupose_torch.testing import limit_threads

limit_threads()

VALUES = {"nan": np.nan, "+inf": np.inf, "-inf": -np.inf}


def _assert_classes(got, want, atol, msg=""):
    """NaN, +inf and -inf at the same positions; finite values within ``atol``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, msg
    for name, test in (("nan", np.isnan), ("+inf", np.isposinf), ("-inf", np.isneginf)):
        np.testing.assert_array_equal(test(got), test(want), err_msg=f"{msg}: {name}")
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=atol, err_msg=msg)


def _poisons(rng, shape, kind):
    """A (B, H, W, C) smooth field with non-finite entries of ``kind``: one
    NaN, +inf or -inf; two +inf in one channel far apart; or +inf and -inf
    in one channel."""
    m = rng.normal(size=shape).astype(np.float32)
    b, h, w, c = shape
    if kind in VALUES:
        m[0, h // 2, w // 3, 1] = VALUES[kind]
    elif kind == "two +inf":
        m[0, 0, 0, 1] = m[0, h - 1, w - 1, 1] = np.inf
    else:
        m[0, 0, w - 1, 1], m[0, h - 1, 0, 2] = np.inf, -np.inf
        m[-1, h - 1, 0, 1] = -np.inf
        m[-1, h - 1, w - 1, 1] = np.inf
    return m


KINDS = [*VALUES, "two +inf", "mixed signs"]


# --- module by module ----------------------------------------------------------


# (low-res map (hl, wl), (rh, rw), image (out_h, out_w)): a pyramid scale,
# a second resize that keeps both axes (which the reference skips), one
# that keeps one axis, and maps small enough that an inf keeps its sign
UPSAMPLES = [
    ((9, 7), (72, 52), (136, 104)),
    ((6, 8), (48, 64), (48, 64)),
    ((6, 9), (48, 70), (48, 61)),
    ((1, 1), (2, 1), (3, 1)),
    ((2, 1), (9, 8), (5, 8)),
]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("geometry", range(len(UPSAMPLES)))
def test_upsample_to_batch_classes_match_reference(geometry, kind):
    (hl, wl), (rh, rw), out_hw = UPSAMPLES[geometry]
    maps = _poisons(np.random.default_rng(geometry), (2, hl, wl, 3), kind)
    got = timage.upsample_to_batch(torch.from_numpy(maps), rh, rw, *out_hw)
    want = jimage.upsample_to_batch(jnp.asarray(maps), rh, rw, *out_hw)
    _assert_classes(got.numpy(), want, 1e-6, f"{UPSAMPLES[geometry]} {kind}")
    if geometry == 3 and kind == "+inf":
        # the middle row's taps reach both rows of the x8 upsample; the others' one
        np.testing.assert_array_equal(np.asarray(want)[0, :, 0, 1], [np.nan, np.inf, np.nan])
    if geometry == 0 and kind != "mixed signs":
        assert np.isfinite(np.asarray(want)[1]).all()      # the clean image


@pytest.mark.parametrize("geometry", range(len(UPSAMPLES)))
def test_upsample_to_batch_on_finite_maps_is_the_interpolation(geometry):
    """The contract leaves a finite map's upsample as it was, bit for bit:
    the two interpolations alone, a channel of -0.0 included."""
    (hl, wl), (rh, rw), out_hw = UPSAMPLES[geometry]
    maps = torch.from_numpy(_poisons(np.random.default_rng(geometry), (2, hl, wl, 3), "-inf"))
    maps[0, hl // 2, wl // 3, 1] = 1.0
    maps[..., 2] = -0.0
    got = timage.upsample_to_batch(maps, rh, rw, *out_hw)
    want = timage.resize_bilinear(timage.resize_bilinear(maps, hl * 8, wl * 8)[:, :rh, :rw],
                                  *out_hw)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.signbit(got[..., 2]).any() == torch.signbit(want[..., 2]).any()


SIZES = jimage.scale_sizes(136, 104, (0.5, 1.0, 1.5, 2.0), 136, 8)


def _scale_maps(rng, kind, scale, c):
    """Per-scale (1, Hl, Wl, c) maps of the fuzz-case-3 pyramid, poisoned
    at one scale."""
    maps = [rng.normal(size=(1, ph // 8, pw // 8, c)).astype(np.float32)
            for _, _, ph, pw in SIZES]
    maps[scale] = _poisons(rng, maps[scale].shape, kind)
    return maps


@pytest.mark.parametrize("kind", KINDS)
def test_pyramid_heat_maps_classes_match_reference(kind):
    maps = _scale_maps(np.random.default_rng(1), kind, 1, 4)
    geoms = [s[:2] for s in SIZES]
    got = t_heat_maps(TSpace([torch.from_numpy(m) for m in maps], geoms, (136, 104)), 3.0)
    want = j_heat_maps(JSpace([jnp.asarray(m) for m in maps], geoms, (136, 104)), 3.0)
    for g, w, name in zip(got, want, ("averaged", "blurred")):
        _assert_classes(g.numpy(), w, 1e-6, f"{kind} {name}")


@pytest.mark.parametrize("kind", KINDS)
def test_sample_readout_classes_match_reference(kind):
    """Every pixel of the image, and points beyond its edges, on channel
    pairs that hold the poison and pairs that do not."""
    rng = np.random.default_rng(2)
    maps = _scale_maps(rng, kind, 3, 4)
    maps[0][0, 2, 3, 0] = {"nan": np.inf, "+inf": -np.inf}.get(kind, maps[0][0, 2, 3, 0])
    geoms = [s[:2] for s in SIZES]
    ys, xs = np.meshgrid(np.arange(-2, 138), np.arange(-2, 106), indexing="ij")
    iy, ix = ys.reshape(-1).astype(np.int32), xs.reshape(-1).astype(np.int32)
    chans = np.array([[0, 1], [2, 3], [1, 2]])
    got = sample_avg_plain(TSpace([torch.from_numpy(m) for m in maps], geoms, (136, 104)),
                           torch.from_numpy(np.broadcast_to(iy, (1, 3, iy.size)).copy()),
                           torch.from_numpy(np.broadcast_to(ix, (1, 3, ix.size)).copy()),
                           torch.from_numpy(chans)).numpy()
    want = np.asarray(_J_SAMPLE([jnp.asarray(m[0]) for m in maps], jnp.asarray(iy),
                                jnp.asarray(ix)))
    for g, pair in enumerate(chans):
        _assert_classes(got[0, g], want[:, pair], 1e-5, f"{kind} pair {pair}")


@jax.jit
def _J_SAMPLE(maps, iy, ix):
    return j_sample_avg(JSpace(maps, [s[:2] for s in SIZES], (136, 104)), iy, ix)


@pytest.mark.parametrize("value", ["nan", "+inf", "-inf"])
def test_assoc_on_nonfinite_priors_matches_reference(value):
    cfg = InferenceConfig()
    k, p, cap = 8, 64, 64
    prior, ok, n_a, n_b, scores = _random_problem(3, 2, k, 0.5)
    spots = np.random.default_rng(4).random(prior.shape) < 0.1
    prior[spots] = VALUES[value]
    _, got = _port_people(prior, ok, n_a, n_b, scores, k, cap, p, cfg)

    want = jax.device_get(_J_PEOPLE(*(jnp.asarray(a) for a in (prior, ok, n_a, n_b, scores))))
    _assert_people_equal(got, want, value)


@jax.jit
@jax.vmap
def _J_PEOPLE(prior, ok, n_a, n_b, scores):
    """The reference's greedy accept and assembly of one image (K = 8,
    64 candidates, 64 people)."""
    cfg = InferenceConfig()
    conns = jpaf.greedy_all(prior, ok, n_a, n_b, 8, 64)
    peaks = {"scores": scores, "xs": jnp.zeros((18, 8), jnp.int32),
             "ys": jnp.zeros((18, 8), jnp.int32), "valid": jnp.ones((18, 8), bool)}
    return jasm.assemble(peaks, conns, max_people=64, min_cnt=cfg.min_subset_cnt,
                         min_score=cfg.min_subset_score)


# --- the decode ------------------------------------------------------------------


def _poisoned_case(map_name, value, scale):
    """Fuzz case 3 (136x104, 4 scales, 32 peak slots, a margin mask) as a
    batch of two copies of its image, the second with one pixel of one
    channel set to ``value`` at ``scale``: the neck heat channel, or the x
    channel of the limb whose loss splits a person there."""
    heats, pafs, sizes, out_hw, cfg, valid_hw = _twice()
    m = (heats if map_name == "heat" else pafs)[scale]
    m[1, m.shape[1] // 2, m.shape[2] // 2, 1 if map_name == "heat" else 28] = VALUES[value]
    return heats, pafs, sizes, out_hw, cfg, valid_hw


def _twice(**overrides):
    """Fuzz case 3's one image twice in one batch. The reference runs
    without its pair tiers, which are bit-identical to the full grid by
    construction and take most of its compile time; its compaction tier
    stays, and with it the batch-global overflow guard."""
    heats, pafs, sizes, out_hw, cfg, valid_hw = _case(3)
    heats, pafs = ([np.concatenate([m, m]) for m in maps] for maps in (heats, pafs))
    cfg = dataclasses.replace(cfg, pair_tiers=(), **overrides)
    return heats, pafs, sizes, out_hw, cfg, np.concatenate([valid_hw, valid_hw])


def _fullres_both(heats, pafs, sizes, out_hw, cfg, valid_hw):
    """The full-res readout of both packages: each upsamples and averages
    the low-res maps itself, then decodes the materialised maps."""
    def port(maps):
        return timage.average_upsampled([torch.from_numpy(m) for m in maps], sizes, *out_hw)

    got = decode_maps_batch(port(heats), port(pafs), cfg, torch.from_numpy(valid_hw))
    want = _j_decode_batch(jnp.asarray(_materialise(heats, sizes, out_hw)),
                           jnp.asarray(_materialise(pafs, sizes, out_hw)), cfg,
                           jnp.asarray(valid_hw))
    _assert_decodes_equal(got, want)
    return got


def _decode_both(readout, case):
    if readout == "scalespace":
        return _run_both(*case, reference=JIT_DECODE)
    return _fullres_both(*case)


@lru_cache(maxsize=2)
def _clean(readout):
    return _decode_both(readout, _twice())


@pytest.mark.parametrize("scale", [0, -1], ids=["first scale", "last scale"])
@pytest.mark.parametrize("value", list(VALUES))
@pytest.mark.parametrize("map_name", ["heat", "paf"])
@pytest.mark.parametrize("readout", ["scalespace", "fullres"])
def test_decode_on_poisoned_maps_matches_reference(readout, map_name, value, scale):
    got = _decode_both(readout, _poisoned_case(map_name, value, scale))
    clean = _clean(readout)
    # the clean image beside the poisoned one decodes as without it
    for key, v in got.items():
        assert torch.equal(v[0], clean[key][0]), key
    # the poisoned channel holds no peak (heat); the people still decode
    if map_name == "heat":
        assert clean["peak_scores"][1, 1].ne(0).any() and not got["peak_scores"][1, 1].ne(0).any()
    assert int(got["valid"][1].sum()) > 0


@pytest.mark.parametrize("readout", ["scalespace", "fullres"])
def test_nan_paf_pixel_leaves_no_person(readout):
    """One low-res PAF pixel of the second image NaN in every channel:
    every limb's channel is NaN in the reference, so no pair connects and
    no person is left; the first image keeps its people."""
    heats, pafs, sizes, out_hw, cfg, valid_hw = _twice()
    pafs[0][1, 3, 4, :] = np.nan
    got = _decode_both(readout, (heats, pafs, sizes, out_hw, cfg, valid_hw))
    assert int(got["valid"][1].sum()) == 0 and int(got["peak_scores"][1].ne(0).sum()) > 0
    assert int(got["valid"][0].sum()) == int(_clean(readout)["valid"][0].sum()) > 0


def test_poisoned_image_beside_a_clean_one():
    """The second image with a NaN heat channel and an +inf PAF pixel at
    another scale; the first decodes as it does without them."""
    heats, pafs, sizes, out_hw, cfg, valid_hw = _twice()
    heats[0][1, 2, 3, 4] = np.nan
    pafs[-1][1, 1, 1, 20] = np.inf
    got = _run_both(heats, pafs, sizes, out_hw, cfg, valid_hw, reference=JIT_DECODE)
    clean = _clean("scalespace")
    for key, v in got.items():
        assert torch.equal(v[0], clean[key][0]), key
    assert clean["peak_scores"][1, 4].ne(0).any() and not got["peak_scores"][1, 4].ne(0).any()


@pytest.mark.parametrize("value", list(VALUES))
def test_decode_past_the_peak_capacity_on_poisoned_maps(value):
    """Four peak slots: the batch switches to its strongest peaks, and an
    inf in the heat makes peaks whose averaged value is +inf or NaN, which
    the reference's ``lax.top_k`` ranks first and last."""
    heats, pafs, sizes, out_hw, cfg, valid_hw = _twice(max_peaks=4, peak_compact_tiers=(2,))
    heats[0][1, 4, 3, 1] = VALUES[value]
    got = _run_both(heats, pafs, sizes, out_hw, cfg, valid_hw, reference=JIT_DECODE)
    assert bool((got["peak_scores"][..., :-1] >= got["peak_scores"][..., 1:]).all())
