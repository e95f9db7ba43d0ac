"""The port's full-resolution path against the JAX package, on the CPU.

The same numpy inputs go through both packages, module by module and
then as a whole:

  upsample_to[_batch]   ops/image.py    vs tpupose.ops.image         1e-6
  gaussian_blur         decode/peaks.py vs tpupose.decode.peaks      1e-6
  peak_scores (plain)   ops/peaks.py    vs peak_scores_pallas run with
                        interpret=True, and vs gaussian_blur +
                        masked_scores: equal peak masks, values 1e-5
  find_peaks[_kernel]   tables equal to find_peaks / find_peaks_pallas,
                        also past the capacity; scores 1e-5
  pair_scores           full-res readout vs vmap(pair_scores): ok equal,
                        prior 1e-5
  decode_maps[_batch]   arrays, ScaleSpaces, one of each, valid_hw:
                        integer tables equal, floats 1e-4
  PoseEstimator         paf_readout="fullres": maps() 1e-4, people as
                        tests/test_torch_infer.py holds them

Tolerances: 1e-6 where both sides do the same few f32 operations; 1e-5
where sums run in another order (the reference's oracle blurs
vertically first, the kernel's arithmetic horizontally first, as
tests/test_pallas_kernels.py allows); 1e-4 after a network or a whole
decode. The CUDA kernel itself is held bit-equal to ``peak_scores_plain``
on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupose.config import InferenceConfig, ModelConfig, PoseConfig
from tpupose.decode import api as japi
from tpupose.decode import paf as jpaf
from tpupose.decode import peaks as jpeaks
from tpupose.decode.scalespace import ScaleSpace as JSpace
from tpupose.infer import PoseEstimator as JaxEstimator
from tpupose.models import OpenPose as JaxOpenPose
from tpupose.ops import image as jimage
from tpupose.ops.pallas_peaks import find_peaks_pallas, peak_scores_pallas
from tpupose_torch.decode import decode_maps, decode_maps_batch
from tpupose_torch.decode import paf as tpaf
from tpupose_torch.decode import peaks as tpeaks
from tpupose_torch.decode.api import to_people
from tpupose_torch.decode.scalespace import ScaleSpace as TSpace
from tpupose_torch.infer import PoseEstimator
from tpupose_torch.ops import image as timage
from tpupose_torch.ops.peaks import find_peaks_kernel, peak_scores, peak_scores_plain
from tpupose_torch.reference_impl import decode_np as tdecode_np
from tpupose_torch.testing import limit_threads, planted_scene

limit_threads()

# max_peaks=16 with an 8-slot compaction tier keeps the reference's
# batch-global overflow guard active (it runs only when a tier exists)
CFG = InferenceConfig(max_peaks=16, peak_compact_tiers=(8,))
SIZES = jimage.scale_sizes(368, 368, (0.5, 1.0, 1.5, 2.0), 368, 8)


# --- upsample_to -----------------------------------------------------------------

@pytest.mark.parametrize("hw", [(368, 368), (240, 328)])
def test_upsample_to_matches_reference_at_the_pyramid_geometries(hw):
    h, w = hw
    rng = np.random.default_rng(h)
    for rh, rw, ph, pw in jimage.scale_sizes(h, w, (0.5, 1.0, 1.5, 2.0), 368, 8):
        m = rng.normal(size=(2, ph // 8, pw // 8, 3)).astype(np.float32)
        want = np.asarray(jimage.upsample_to_batch(jnp.asarray(m), rh, rw, h, w, 8))
        got = timage.upsample_to_batch(torch.from_numpy(m), rh, rw, h, w, 8)
        assert got.shape == (2, h, w, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        one = timage.upsample_to(torch.from_numpy(m[:1]), rh, rw, h, w, 8)
        assert torch.equal(one, got[0])


def test_preprocess_scale_matches_reference():
    img = np.random.default_rng(1).uniform(-0.5, 0.5, (50, 70, 3)).astype(np.float32)
    want = np.asarray(jimage.preprocess_scale(jnp.asarray(img), 37, 52, 8, jimage.PAD_NORM))
    got = timage.preprocess_scale(torch.from_numpy(img), 37, 52, 8, timage.PAD_NORM)
    assert got.shape == want.shape == (1, 40, 56, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# --- blur and peak scores ----------------------------------------------------------

def _smooth_field(seed, h, w, c=19, scale=3.0):
    """Noise blurred at sigma 4 (the field of tests/test_pallas_kernels.py)."""
    base = np.random.default_rng(seed).normal(size=(h, w, c)).astype(np.float32)
    return np.asarray(jpeaks.gaussian_blur(jnp.asarray(base), 4.0)) * scale


def _border_peaks(h=40, w=56):
    """A bump on each border and corner, and one inside."""
    heat = np.zeros((h, w, 19), np.float32)
    spots = [(0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1), (0, w // 2), (h - 1, w // 3),
             (h // 2, 0), (h // 3, w - 1), (h // 2, w // 2)]
    yy, xx = np.mgrid[:h, :w]
    for c in range(19):
        for i, (y, x) in enumerate(spots):
            heat[..., c] += (0.5 + 0.05 * ((i + c) % 7)) * np.exp(
                -((yy - y) ** 2 + (xx - x) ** 2) / (2 * 2.5 ** 2))
    return heat, spots


FIELDS = {
    "smooth 64x80": lambda: _smooth_field(0, 64, 80),
    "smooth 40x56": lambda: _smooth_field(1, 40, 56),
    "narrower than the blur radius": lambda: _smooth_field(2, 7, 30, scale=2.0),
    "one row": lambda: np.random.default_rng(3).normal(size=(1, 9, 19)).astype(np.float32),
    "empty": lambda: np.zeros((48, 48, 19), np.float32),
    "borders and corners": lambda: _border_peaks()[0],
}


@pytest.mark.parametrize("hw", [(64, 80), (5, 7)])
def test_gaussian_blur_matches_reference(hw):
    x = np.random.default_rng(5).normal(size=(*hw, 4)).astype(np.float32)
    want = np.asarray(jpeaks.gaussian_blur(jnp.asarray(x), 3.0))
    got = tpeaks.gaussian_blur(torch.from_numpy(x), 3.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    batched = tpeaks.gaussian_blur(torch.from_numpy(np.stack([x, x[::-1].copy()])), 3.0)
    assert torch.equal(batched[0], got)


@pytest.mark.parametrize("name", list(FIELDS))
def test_peak_scores_plain_matches_pallas_kernel_and_oracle(name):
    heat = FIELDS[name]()
    h, w = heat.shape[:2]
    got = peak_scores(torch.from_numpy(heat)[None], 18, 3.0, 0.1)
    assert got.shape == (1, 18, h * w) and got.dtype == torch.float32
    got = got[0].numpy()
    parts = jnp.asarray(heat[..., :18])
    pallas = np.asarray(peak_scores_pallas(parts, sigma=3.0, thre1=0.1, interpret=True))
    oracle = np.asarray(jpeaks.masked_scores(parts, jpeaks.gaussian_blur(parts, 3.0), 0.1))
    mask = np.isfinite(got)
    for want in (pallas.reshape(18, h * w), oracle):
        np.testing.assert_array_equal(np.isfinite(want), mask)
        np.testing.assert_allclose(got[mask], want[mask], rtol=0, atol=1e-5)
    assert np.all(got[~mask] == -np.inf)
    if name == "empty":
        assert not mask.any()
    elif name == "borders and corners":
        for c in (0, 17):
            ys, xs = np.divmod(np.nonzero(mask[c])[0], w)
            assert sorted(zip(ys.tolist(), xs.tolist())) == sorted(_border_peaks()[1])
    else:
        assert mask.sum() >= 5


def test_peak_scores_batches_and_ignores_extra_channels():
    a, b = _smooth_field(7, 24, 40, c=21), _smooth_field(8, 24, 40, c=21)
    both = peak_scores_plain(torch.from_numpy(np.stack([a, b])), 18, 3.0, 0.1)
    for i, one in enumerate((a, b)):
        alone = peak_scores(torch.from_numpy(one[None, ..., :18].copy()), 18, 3.0, 0.1)
        assert torch.equal(both[i], alone[0])
    with pytest.raises(ValueError):
        peak_scores(torch.from_numpy(a[None, ..., :17].copy()), 18)
    with pytest.raises(ValueError):
        peak_scores(torch.from_numpy(a), 18)


def _assert_tables(got, want, msg):
    for key in ("xs", "ys", "valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=f"{msg} {key}")
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0,
                               atol=1e-5, err_msg=msg)


@pytest.mark.parametrize("max_peaks", [32, 8])
def test_find_peaks_tables_match_reference(max_peaks):
    """max_peaks 8 is past the capacity: both keep a row's first 8 in scan order."""
    heat = _smooth_field(0, 64, 80)
    want = jpeaks.find_peaks(jnp.asarray(heat), max_peaks=max_peaks)
    pallas = find_peaks_pallas(jnp.asarray(heat), max_peaks=max_peaks, interpret=True)
    counts = np.isfinite(peak_scores(torch.from_numpy(heat)[None])[0].numpy()).sum(-1)
    assert (counts.max() > max_peaks) == (max_peaks == 8)
    got = tpeaks.find_peaks(torch.from_numpy(heat), max_peaks=max_peaks)
    fused = find_peaks_kernel(torch.from_numpy(heat), max_peaks=max_peaks)
    assert got["xs"].shape == (18, max_peaks) and got["xs"].dtype == torch.int32
    _assert_tables(got, want, "find_peaks")
    _assert_tables(fused, pallas, "find_peaks_kernel")
    _assert_tables(fused, want, "find_peaks_kernel vs find_peaks")


def test_peak_scores_match_the_numpy_twin():
    heat = _smooth_field(4, 48, 64)
    got = peak_scores(torch.from_numpy(heat)[None])[0].numpy()
    twin = tdecode_np.find_peaks_np(heat)
    for part in range(18):
        at = np.nonzero(np.isfinite(got[part]))[0]
        assert [(i % 64, i // 64) for i in at.tolist()] == [(x, y) for x, y, _, _ in twin[part]]
        np.testing.assert_allclose(got[part][at], [s for _, _, s, _ in twin[part]], rtol=0, atol=1e-5)
    assert sum(len(p) for p in twin) > 20


# --- pair scores -------------------------------------------------------------------

def test_fullres_pair_scores_match_reference():
    rng = np.random.default_rng(9)
    b, h, w, k = 2, 48, 64, 6
    paf = rng.normal(0, 0.3, (b, h, w, 38)).astype(np.float32)
    # a smooth field around (0.4, 0.4): pairs pointing down-right pass
    paf = (paf + np.roll(paf, 1, 1) + np.roll(paf, 1, 2)) / 3.0 + 0.4
    peaks = {
        "xs": rng.integers(0, w, (b, 18, k)).astype(np.int32),
        "ys": rng.integers(0, h, (b, 18, k)).astype(np.int32),
        "scores": rng.random((b, 18, k)).astype(np.float32),
        "valid": rng.random((b, 18, k)) < 0.8,
    }
    peaks["xs"][:, :, 1] = peaks["xs"][:, :, 0]        # a zero-length pair per limb
    peaks["ys"][:, :, 1] = peaks["ys"][:, :, 0]
    want = jax.vmap(lambda p, pk: jpaf.pair_scores(p, pk, 10, 0.05, 0.8))(
        jnp.asarray(paf), {key: jnp.asarray(v) for key, v in peaks.items()})
    got = tpaf.pair_scores(torch.from_numpy(paf),
                           {key: torch.from_numpy(v) for key, v in peaks.items()}, 10, 0.05, 0.8)
    prior, ok, n_a, n_b = (np.asarray(v) for v in want)
    assert got[0].shape == (b, 19, k, k) and ok.any() and not ok.all()
    np.testing.assert_array_equal(got[1].numpy(), ok)
    np.testing.assert_allclose(got[0].numpy(), prior, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), n_a)
    np.testing.assert_array_equal(got[3].numpy(), n_b)


# --- decode_maps -------------------------------------------------------------------

_j_decode = jax.jit(japi.decode_impl, static_argnames=("cfg",))
_j_decode_batch = jax.jit(japi.decode_impl_batch, static_argnames=("cfg",))


def _materialise(maps, sizes, out_hw):
    """Per-scale (B, Hl, Wl, C) numpy maps -> their (B, H, W, C) average,
    upsampled by the reference."""
    avg = None
    for (rh, rw, _, _), m in zip(sizes, maps):
        full = jimage.upsample_to_batch(jnp.asarray(m), rh, rw, *out_hw, 8)
        avg = full / len(sizes) if avg is None else avg + full / len(sizes)
    return np.array(avg)      # a writable copy


def _assert_decodes_equal(got, want):
    want = jax.device_get(want)
    assert set(got) == set(want)
    for key in want:
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape, key
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


@lru_cache(maxsize=1)
def _planted():
    """Two planted scenes: per-scale low-res numpy maps and their
    materialised full-res averages."""
    scenes = [planted_scene(SIZES, seed) for seed in (11, 12)]
    heats = [np.concatenate([s[0][i].numpy() for s in scenes]) for i in range(len(SIZES))]
    pafs = [np.concatenate([s[1][i].numpy() for s in scenes]) for i in range(len(SIZES))]
    return heats, pafs, _materialise(heats, SIZES, (368, 368)), _materialise(pafs, SIZES, (368, 368))


def _spaces(maps, sizes, out_hw, index=None):
    pick = (lambda m: m) if index is None else (lambda m: m[index])
    geoms = [s[:2] for s in sizes]
    return (JSpace([jnp.asarray(pick(m)) for m in maps], geoms, out_hw),
            TSpace([torch.from_numpy(pick(m)) for m in maps], geoms, out_hw))


def test_decode_maps_batch_on_planted_scenes():
    _, _, heat, paf = _planted()
    got = decode_maps_batch(torch.from_numpy(heat), torch.from_numpy(paf), CFG)
    _assert_decodes_equal(got, _j_decode_batch(jnp.asarray(heat), jnp.asarray(paf), CFG))
    for b in range(2):
        people = to_people({k: v[b].numpy() for k, v in got.items()})
        assert len(people) == 2 and all(p["num_parts"] == 18 for p in people)


@pytest.mark.parametrize("mix", ["arrays", "heat array, PAF ScaleSpace", "heat ScaleSpace, PAF array"])
def test_decode_maps_one_image_arrays_and_mixed_inputs(mix):
    heats, pafs, heat, paf = _planted()
    jh, th = jnp.asarray(heat[0]), torch.from_numpy(heat[0])
    jp, tp = jnp.asarray(paf[0]), torch.from_numpy(paf[0])
    if mix == "heat array, PAF ScaleSpace":
        jp, tp = _spaces(pafs, SIZES, (368, 368), 0)
    elif mix == "heat ScaleSpace, PAF array":
        jh, th = _spaces(heats, SIZES, (368, 368), 0)
    got = decode_maps(th, tp, CFG)
    assert got["rows"].shape == (CFG.max_people, 18)
    _assert_decodes_equal(got, _j_decode(jh, jp, CFG))
    assert len(to_people({k: v.numpy() for k, v in got.items()})) == 2
    # every readout of the scene finds the same people
    base = decode_maps(torch.from_numpy(heat[0]), torch.from_numpy(paf[0]), CFG)
    for key, v in base.items():
        if v.dtype.is_floating_point:
            assert (got[key] - v).abs().max().item() <= 1e-4, key
        else:
            assert torch.equal(got[key], v), key


def test_decode_maps_batch_random_fields_with_margin_mask():
    """Image 0 keeps its whole canvas, image 1 a 50x61 top-left region."""
    rng = np.random.default_rng(101)
    sizes = jimage.scale_sizes(64, 80, (0.5, 1.0, 1.5), 64, 8)

    def low(c):
        out = []
        for _, _, ph, pw in sizes:
            m = rng.normal(size=(2, ph // 8, pw // 8, c)).astype(np.float32)
            out.append((m + np.roll(m, 1, 1) + np.roll(m, 1, 2)) / 3.0 * 0.6)
        return out

    heat = _materialise(low(19), sizes, (64, 80))
    paf = _materialise(low(38), sizes, (64, 80))
    valid_hw = np.array([[64, 80], [50, 61]], np.int32)
    got = decode_maps_batch(torch.from_numpy(heat), torch.from_numpy(paf), CFG,
                            torch.from_numpy(valid_hw))
    _assert_decodes_equal(got, _j_decode_batch(jnp.asarray(heat), jnp.asarray(paf), CFG,
                                               jnp.asarray(valid_hw)))
    assert int(got["peak_scores"].ne(0).sum()) > 20 and int(got["valid"].sum()) > 0
    inside = got["peak_scores"][1].ne(0)
    assert bool((got["peak_ys"][1][inside] < 50).all() & (got["peak_xs"][1][inside] < 61).all())
    free = decode_maps_batch(torch.from_numpy(heat), torch.from_numpy(paf), CFG)
    outside = free["peak_scores"][1].ne(0) & ((free["peak_ys"][1] >= 50) | (free["peak_xs"][1] >= 61))
    assert bool(outside.any())      # without the mask the margin does hold peaks
    # past the peak capacity the whole batch switches to its strongest peaks
    small = dataclasses.replace(CFG, max_peaks=4, peak_compact_tiers=(2,), pair_tiers=(2,))
    over = decode_maps_batch(torch.from_numpy(heat), torch.from_numpy(paf), small)
    _assert_decodes_equal(over, _j_decode_batch(jnp.asarray(heat), jnp.asarray(paf), small))
    assert bool((over["peak_scores"][..., :-1] >= over["peak_scores"][..., 1:]).all())


# --- the slice as a whole ------------------------------------------------------------

MODEL = ModelConfig(boxsize=64, num_stages=2, compute_dtype="float32")
INFER = InferenceConfig(scale_search=(0.5, 1.0), max_peaks=16, peak_compact_tiers=(8,),
                        paf_readout="fullres")
EST_CFG = PoseConfig(model=MODEL, inference=INFER)


@lru_cache(maxsize=1)
def _params():
    """Seeded flax init with the final heads scaled up, so the random
    network emits peaks and limbs (tests/test_torch_infer.py)."""
    params = JaxOpenPose(num_stages=2, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"]
    params = jax.tree.map(np.asarray, params)
    for branch in ("stage2_L1", "stage2_L2"):
        params[branch]["out"]["kernel"] = params[branch]["out"]["kernel"] * 3000.0
    return params


@lru_cache(maxsize=1)
def _jax_estimator():
    return JaxEstimator(EST_CFG, params=jax.tree.map(jnp.asarray, _params()))


def _images():
    return (np.random.default_rng(0).random((2, 64, 80, 3)) * 255).astype(np.uint8)


def _assert_same_people(got, want):
    assert len(got) == len(want)
    for pg, pw in zip(got, want):
        assert len(pg) == len(pw)
        for a, b in zip(pg, pw):
            assert a["num_parts"] == b["num_parts"]
            assert sorted(a["keypoints"]) == sorted(b["keypoints"])
            np.testing.assert_allclose(a["score"], b["score"], rtol=1e-5, atol=1e-4)
            for name, kp in a["keypoints"].items():
                assert (kp["x"], kp["y"]) == (b["keypoints"][name]["x"], b["keypoints"][name]["y"])
                np.testing.assert_allclose(kp["score"], b["keypoints"][name]["score"],
                                           rtol=1e-5, atol=1e-4)


def test_fullres_estimator_maps_match_reference():
    img = _images()[0]
    heat_w, paf_w = (np.asarray(m) for m in _jax_estimator().maps(img))
    heat, paf = PoseEstimator(EST_CFG, params=_params(), device="cpu").maps(img)
    assert heat.shape == (64, 80, 19) and paf.shape == (64, 80, 38)
    assert heat.dtype == paf.dtype == torch.float32
    assert np.abs(heat_w).max() > 0.2       # the scaled heads do emit a field
    np.testing.assert_allclose(heat.numpy(), heat_w, rtol=0, atol=1e-4)
    np.testing.assert_allclose(paf.numpy(), paf_w, rtol=0, atol=1e-4)


def test_fullres_estimator_people_match_reference():
    imgs = _images()
    want = _jax_estimator().process_batch(imgs)
    est = PoseEstimator(EST_CFG, params=_params(), device="cpu")
    got = est.process_batch(imgs)
    assert sum(len(p) for p in want) >= 4
    _assert_same_people(got, want)
    # one image through process_async / process, as the reference's single program
    tables = est.process_async(imgs[1])
    assert tables["rows"].shape == (INFER.max_people, 18)
    one = to_people({k: v.numpy() for k, v in tables.items()})
    _assert_same_people([one], [want[1]])
    assert est.process(imgs[1])["people"] == one
    _assert_same_people([one], [_jax_estimator().process(imgs[1])["people"]])


def test_fullres_and_scalespace_estimators_agree():
    imgs = _images()
    full = PoseEstimator(EST_CFG, params=_params(), device="cpu")
    ss_cfg = PoseConfig(model=MODEL, inference=dataclasses.replace(INFER, paf_readout="scalespace"))
    ss = PoseEstimator(ss_cfg, params=_params(), device="cpu")
    got = full.process_batch(imgs)
    assert sum(len(p) for p in got) >= 4
    _assert_same_people(got, ss.process_batch(imgs))
    # maps() is the full-res average whichever readout decodes
    for a, b in zip(full.maps(imgs[0]), ss.maps(imgs[0])):
        assert torch.equal(a, b)


def test_maps_batch_is_what_the_fullres_readout_decodes():
    """maps_batch: the averaged maps of the whole batch, per image those of
    maps() (1e-5: a convolution may sum a batch of 2 in another order than
    a batch of 1), and decoded they are process_batch's people."""
    imgs = _images()
    est = PoseEstimator(EST_CFG, params=_params(), device="cpu")
    heat, paf = est.maps_batch(imgs)
    assert heat.shape == (2, 64, 80, 19) and paf.shape == (2, 64, 80, 38)
    for i in range(2):
        for many, one in zip((heat[i], paf[i]), est.maps(imgs[i])):
            np.testing.assert_allclose(many.numpy(), one.numpy(), rtol=0, atol=1e-5)
    tables = {k: v.numpy() for k, v in decode_maps_batch(heat, paf, INFER).items()}
    people = [to_people({k: v[i] for k, v in tables.items()}) for i in range(2)]
    assert people == est.process_batch(imgs)
    one_scale = est.maps_batch(imgs, scales=(1.0,))[0]
    assert one_scale.shape == heat.shape and not torch.equal(one_scale, heat)


def test_unknown_paf_readout_raises():
    cfg = PoseConfig(model=MODEL, inference=dataclasses.replace(INFER, paf_readout="nonsense"))
    with pytest.raises(ValueError, match="paf_readout"):
        PoseEstimator(cfg, device="cpu")

