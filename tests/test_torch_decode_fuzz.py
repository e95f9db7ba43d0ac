"""Differential fuzz of the port's scale-space decode against the JAX
package's (the counterpart of tests/test_decode_fuzz.py, which holds the
jnp decode to the numpy twin).

Eight seeds over small canvases (48-136 px, 1-4 scales, batch 1-3): 1-3
upright people per image, rasterised by the numpy oracle
(``reference_impl.gt_np``) on the canvas's stride-8 grid, under smoothed
random heat and PAF fields of varied gain (spurious peaks, marginal and
broken limbs); ``max_peaks`` 4-32 with pair and compaction tiers below it
(the reference runs its adaptive tiers, the port one full-capacity path),
``thre1`` and ``thre2`` varied, half of the cases with a ``valid_hw``
margin mask. Every table equal, floats within 1e-4 (``_run_both`` of
tests/test_torch_decode.py). The reference runs jitted, as its estimator
runs it; seeds ``s`` and ``s + 4`` share a geometry, batch and
configuration, so it compiles four programs.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from tests.test_torch_decode import CFG, _run_both, j_decode
from tpupose.decode.scalespace import ScaleSpace as JSpace
from tpupose_torch.config import ModelConfig
from tpupose_torch.decode.scalespace import ScaleSpace as TSpace
from tpupose_torch.decode.scalespace import chain_matrices, scale_shapes
from tpupose_torch.ops.image import resize_bilinear, scale_sizes
from tpupose_torch.ops.pyramid_peaks import pyramid_peak_scores
from tpupose_torch.reference_impl import gt_np
from tpupose_torch.testing import limit_threads, person

limit_threads()

JIT_DECODE = jax.jit(j_decode, static_argnums=(2,))

# canvas (h, w), scales (the boxsize is the canvas height), batch, max_peaks,
# thre1, thre2, whether a valid_hw mask is given
SETTINGS = [
    ((48, 64), (1.0,), 3, 4, 0.05, 0.02, False),
    ((96, 72), (0.5, 1.0), 2, 8, 0.1, 0.05, True),
    ((64, 120), (1.0, 1.5, 2.0), 3, 16, 0.2, 0.1, False),
    ((136, 104), (0.5, 1.0, 1.5, 2.0), 1, 32, 0.1, 0.02, True),
]


def _case(seed):
    rng = np.random.default_rng(seed)
    (h, w), scales, batch, max_peaks, thre1, thre2, masked = SETTINGS[seed % len(SETTINGS)]
    sizes = scale_sizes(h, w, scales, h, 8)
    cfg = dataclasses.replace(
        CFG, max_peaks=max_peaks, max_people=max(8, max_peaks),
        peak_compact_tiers=(max(max_peaks // 2, 1),),
        pair_tiers=tuple(t for t in (2, 4, 8, 16) if t < max_peaks), thre1=thre1, thre2=thre2)
    label = -(-max(h, w) // 8)
    labels = []
    for _ in range(batch):
        joints = np.stack([person(rng.uniform(0.2, 0.8) * w, rng.uniform(0.4, 0.6) * h,
                                  rng.uniform(0.5, 0.9) * h)
                           for _ in range(rng.integers(1, 4))])
        joints[..., 2] = rng.choice([0.0, 2.0], joints.shape[:2], p=[0.85, 0.15])
        one = gt_np.create_heatmaps_np(joints, model=ModelConfig(boxsize=8 * label))
        labels.append(one[: -(-h // 8), : -(-w // 8)])
    labels = torch.from_numpy(np.stack(labels).astype(np.float32))
    gains = rng.uniform(0.02, 0.15), rng.uniform(0.05, 0.3)
    heats, pafs = [], []
    for _, _, ph, pw in sizes:
        low = resize_bilinear(labels, ph // 8, pw // 8).numpy()
        noise = gaussian_filter(rng.normal(size=low.shape), sigma=(0, 1, 1, 0), mode="wrap")
        noise /= noise.std()
        heats.append((low[..., 38:] + gains[0] * noise[..., 38:]).astype(np.float32))
        pafs.append((low[..., :38] + gains[1] * noise[..., :38]).astype(np.float32))
    valid_hw = None
    if masked:
        valid_hw = np.stack([rng.integers(h // 2, h + 1, batch),
                             rng.integers(w // 2, w + 1, batch)], -1).astype(np.int32)
    return heats, pafs, sizes, (h, w), cfg, valid_hw


@pytest.mark.parametrize("seed", range(8))
def test_scalespace_decode_fuzz_against_the_reference(seed):
    heats, pafs, sizes, out_hw, cfg, valid_hw = _case(seed)
    got = _run_both(heats, pafs, sizes, out_hw, cfg, valid_hw, reference=JIT_DECODE)
    assert int(got["peak_scores"].ne(0).sum()) > 0 and int(got["valid"].sum()) > 0, seed



@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _j_peak_masks(maps, geoms, out_hw, sigma, thre1):
    """The reference decode's masked peak scores of each image (B, 18, H*W)."""
    from tpupose.decode.api import _masked_peak_scores

    cfg = dataclasses.replace(CFG, peak_sigma=sigma, thre1=thre1)
    return jax.vmap(lambda space: _masked_peak_scores(space, cfg))(JSpace(maps, geoms, out_hw))


def test_peak_masks_differ_only_on_one_ulp_ties():
    """The sweep's one differing seed (153, past the test's seeds): the two
    packages' blurred heat differs in the last bit or two at about half of
    the pixels whatever order the port sums in, so a ``>=`` NMS may keep
    another peak on a plateau narrower than an ulp. Every pixel where the
    peak masks differ must have a 4-neighbour whose blurred value, in f64,
    lies within one f32 ulp of its own; where the masks agree the test
    holds as it stands."""
    heats, _, sizes, out_hw, cfg, _ = _case(153)
    geoms = tuple(tuple(s[:2]) for s in sizes)
    got = pyramid_peak_scores(TSpace([torch.from_numpy(m) for m in heats], geoms, out_hw),
                              18, cfg.peak_sigma, cfg.thre1).numpy()
    want = np.asarray(_j_peak_masks([jnp.asarray(m) for m in heats], geoms, out_hw,
                                    cfg.peak_sigma, cfg.thre1))
    h, w = out_hw
    differ = np.argwhere((np.isfinite(got) != np.isfinite(want)).reshape(*got.shape[:2], h, w))
    blur = 0.0
    for m, mats in zip(heats, chain_matrices(scale_shapes(TSpace(heats, geoms, out_hw)),
                                             out_hw, cfg.peak_sigma)):
        ay, bx = (a.astype(np.float64) for a in mats[2:])
        blur = blur + np.einsum("yh,bhwc,xw->bcyx", ay, m[..., :18].astype(np.float64), bx)
    blur = blur / len(heats)
    for b, c, y, x in differ:
        v = blur[b, c, y, x]
        ulp = np.spacing(np.abs(np.float32(v)))
        near = [abs(blur[b, c, ny, nx] - v) <= ulp
                for ny, nx in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1))
                if 0 <= ny < h and 0 <= nx < w]
        assert any(near), (b, c, y, x)


def ulp_report(seeds) -> list[dict]:
    """Per seed, how far the two packages' blurred heat lies apart: the
    share of its elements whose f32 bits differ and the largest difference,
    with the port's chain as it runs (rows contracted first) and with the
    columns contracted first. The reference runs jitted, as its decode."""
    from tpupose.decode.scalespace import pyramid_heat_maps as j_heat_maps
    from tpupose_torch.decode.scalespace import pyramid_heat_maps as t_heat_maps

    out = []
    for seed in seeds:
        heats, _, sizes, out_hw, cfg, _ = _case(seed)
        geoms = tuple(tuple(s[:2]) for s in sizes)
        parts = [h[..., :18] for h in heats]
        want = np.asarray(jax.jit(lambda maps: j_heat_maps(JSpace(maps, geoms, out_hw),
                                                           cfg.peak_sigma)[1])(
            [jnp.asarray(m) for m in parts]))
        space = TSpace([torch.from_numpy(m) for m in parts], geoms, out_hw)
        rows_first = t_heat_maps(space, cfg.peak_sigma)[1].numpy()
        cols_first = 0.0
        for m, mats in zip(space.maps, chain_matrices(scale_shapes(space), out_hw,
                                                      cfg.peak_sigma)):
            ay, bx = (torch.from_numpy(a) for a in mats[2:])
            t = torch.einsum("...hwc,xw->...hxc", m, bx)
            cols_first = cols_first + torch.einsum("yh,...hxc->...yxc", ay, t) / len(parts)
        row = {"seed": seed, "elements": want.size}
        for name, got in (("rows_first", rows_first), ("cols_first", cols_first.numpy())):
            differ = got.view(np.int32) != want.view(np.int32)
            row[name] = {"share": float(differ.mean()), "count": int(differ.sum()),
                         "max_abs": float(np.abs(got - want).max())}
        out.append(row)
    return out


def main(argv=None) -> int:
    """Sweep the generator over more seeds than the test runs and print the
    seeds whose tables differ: ``python -m tests.test_torch_decode_fuzz 200``.
    With ``--ulps SEED ...``, print ``ulp_report`` of those seeds, one JSON
    line each."""
    import json
    import sys

    args = list(argv if argv is not None else sys.argv[1:])
    if args[:1] == ["--ulps"]:
        for row in ulp_report([int(a) for a in args[1:]]):
            print(json.dumps(row), flush=True)
        return 0
    n = int((args or ["200"])[0])
    differ = []
    for seed in range(n):
        heats, pafs, sizes, out_hw, cfg, valid_hw = _case(seed)
        try:
            _run_both(heats, pafs, sizes, out_hw, cfg, valid_hw, reference=JIT_DECODE)
        except AssertionError as e:
            differ.append(seed)
            print(f"seed {seed}: {str(e).strip().splitlines()[0]}", flush=True)
    print(f"{len(differ)} of {n} seeds differ: {differ}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
