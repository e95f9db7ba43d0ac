"""The port's augmentation and GT rasterisation against the JAX package,
on the CPU, from the same numpy-seeded inputs.

  affine_matrix, transform_joints, sample_mask_at_label_grid   1e-5
  warp_image, warp_image_twopass on uint8-valued images, both
      packages given the same affine                            1e-4
  augment_batch, each package composing its own affine         2e-2 on
      the image (see AUGMENT_IMAGE_ATOL), 5e-5 on the mask
  create_labels (plain version; the CUDA kernel is held against it on the
      card) vs jnp create_labels, the Pallas kernel in interpret mode and
      the numpy twin                                            1e-5

The JAX functions are per sample; they are vmapped here as
``augment_batch`` vmaps them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupose.config import AugmentConfig as JAug, ModelConfig as JModel
from tpupose.gt import augment as JA
from tpupose.gt.rasterize import create_labels as j_create_labels
from tpupose.ops.pallas_gt import create_labels_pallas
from tpupose.reference_impl import gt_np
from tpupose_torch.config import AugmentConfig, ModelConfig
from tpupose_torch.gt import augment as TA
from tpupose_torch.gt import rasterize as TR
from tpupose_torch.ops.gt import create_labels_plain
from tpupose_torch.testing import limit_threads

limit_threads()

WARP_ATOL = 1e-4
# The two packages' affines differ by an f32 ulp of translations of a few
# hundred pixels (3e-5); on a white-noise image, whose neighbouring pixels
# differ by up to 255, that moves an interpolated value by up to 8e-3.
AUGMENT_IMAGE_ATOL = 2e-2


def draws(rng, n, degrees=None, flip=None):
    return {
        "scale_mult": rng.uniform(0.5, 1.1, n).astype(np.float32),
        "degrees": np.asarray(degrees if degrees is not None
                              else rng.uniform(-40, 40, n), np.float32),
        "perturb": rng.uniform(-40, 40, (n, 2)).astype(np.float32),
        "flip": np.asarray(flip if flip is not None else rng.random(n) < 0.5),
    }


def j_affines(centers, scales, params, out):
    fn = lambda c, s, p: JA.affine_matrix(c, s, p, JAug(), out)
    return jax.vmap(fn)(jnp.asarray(centers), jnp.asarray(scales),
                        {k: jnp.asarray(v) for k, v in params.items()})


def t_affines(centers, scales, params, out):
    return TA.affine_matrix(torch.from_numpy(centers), torch.from_numpy(scales),
                            {k: torch.from_numpy(v) for k, v in params.items()},
                            AugmentConfig(), out)


def geometry(rng, n, h, w):
    centers = np.stack([rng.uniform(0.3 * w, 0.7 * w, n), rng.uniform(0.3 * h, 0.7 * h, n)],
                       -1).astype(np.float32)
    scales = rng.uniform(0.5, 1.0, n).astype(np.float32)
    return centers, scales


def test_affine_matrix_matches_jax():
    rng = np.random.default_rng(0)
    n = 16
    centers, scales = geometry(rng, n, 200, 300)
    params = draws(rng, n)
    want = np.asarray(j_affines(centers, scales, params, 368))
    got = t_affines(centers, scales, params, 368).numpy()
    assert got.shape == (n, 2, 3)
    # entries up to a few hundred: rtol carries their f32 ulp
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_identity_params_give_the_identity_affine():
    p = TA.identity_params()
    j = JA.identity_params()
    for k in p:
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(j[k]))
    m = TA.affine_matrix(torch.tensor([32.0, 32.0]), torch.tensor(0.6), p, AugmentConfig(), 64)
    np.testing.assert_allclose(m.numpy(), [[1, 0, 0], [0, 1, 0]], atol=1e-5)


def test_transform_joints_matches_jax():
    rng = np.random.default_rng(1)
    n, persons, out = 6, 4, 64
    centers, scales = geometry(rng, n, 96, 96)
    params = draws(rng, n, flip=[True, False] * 3)
    joints = rng.uniform(-10, 106, (n, persons, 18, 3)).astype(np.float32)
    joints[..., 2] = rng.choice([0.0, 1.0, 2.0], (n, persons, 18))
    aff = j_affines(centers, scales, params, out)
    want = np.asarray(jax.vmap(lambda j, m, f: JA.transform_joints(j, m, f, out))(
        jnp.asarray(joints), aff, jnp.asarray(params["flip"])))
    got = TA.transform_joints(torch.from_numpy(joints), torch.from_numpy(np.asarray(aff)),
                              torch.from_numpy(params["flip"]), out).numpy()
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    assert (want[..., 2] == 2.0).any() and (want[..., 2] < 2.0).any()


def test_transform_joints_flip_swaps_left_right():
    joints = np.zeros((1, 1, 18, 3), np.float32)
    joints[0, 0, :, 0] = np.arange(18) + 10.0
    joints[0, 0, :, 1] = 20.0
    ident = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]])
    got = TA.transform_joints(torch.from_numpy(joints), ident, torch.tensor([True]), 64)
    from tpupose_torch import topology
    np.testing.assert_array_equal(got[0, 0, :, 0].numpy(),
                                  joints[0, 0, list(topology.FLIP_PERMUTATION), 0])
    off = joints.copy()
    off[0, 0, 3, 0] = 64.0          # first column outside a 64-wide frame
    off[0, 0, 4, 1] = -0.5
    got = TA.transform_joints(torch.from_numpy(off), ident, torch.tensor([False]), 64)
    assert got[0, 0, 3, 2] == 2.0 and got[0, 0, 4, 2] == 2.0 and got[0, 0, 5, 2] == 0.0


def test_sample_mask_at_label_grid_matches_jax():
    rng = np.random.default_rng(2)
    n, h, w, box, stride = 5, 90, 70, 64, 8
    centers, scales = geometry(rng, n, h, w)
    params = draws(rng, n)
    masks = (rng.random((n, h, w)) > 0.3).astype(np.float32)
    aff = j_affines(centers, scales, params, box)
    want = np.asarray(jax.vmap(
        lambda m, a: JA.sample_mask_at_label_grid(m, a, box // stride, stride))(
            jnp.asarray(masks), aff))
    got = TA.sample_mask_at_label_grid(torch.from_numpy(masks),
                                       torch.from_numpy(np.asarray(aff)),
                                       box // stride, stride).numpy()
    assert got.shape == (n, 8, 8)
    np.testing.assert_allclose(got, want, atol=1e-5)


WARP_CASES = [
    # (source h, w), output, degrees, flips
    ((96, 96), 64, [40.0, -40.0], [False, True]),
    ((75, 101), 64, [-40.0, 17.0], [True, False]),        # not multiples of 16
    ((50, 131), 48, [0.0, 33.3], [False, False]),
]


@pytest.mark.parametrize("method", ["exact", "twopass"])
@pytest.mark.parametrize("case", range(len(WARP_CASES)))
def test_warp_matches_jax(method, case):
    (h, w), out, degrees, flips = WARP_CASES[case]
    rng = np.random.default_rng(10 + case)
    n = len(degrees)
    centers, scales = geometry(rng, n, h, w)
    params = draws(rng, n, degrees=degrees, flip=flips)
    images = rng.integers(0, 256, (n, h, w, 3)).astype(np.float32)   # uint8-valued
    aff = j_affines(centers, scales, params, out)
    jwarp = JA.warp_image if method == "exact" else JA.warp_image_twopass
    twarp = TA.warp_image if method == "exact" else TA.warp_image_twopass
    want = np.asarray(jax.vmap(lambda i, a: jwarp(i, a, out, 128.0))(jnp.asarray(images), aff))
    got = twarp(torch.from_numpy(images), torch.from_numpy(np.asarray(aff)), out, 128.0).numpy()
    assert got.shape == (n, out, out, 3)
    np.testing.assert_allclose(got, want, atol=WARP_ATOL)
    assert (np.abs(want - 128.0) < 1e-6).mean() < 0.9       # the border is not all of it


def test_twopass_stays_close_to_exact_on_smooth_image():
    yy, xx = np.mgrid[0:80, 0:80].astype(np.float32)
    img = np.stack([xx + 2 * yy, 3 * xx - yy, xx * 0 + 7.0], -1)[None]
    params = {"scale_mult": torch.tensor([0.9]), "degrees": torch.tensor([25.0]),
              "perturb": torch.zeros(1, 2), "flip": torch.tensor([False])}
    m = TA.affine_matrix(torch.tensor([[40.0, 40.0]]), torch.tensor([0.9]), params,
                         AugmentConfig(), 32)
    a = TA.warp_image(torch.from_numpy(img), m, 32, 0.0)
    b = TA.warp_image_twopass(torch.from_numpy(img), m, 32, 0.0)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-2)   # linear image: identical


def batch_inputs(rng, n, h, w, persons):
    joints = rng.uniform(0, w, (n, persons, 18, 3)).astype(np.float32)
    joints[..., 2] = rng.choice([0.0, 1.0, 2.0], (n, persons, 18))
    centers, scales = geometry(rng, n, h, w)
    return {
        "images": rng.integers(0, 256, (n, h, w, 3)).astype(np.float32),
        "masks": (rng.random((n, h, w)) > 0.2).astype(np.float32),
        "joints": joints, "centers": centers, "scales": scales,
    }


@pytest.mark.parametrize("method", ["twopass", "exact"])
def test_augment_batch_with_explicit_draws_matches_jax(method):
    """The JAX batch program draws from jax.random; the same draws, taken
    with the JAX package's own functions, go to the port as a dict."""
    rng = np.random.default_rng(4)
    n = 3
    b = batch_inputs(rng, n, 96, 80, 2)
    jm, ja = JModel(boxsize=64), JAug(max_persons=2, warp_method=method)
    key = jax.random.PRNGKey(5)
    want = JA.augment_batch(key, *(jnp.asarray(b[k]) for k in
                                   ("images", "masks", "joints", "centers", "scales")), jm, ja)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(n))
    params = {k: np.asarray(v) for k, v in
              jax.vmap(lambda k: JA.sample_params(k, ja))(keys).items()}
    got = TA.augment_batch({k: torch.from_numpy(v) for k, v in params.items()},
                           *(torch.from_numpy(b[k]) for k in
                             ("images", "masks", "joints", "centers", "scales")),
                           ModelConfig(boxsize=64),
                           AugmentConfig(max_persons=2, warp_method=method))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=AUGMENT_IMAGE_ATOL)
    # a 0/1 mask sampled at positions that differ by the same ulp
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=5e-5)
    np.testing.assert_allclose(got[2][..., :2].numpy(), np.asarray(want[2])[..., :2],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got[2][..., 2].numpy(), np.asarray(want[2])[..., 2])


def test_augment_batch_identity_when_not_training():
    rng = np.random.default_rng(6)
    b = batch_inputs(rng, 2, 64, 64, 2)
    b["centers"][:] = 32.0
    b["scales"][:] = 0.6
    args = [torch.from_numpy(b[k]) for k in ("images", "masks", "joints", "centers", "scales")]
    img, lbl, jts = TA.augment_batch(None, *args, ModelConfig(boxsize=64),
                                     AugmentConfig(max_persons=2), training=False)
    np.testing.assert_allclose(img.numpy(), b["images"], atol=1e-3)
    np.testing.assert_allclose(jts[..., :2].numpy(), b["joints"][..., :2], atol=1e-4)


def test_generator_draws_depend_on_seed_and_index_only():
    aug = AugmentConfig()
    a = TA.batch_params(torch.Generator().manual_seed(7), aug, 3)
    b = TA.batch_params(torch.Generator().manual_seed(7), aug, 5)
    c = TA.batch_params(torch.Generator().manual_seed(8), aug, 3)
    for k in a:
        assert torch.equal(a[k], b[k][:3])
    assert not torch.equal(a["degrees"], c["degrees"])
    many = TA.batch_params(torch.Generator().manual_seed(1), aug, 400)
    assert many["scale_mult"].min() >= aug.scale_min and many["scale_mult"].max() <= aug.scale_max
    assert many["degrees"].abs().max() <= aug.max_rotate_degree
    assert many["perturb"].abs().max() <= aug.center_perturb_max
    assert 0.35 < many["flip"].float().mean() < 0.65
    assert len(set(many["degrees"].tolist())) == 400


# --- GT rasterisation ----------------------------------------------------------

def gt_inputs(seed, n=3, persons=5, size=368, label=46):
    rng = np.random.default_rng(seed)
    j = np.full((n, persons, 18, 3), 2.0, np.float32)
    k = persons - 2
    j[:, :k, :, 0] = rng.uniform(0, size, (n, k, 18))
    j[:, :k, :, 1] = rng.uniform(0, size, (n, k, 18))
    j[:, :k, :, 2] = rng.choice([0.0, 1.0, 2.0], (n, k, 18), p=[0.6, 0.2, 0.2])
    j[0, 1] = j[0, 0] + np.asarray([3.0, -2.0, 0.0], np.float32)    # overlapping persons
    j[-1, :, :, 2] = 2.0                                             # one empty sample
    mask = rng.uniform(size=(n, label, label)).astype(np.float32)
    return j, mask


def check_labels(got, want, atol=1e-5):
    for name, g, w in zip(("paf", "heat"), got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=atol, err_msg=name)


def test_create_labels_matches_jnp_pallas_and_numpy():
    j, mask = gt_inputs(0)
    got = create_labels_plain(torch.from_numpy(j), torch.from_numpy(mask))
    got = [g.numpy() for g in got]
    assert got[0].shape == (3, 46, 46, 38) and got[1].shape == (3, 46, 46, 19)
    check_labels(got, j_create_labels(jnp.asarray(j), jnp.asarray(mask)))
    check_labels(got, create_labels_pallas(jnp.asarray(j), jnp.asarray(mask), interpret=True))
    for i in range(j.shape[0]):
        twin = gt_np.create_heatmaps_np(j[i].astype(np.float64), mask[i].astype(np.float64))
        np.testing.assert_allclose(got[0][i], twin[..., :38], atol=1e-5)
        np.testing.assert_allclose(got[1][i], twin[..., 38:], atol=1e-5)
    # the empty sample: no heat, background = mask, no PAF
    assert not got[0][-1].any() and not got[1][-1][..., :18].any()
    np.testing.assert_array_equal(got[1][-1][..., 18], mask[-1])
    assert (got[0][0] != 0).any() and (got[1][0][..., :18] > 0).any()


def test_create_labels_other_geometry_matches_jnp():
    j, mask = gt_inputs(1, n=2, persons=3, size=64, label=16)
    kw = dict(label_size=16, stride=4, sigma=3.0, paf_thre=5.0)
    got = TR.create_labels(torch.from_numpy(j), torch.from_numpy(mask), **kw)
    check_labels([g.numpy() for g in got],
                 j_create_labels(jnp.asarray(j), jnp.asarray(mask), **kw))


def test_create_labels_zero_mask_and_degenerate_limb():
    j, mask = gt_inputs(2)
    paf, heat = TR.create_labels(torch.from_numpy(j), torch.zeros(3, 46, 46))
    assert not paf.any() and not heat.any()
    # a limb whose two joints coincide paints nothing and divides by nothing
    j[:] = 2.0
    j[0, 0, :, :] = np.asarray([99.5, 123.5, 0.0], np.float32)   # a grid centre
    paf, heat = TR.create_labels(torch.from_numpy(j), torch.ones(3, 46, 46))
    assert torch.isfinite(paf).all() and not paf.any()
    assert heat[0, ..., :18].max() > 0.9


def test_labels_for_config_and_dispatch():
    j, mask = gt_inputs(3, n=1, persons=3, size=64, label=8)
    model, aug = ModelConfig(boxsize=64), AugmentConfig(max_persons=3)
    a = TR.labels_for_config(torch.from_numpy(j), torch.from_numpy(mask), model, aug)
    b = create_labels_plain(torch.from_numpy(j), torch.from_numpy(mask), 8, 8, 7.0, 8.0)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError):
        TR.create_labels(torch.from_numpy(j), torch.ones(1, 9, 8), label_size=8)
    with pytest.raises(ValueError):
        TR.create_labels(torch.from_numpy(j[:, :, :17]), torch.ones(1, 8, 8), label_size=8)


def test_planted_scene_uses_the_ports_rasteriser():
    """testing.planted_scene's labels are those of the numpy twin."""
    from tpupose_torch.ops import image
    from tpupose_torch.testing import person, planted_scene

    sizes = image.scale_sizes(368, 368, (1.0,), 368, 8)
    heats, pafs = planted_scene(sizes)
    rng = np.random.default_rng(3)
    joints = np.stack([person(110.0 + rng.normal() * 6, 200.0), person(255.0, 185.0)])
    twin = gt_np.create_heatmaps_np(joints)
    np.testing.assert_allclose(heats[0][0].numpy(), twin[..., 38:], atol=1e-5)
    np.testing.assert_allclose(pafs[0][0].numpy(), twin[..., :38], atol=1e-5)
