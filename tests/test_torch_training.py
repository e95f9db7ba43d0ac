"""The port's training path against the JAX package, on the CPU, at the
small sizes of tests/test_training.py (2 stages, boxsize 64, batch 2,
3 persons), from the same numpy-seeded batch and the same bridged
parameters.

The JAX step draws its augmentation from jax.random; the same draws, taken
with the JAX package's own functions from the same key, go to the port's
step as a dict.

Two precisions. In f32 two correct implementations of a ReLU network do
not agree tightly on gradients: where a pre-activation lies within
rounding of zero (a few of the ~2M in one forward here), the two
convolution routines put it on different sides, the ReLU passes the
gradient in one and blocks it in the other, and a bias with a gradient of
order 1 moves by more than 1e-5 over three steps. So the
algorithm — gradients, clipping, accumulation, momentum, multipliers,
weight decay, the schedule — is held to the JAX package with the
NETWORK's arithmetic in f64 (parameters, gradients, optimizer state,
augmentation and labels stay f32, as in training; boxsize 32 keeps f64
convolutions cheap; the exact warp, because the reference's two-pass warp
does not trace under x64): losses rtol 1e-6, gradients rtol 1e-4,
parameters atol 1e-6. The default two-pass warp gets the same f64 check
through the reference's preprocessed step, fed with images that the
reference warped outside x64. The default f32 configuration is then held
at what f32 allows: losses rtol 1e-4, parameters atol 5e-5 and, leaf by
leaf, within a twentieth of the distance that leaf moved, so that an
update left out cannot pass. bf16: losses rtol 5e-2. A frozen group and a
checkpoint resume are bit-equal. One more pair of runs at a rate past the
stable one shows the two steps diverging together.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupose.config import AugmentConfig as JAug, ModelConfig as JModel
from tpupose.config import PoseConfig as JPose, TrainConfig as JTrain
from tpupose.gt import augment as JA
from tpupose.gt.rasterize import create_labels as j_create_labels
from tpupose.models import OpenPose as JOpenPose
from tpupose.ops.image import normalize as j_normalize
from tpupose.training import create_state as j_create_state
from tpupose.training import make_train_step as j_make_train_step
from tpupose.training import param_labels as j_param_labels
from tpupose.training import stagewise_losses as j_stagewise_losses
from tpupose.training.optimizer import multipliers as j_multipliers
from tpupose.training.optimizer import step_decay_schedule as j_schedule
from tpupose.training.train import make_eval_step as j_make_eval_step
from tpupose.training.train import make_preprocessed_step as j_make_preprocessed_step
from tpupose_torch.config import AugmentConfig, ModelConfig, PoseConfig, TrainConfig
from tpupose_torch.data.pipeline import synthetic_batches
from tpupose_torch.models import OpenPose, weights
from tpupose_torch.models.openpose import param_group
from tpupose_torch.training import checkpoint, create_state, make_eval_step
from tpupose_torch.training import make_preprocessed_step, make_train_step, stagewise_losses
from tpupose_torch.training.loop import train
from tpupose_torch.training.optimizer import multipliers, param_labels, step_decay_schedule
from tpupose_torch.testing import limit_threads

limit_threads()

TRAIN_KW = dict(batch_size=2, base_lr=1e-4)
J_SMALL = JPose(model=JModel(boxsize=64, compute_dtype="float32"),
                augment=JAug(max_persons=3), train=JTrain(**TRAIN_KW))
SMALL = PoseConfig(model=ModelConfig(boxsize=64, compute_dtype="float32"),
                   augment=AugmentConfig(max_persons=3), train=TrainConfig(**TRAIN_KW))
# f64 network arithmetic (see the module docstring)
J_CFG64 = JPose(model=JModel(boxsize=32, compute_dtype="float32"),
                augment=JAug(max_persons=3, warp_method="exact"), train=JTrain(**TRAIN_KW))
CFG64 = PoseConfig(model=ModelConfig(boxsize=32, compute_dtype="float32"),
                   augment=AugmentConfig(max_persons=3, warp_method="exact"),
                   train=TrainConfig(**TRAIN_KW))
KEYS = ("images", "masks", "joints", "centers", "scales")


def small_batch(rng, n=2, h=96, w=96, p=3):
    joints = np.full((n, p, 18, 3), 2.0, np.float32)
    joints[:, 0, :, 0] = rng.uniform(10, w - 10, (n, 18))
    joints[:, 0, :, 1] = rng.uniform(10, h - 10, (n, 18))
    joints[:, 0, :, 2] = 0.0
    return {
        "images": rng.uniform(0, 255, (n, h, w, 3)).astype(np.float32),
        "masks": (rng.uniform(size=(n, h, w)) > 0.1).astype(np.float32),
        "joints": joints,
        "centers": np.tile(np.asarray([[w / 2, h / 2]], np.float32), (n, 1)),
        "scales": np.full((n,), 0.8, np.float32),
    }


def with_train(cfg, **kw):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **kw))


def jax_draws(key, n, aug):
    """The draws JAX's augment_batch makes from ``key`` for n samples."""
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(n))
    out = jax.vmap(lambda k: JA.sample_params(k, aug))(keys)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_params_track(got, want, start, atol):
    """Every leaf of ``got`` within ``atol`` of ``want`` and within a
    twentieth of the distance ``want`` moved from ``start`` (plus rounding
    of the parameter itself), and every leaf did move."""
    for name, p in got.items():
        moved = (want[name] - start[name]).abs().max().item()
        err = (p - want[name]).abs().max().item()
        assert moved > 0, name
        assert err <= atol, (name, err)
        assert err <= 0.05 * moved + 1e-7, (name, err, moved)


def models64():
    """The two networks computing in f64 (call under jax.enable_x64)."""
    return (JOpenPose(num_stages=2, dtype=jnp.float64, head_dtype=jnp.float64),
            OpenPose(num_stages=2, dtype=torch.float64, head_dtype=torch.float64))


@pytest.fixture(scope="module")
def setup():
    jmodel = JOpenPose(num_stages=2, dtype=jnp.float32)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    params = numpy_tree(jmodel.init(jax.random.PRNGKey(0), x)["params"])
    return jmodel, params, OpenPose(num_stages=2, dtype=torch.float32)


def test_stagewise_losses_match_jax():
    rng = np.random.default_rng(0)
    n, l = 2, 8
    outs = [(rng.normal(size=(n, l, l, 38)).astype(np.float32),
             rng.normal(size=(n, l, l, 19)).astype(np.float32)) for _ in range(3)]
    mask = (rng.uniform(size=(n, l, l)) > 0.3).astype(np.float32)
    paf_gt = rng.normal(size=(n, l, l, 38)).astype(np.float32) * mask[..., None]
    heat_gt = rng.normal(size=(n, l, l, 19)).astype(np.float32) * mask[..., None]
    for denom in (None, 5):
        want = j_stagewise_losses([(jnp.asarray(p), jnp.asarray(h)) for p, h in outs],
                                  jnp.asarray(paf_gt), jnp.asarray(heat_gt),
                                  jnp.asarray(mask), denom)
        got = stagewise_losses([(torch.from_numpy(p), torch.from_numpy(h)) for p, h in outs],
                               torch.from_numpy(paf_gt), torch.from_numpy(heat_gt),
                               torch.from_numpy(mask), denom)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    bf = stagewise_losses([(torch.from_numpy(p).bfloat16(), torch.from_numpy(h))
                           for p, h in outs], torch.from_numpy(paf_gt),
                          torch.from_numpy(heat_gt), torch.from_numpy(mask))
    assert bf["total"].dtype == torch.float32            # bf16 heads promote
    np.testing.assert_allclose(float(bf["total"]), float(want["total"]) * 5 / n, rtol=2e-2)


def test_param_labels_multipliers_and_schedule_equal_jax(setup):
    _, params, _ = setup
    jlabels = j_param_labels(params)
    flat = {}
    for scope, layers in jlabels.items():
        for layer, leaves in layers.items():
            for leaf, label in leaves.items():
                flat[f"{scope}.{layer}.{'weight' if leaf == 'kernel' else 'bias'}"] = label
    assert param_labels(weights.from_flax(params)) == flat
    assert set(flat.values()) == {"vgg_w", "vgg_b", "cpm_w", "cpm_b", "stage1_w",
                                  "stage1_b", "stageT_w", "stageT_b"}
    assert param_group("stage1_L2.conv1.weight") == param_group(["stage1_L2", "conv1"]) == "stage1"
    for kw in ({}, {"vgg_lr_mult": 0.0}, {"vgg_lr_mult": 0.5, "stageT_b_mult": 3.0}):
        assert multipliers(TrainConfig(**kw)) == j_multipliers(JTrain(**kw))
    assert multipliers(TrainConfig().frozen_vgg())["vgg_b"] == 0.0
    kw = dict(base_lr=1e-3, lr_gamma=0.5, lr_step=100)
    s, js = step_decay_schedule(TrainConfig(**kw)), j_schedule(JTrain(**kw))
    for step in (0, 99, 100, 250, 1000):
        assert s(step) == pytest.approx(float(js(step)), rel=1e-6)
    assert s(99) == 1e-3 and s(100) == 5e-4


def jax_targets(batch, draws, box=64):
    """Augmented, normalised images and labels of ``batch`` under the
    explicit ``draws``, computed by the JAX package's functions."""
    p = {k: jnp.asarray(v.numpy()) for k, v in draws.items()}

    def one(img, msk, jts, ctr, scl, pp):
        m = JA.affine_matrix(ctr, scl, pp, J_SMALL.augment, box)
        return (JA.warp_image(img, m, box, 128.0),
                JA.sample_mask_at_label_grid(msk, m, box // 8, 8),
                JA.transform_joints(jts, m, pp["flip"], box))

    img, lbl, jts = jax.vmap(one)(*(jnp.asarray(batch[k]) for k in KEYS), p)
    paf, heat = j_create_labels(jts, lbl, label_size=box // 8, stride=8, sigma=7.0,
                                paf_thre=8.0)
    return {"images_norm": j_normalize(img, "bgr"), "paf_gt": paf, "heat_gt": heat,
            "label_mask": lbl}


def test_gradients_match_jax(setup):
    _, params, _ = setup
    batch = small_batch(np.random.default_rng(1), h=48, w=48)
    draws = jax_draws(jax.random.PRNGKey(3), 2, J_CFG64.augment)
    t = jax_targets(batch, draws, box=32)
    tt = {k: torch.from_numpy(np.array(v)) for k, v in t.items()}
    with jax.enable_x64(True):
        jmodel, model = models64()

        def loss_fn(p):
            outs = jmodel.apply({"params": p}, t["images_norm"])
            return j_stagewise_losses(outs, t["paf_gt"], t["heat_gt"], t["label_mask"])["total"]

        want = weights.from_flax(numpy_tree(jax.grad(loss_fn)(params)))
    leaves = {k: v.requires_grad_() for k, v in weights.from_flax(params).items()}
    outs = torch.func.functional_call(model, leaves, (tt["images_norm"],))
    total = stagewise_losses(outs, tt["paf_gt"], tt["heat_gt"], tt["label_mask"])["total"]
    grads = torch.autograd.grad(total, list(leaves.values()))
    for name, g in zip(leaves, grads):
        scale = want[name].abs().max().item()
        assert scale > 0 and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


VARIANTS = {
    "plain": {},
    "clip_norm": {"clip_norm": 5.0},
    "accum_steps": {"accum_steps": 2},
    "frozen_vgg": {"vgg_lr_mult": 0.0},
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_three_train_steps_match_jax(setup, variant):
    with jax.enable_x64(True):
        three_train_steps(setup[1], variant)


def three_train_steps(params, variant):
    jmodel, model = models64()
    jcfg, cfg = with_train(J_CFG64, **VARIANTS[variant]), with_train(CFG64, **VARIANTS[variant])
    batch = small_batch(np.random.default_rng(2), h=48, w=48)
    n_steps = 4 if variant == "accum_steps" else 3

    jstate, jtx = j_create_state(jcfg, jax.tree.map(jnp.asarray, params))
    jstep = j_make_train_step(jcfg, jmodel, jtx)
    jtree = jstate.tree()
    state, tx = create_state(cfg, weights.from_flax(params), device="cpu")
    step = make_train_step(cfg, model, tx)
    tree = state.tree()
    start = {k: v.clone() for k, v in tree["params"].items()}

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for i in range(n_steps):
        key = jax.random.PRNGKey(100 + i)
        draws = jax_draws(key, 2, jcfg.augment)
        jtree, jlosses = jstep(jtree, key, jbatch)
        tree, losses = step(tree, draws, batch)
        assert set(losses) == set(jlosses) == {"stage1_L1", "stage1_L2", "stage2_L1",
                                               "stage2_L2", "total"}
        for k in jlosses:
            np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=1e-6,
                                       err_msg=f"step {i} {k}")
    assert tree["step"] == int(jtree["step"]) == n_steps

    want = weights.from_flax(numpy_tree(jtree["params"]))
    moved = 0.0
    for name, p in tree["params"].items():
        assert p.dtype == torch.float32
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-6, err_msg=name)
        moved = max(moved, (want[name] - start[name]).abs().max().item())
    assert moved > 1e-4          # the steps did move the parameters
    if variant == "frozen_vgg":
        for name, p in tree["params"].items():
            if name.startswith("vgg."):
                assert torch.equal(p, start[name]), name
                assert name not in tree["opt_state"]["trace"]
        assert not torch.equal(tree["params"]["stage2_L1.conv1.weight"],
                               start["stage2_L1.conv1.weight"])

    # the momentum crosses the bridge in both directions
    trace = weights.momentum_from_optax(jtree["opt_state"])
    assert set(trace) == set(tree["opt_state"]["trace"])
    for name, m in tree["opt_state"]["trace"].items():
        scale = max(trace[name].abs().max().item(), 1e-3)
        np.testing.assert_allclose(m.numpy(), trace[name].numpy(), atol=1e-5 * scale,
                                   err_msg=name)
    if variant == "plain":
        # carry the port's state into the JAX step: one more step each
        jtree = {"params": jax.tree.map(jnp.asarray, weights.to_flax(tree["params"])),
                 "opt_state": jax.tree.map(
                     jnp.asarray, weights.momentum_into_optax(numpy_tree(jtree["opt_state"]),
                                                              tree["opt_state"]["trace"])),
                 "step": jtree["step"]}
        key = jax.random.PRNGKey(200)
        jtree, jlosses = jstep(jtree, key, jbatch)
        tree, losses = step(tree, jax_draws(key, 2, jcfg.augment), batch)
        np.testing.assert_allclose(float(losses["total"]), float(jlosses["total"]), rtol=1e-6)
        want = weights.from_flax(numpy_tree(jtree["params"]))
        for name, p in tree["params"].items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-6, err_msg=name)


def test_f32_default_train_steps_match_jax(setup):
    """The f32 network with the default two-pass warp, at f32's tolerance."""
    jmodel, params, model = setup
    batch = small_batch(np.random.default_rng(2))
    jstate, jtx = j_create_state(J_SMALL, jax.tree.map(jnp.asarray, params))
    jstep = j_make_train_step(J_SMALL, jmodel, jtx)
    state, tx = create_state(SMALL, weights.from_flax(params), device="cpu")
    step = make_train_step(SMALL, model, tx)
    jtree, tree = jstate.tree(), state.tree()
    start = {k: v.clone() for k, v in tree["params"].items()}
    for i in range(3):
        key = jax.random.PRNGKey(100 + i)
        jtree, jlosses = jstep(jtree, key, {k: jnp.asarray(v) for k, v in batch.items()})
        tree, losses = step(tree, jax_draws(key, 2, J_SMALL.augment), batch)
        for k in jlosses:
            np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
    assert_params_track(tree["params"], weights.from_flax(numpy_tree(jtree["params"])),
                        start, atol=5e-5)


def test_two_pass_train_steps_match_jax(setup):
    """The default two-pass warp through make_train_step with the network in
    f64. The reference's two-pass warp does not trace under x64, so its
    augment_batch runs outside and its preprocessed step takes the result."""
    params = setup[1]
    jcfg = dataclasses.replace(J_CFG64, augment=JAug(max_persons=3))
    cfg = dataclasses.replace(CFG64, augment=AugmentConfig(max_persons=3))
    assert jcfg.augment.warp_method == cfg.augment.warp_method == "twopass"
    batch = small_batch(np.random.default_rng(2), h=48, w=48)
    keys = [jax.random.PRNGKey(100 + i) for i in range(3)]
    pre, draws = [], []
    for key in keys:        # outside x64, where the draws of a key differ
        draws.append(jax_draws(key, 2, jcfg.augment))
        img, lbl, jts = JA.augment_batch(key, *(jnp.asarray(batch[k]) for k in KEYS),
                                         jcfg.model, jcfg.augment)
        paf, heat = j_create_labels(jts, lbl, label_size=4, stride=8, sigma=7.0, paf_thre=8.0)
        pre.append({"images_norm": j_normalize(img, "bgr"), "paf_gt": paf, "heat_gt": heat,
                    "label_mask": lbl})
    with jax.enable_x64(True):
        jmodel, model = models64()
        jstate, jtx = j_create_state(jcfg, jax.tree.map(jnp.asarray, params))
        jstep = j_make_preprocessed_step(jcfg, jmodel, jtx)
        state, tx = create_state(cfg, weights.from_flax(params), device="cpu")
        step = make_train_step(cfg, model, tx)
        jtree, tree = jstate.tree(), state.tree()
        start = {k: v.clone() for k, v in tree["params"].items()}
        for i in range(3):
            jtree, jlosses = jstep(jtree, pre[i])
            tree, losses = step(tree, draws[i], batch)
            for k in jlosses:
                np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=1e-6,
                                           err_msg=f"step {i} {k}")
        assert_params_track(tree["params"], weights.from_flax(numpy_tree(jtree["params"])),
                            start, atol=1e-6)


def test_past_the_stable_rate_both_steps_diverge_together(setup):
    """At the small size a base_lr of 0.01 still descends and 0.05 does not:
    the reference's step and the port's, from the same parameters, on the
    same batch with the same draws, rise together by over twenty decades in
    four steps. A loss that explodes at a rate past the stable one is the
    recipe's behaviour, not the port's."""
    params = setup[1]
    batch = small_batch(np.random.default_rng(2), h=48, w=48)
    key = jax.random.PRNGKey(100)
    with jax.enable_x64(True):
        jmodel, model = models64()
        jcfg, cfg = with_train(J_CFG64, base_lr=0.05), with_train(CFG64, base_lr=0.05)
        assert multipliers(cfg.train) == j_multipliers(jcfg.train)
        jstate, jtx = j_create_state(jcfg, jax.tree.map(jnp.asarray, params))
        jstep = j_make_train_step(jcfg, jmodel, jtx)
        state, tx = create_state(cfg, weights.from_flax(params), device="cpu")
        step = make_train_step(cfg, model, tx)
        jtree, tree = jstate.tree(), state.tree()
        draws = jax_draws(key, 2, jcfg.augment)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        totals, jtotals = [], []
        for _ in range(4):
            jtree, jlosses = jstep(jtree, key, jbatch)
            tree, losses = step(tree, draws, batch)
            totals.append(float(losses["total"]))
            jtotals.append(float(jlosses["total"]))
    assert np.isfinite(totals).all() and np.isfinite(jtotals).all()
    assert all(b > a for a, b in zip(totals, totals[1:])), totals
    assert all(b > a for a, b in zip(jtotals, jtotals[1:])), jtotals
    assert totals[-1] > 1e20 * totals[0] and jtotals[-1] > 1e20 * jtotals[0]
    np.testing.assert_allclose(totals, jtotals, rtol=1e-4)


def test_bf16_train_steps_match_jax_loosely():
    jcfg = dataclasses.replace(J_SMALL, model=JModel(boxsize=64, compute_dtype="bfloat16"))
    cfg = dataclasses.replace(SMALL, model=ModelConfig(boxsize=64, compute_dtype="bfloat16"))
    jmodel = JOpenPose(num_stages=2, dtype=jnp.bfloat16)
    params = numpy_tree(jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))["params"])
    model = OpenPose(num_stages=2, dtype=torch.bfloat16)
    batch = small_batch(np.random.default_rng(5))
    jstate, jtx = j_create_state(jcfg, jax.tree.map(jnp.asarray, params))
    jstep = j_make_train_step(jcfg, jmodel, jtx)
    state, tx = create_state(cfg, weights.from_flax(params), device="cpu")
    step = make_train_step(cfg, model, tx)
    jtree, tree = jstate.tree(), state.tree()
    for i in range(3):
        key = jax.random.PRNGKey(300 + i)
        jtree, jlosses = jstep(jtree, key, {k: jnp.asarray(v) for k, v in batch.items()})
        tree, losses = step(tree, jax_draws(key, 2, jcfg.augment), batch)
        for k in jlosses:
            np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=5e-2,
                                       err_msg=f"step {i} {k}")


def test_eval_and_preprocessed_steps_match_jax(setup):
    jmodel, params, model = setup
    batch = small_batch(np.random.default_rng(6))
    batch["masks"] = (batch["masks"] * 255).astype(np.uint8)        # the uint8 contract
    batch["weight"] = np.asarray([1.0, 0.0], np.float32)            # one padded row
    want = j_make_eval_step(J_SMALL, jmodel, loss_denom=1)(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()})
    state, tx = create_state(SMALL, weights.from_flax(params), device="cpu")
    got = make_eval_step(SMALL, model, loss_denom=1)(state.params, batch)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)

    del batch["weight"]
    batch["masks"] = batch["masks"].astype(np.float32) / 255.0
    pre = jax_targets(batch, jax_draws(jax.random.PRNGKey(9), 2, J_SMALL.augment))
    jstate, jtx = j_create_state(J_SMALL, jax.tree.map(jnp.asarray, params))
    jtree, jlosses = j_make_preprocessed_step(J_SMALL, jmodel, jtx)(jstate.tree(), pre)
    start = {k: v.clone() for k, v in state.params.items()}
    tree, losses = make_preprocessed_step(SMALL, model, tx)(
        state.tree(), {k: np.array(v) for k, v in pre.items()})
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=1e-4, err_msg=k)
    # f32 network: see the module docstring
    assert_params_track(tree["params"], weights.from_flax(numpy_tree(jtree["params"])),
                        start, atol=5e-5)
    assert tree["step"] == 1


def fresh(cfg, seed=0):
    model = OpenPose(num_stages=cfg.model.num_stages, dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    state, tx = create_state(cfg, model.state_dict(), device="cpu")
    return model, state.tree(), make_train_step(cfg, model, tx)


def run_steps(step, tree, batch, first, count):
    losses = []
    for i in range(first, first + count):
        tree, out = step(tree, torch.Generator().manual_seed(50 + i), batch)
        losses.append({k: float(v) for k, v in out.items()})
    return tree, losses


@pytest.mark.parametrize("accum", [1, 2])
def test_checkpoint_roundtrip_and_resume_bit_equal(tmp_path, accum):
    cfg = dataclasses.replace(with_train(SMALL, accum_steps=accum),
                              model=ModelConfig(boxsize=64, compute_dtype="float32",
                                                num_stages=2))
    batch = small_batch(np.random.default_rng(7))
    d = str(tmp_path / "ckpt")
    assert checkpoint.latest_step(d) is None and checkpoint.restore_params(d) is None

    _, tree, step = fresh(cfg)
    assert checkpoint.restore(d, tree) is None
    through, losses_through = run_steps(step, tree, batch, 0, 4 if accum == 1 else 5)

    n_first = 2 if accum == 1 else 3          # 3: mid-accumulation
    _, tree, step = fresh(cfg)
    tree, _ = run_steps(step, tree, batch, 0, n_first)
    assert checkpoint.save(d, tree) == n_first
    assert checkpoint.latest_step(d) == n_first
    assert not [f for f in os.listdir(d) if "tmp" in f]

    _, template, step = fresh(cfg, seed=9)    # other weights: all must be replaced
    restored = checkpoint.restore(d, template)
    assert restored["step"] == n_first
    assert restored["opt_state"]["count"] == tree["opt_state"]["count"]
    for name, p in tree["params"].items():
        assert torch.equal(restored["params"][name], p), name
        assert restored["params"][name].stride() == p.stride()
    for name, m in tree["opt_state"]["trace"].items():
        assert torch.equal(restored["opt_state"]["trace"][name], m), name
    resumed, losses_resumed = run_steps(step, restored, batch, n_first, 2)
    assert losses_resumed == losses_through[n_first:]
    for name, p in through["params"].items():
        assert torch.equal(resumed["params"][name], p), name

    flax = checkpoint.restore_params(d)
    np.testing.assert_array_equal(flax["vgg"]["conv1_1"]["kernel"],
                                  weights.to_flax(tree["params"])["vgg"]["conv1_1"]["kernel"])
    assert flax["vgg"]["conv1_1"]["kernel"].shape == (3, 3, 3, 64)    # HWIO, the flax layout


def test_checkpoint_retention(tmp_path):
    cfg = dataclasses.replace(SMALL, model=ModelConfig(boxsize=64, compute_dtype="float32",
                                                       num_stages=2))
    _, tree, _ = fresh(cfg)
    d = str(tmp_path / "ckpt")
    for s in (1, 2, 3, 4):
        tree["step"] = s
        checkpoint.save(d, tree, max_to_keep=2)
    assert sorted(os.listdir(d)) == ["step_000000003.npz", "step_000000004.npz"]
    assert checkpoint.latest_step(d) == 4


def test_train_loop_writes_csv_and_checkpoint_and_resumes(tmp_path):
    cfg = PoseConfig(model=ModelConfig(boxsize=64, compute_dtype="float32", num_stages=2),
                     augment=AugmentConfig(max_persons=3),
                     train=TrainConfig(batch_size=2, base_lr=1e-4, log_every=1,
                                       checkpoint_every=2))
    seen = []
    out = train(cfg, synthetic_batches(cfg, 96, 96, n_batches=8), workdir=str(tmp_path),
                max_steps=3, seed=1, device="cpu", on_step=lambda i, l: seen.append((i, l)),
                val_batches=lambda: synthetic_batches(cfg, 96, 96, seed=5, n_batches=1),
                val_every=2)
    assert out["steps"] == 3 and out["state"]["step"] == 3
    assert [i for i, _ in seen] == [1, 2, 3]
    assert all(np.isfinite(list(l.values())).all() for _, l in seen)
    assert out["last_losses"] == seen[-1][1]
    rows = open(tmp_path / "training.csv").read().strip().splitlines()
    assert rows[0] == "step,stage1_L1,stage1_L2,stage2_L1,stage2_L2,total" and len(rows) == 4
    assert len(open(tmp_path / "validation.csv").read().strip().splitlines()) == 3
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["step_000000002.npz",
                                                            "step_000000003.npz"]
    # a second call resumes at step 3 and matches an uninterrupted run of 4
    again = train(cfg, synthetic_batches(cfg, 96, 96, seed=3, n_batches=1),
                  workdir=str(tmp_path), max_steps=4, seed=1, device="cpu")
    assert again["steps"] == 1 and again["state"]["step"] == 4

    def feed():
        yield from synthetic_batches(cfg, 96, 96, n_batches=3)
        yield from synthetic_batches(cfg, 96, 96, seed=3, n_batches=1)

    whole = train(cfg, feed(), workdir=str(tmp_path / "whole"), max_steps=4, seed=1,
                  device="cpu")
    assert whole["last_losses"] == again["last_losses"]
    for name, p in whole["state"]["params"].items():
        assert torch.equal(again["state"]["params"][name], p), name


def test_train_loop_refuses_a_wrong_batch_size_and_a_missing_card(tmp_path):
    cfg = PoseConfig(model=ModelConfig(boxsize=64, compute_dtype="float32", num_stages=2),
                     augment=AugmentConfig(max_persons=3), train=TrainConfig(batch_size=3))
    other = dataclasses.replace(cfg, train=TrainConfig(batch_size=2))
    with pytest.raises(ValueError, match="batch of 2"):
        train(cfg, synthetic_batches(other, 96, 96), workdir=str(tmp_path), max_steps=1,
              device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train(cfg, synthetic_batches(cfg, 96, 96), workdir=str(tmp_path), max_steps=1)


def test_remat_gradients_equal_the_plain_network_and_jax(setup):
    """``OpenPose(remat=True)`` recomputes each stage branch in the backward
    pass: in f32 its losses and gradients equal those of ``remat=False`` bit
    for bit, in f64 both equal the JAX network's with ``remat=True`` as the
    gradient test holds them; under ``no_grad`` the forward is unchanged."""
    _, params, _ = setup
    batch = small_batch(np.random.default_rng(1), h=48, w=48)
    draws = jax_draws(jax.random.PRNGKey(3), 2, J_CFG64.augment)
    t = jax_targets(batch, draws, box=32)
    tt = {k: torch.from_numpy(np.array(v)) for k, v in t.items()}

    def port_grads(model):
        leaves = {k: v.requires_grad_() for k, v in weights.from_flax(params).items()}
        outs = torch.func.functional_call(model, leaves, (tt["images_norm"].to(model.dtype),))
        total = stagewise_losses(outs, tt["paf_gt"], tt["heat_gt"], tt["label_mask"])["total"]
        return total.detach(), dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))

    plain = port_grads(OpenPose(num_stages=2, dtype=torch.float32))
    remat = port_grads(OpenPose(num_stages=2, dtype=torch.float32, remat=True))
    assert torch.equal(plain[0], remat[0])
    assert all(torch.equal(plain[1][k], remat[1][k]) for k in plain[1])

    with jax.enable_x64(True):
        jmodel = JOpenPose(num_stages=2, dtype=jnp.float64, head_dtype=jnp.float64, remat=True)

        def loss_fn(p):
            outs = jmodel.apply({"params": p}, t["images_norm"])
            return j_stagewise_losses(outs, t["paf_gt"], t["heat_gt"], t["label_mask"])["total"]

        want = weights.from_flax(numpy_tree(jax.grad(loss_fn)(params)))
    for remat_on in (False, True):
        _, got = port_grads(OpenPose(num_stages=2, dtype=torch.float64,
                                     head_dtype=torch.float64, remat=remat_on))
        for name, g in got.items():
            scale = want[name].abs().max().item()
            np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=name)
    model = OpenPose(num_stages=2, dtype=torch.float32, remat=True)
    model.load_state_dict(weights.from_flax(params))
    with torch.no_grad():
        a = model(tt["images_norm"])
    model.remat = False
    with torch.no_grad():
        b = model(tt["images_norm"])
    assert all(torch.equal(x, y) for pa, pb in zip(a, b) for x, y in zip(pa, pb))
