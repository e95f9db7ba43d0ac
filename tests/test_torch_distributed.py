"""Data-parallel training and inference of the port over a real
``torch.distributed`` process group: 2 (or 4) ranks spawned on this host,
each on the CPU, joined by ``parallel.distributed.init_multihost`` over
a local TCP rendezvous with the gloo backend.

The counterparts of tests/_multihost_worker.py (init with an explicit
``process_id=0``, ``is_primary``, a global sum, one data-parallel step),
tests/test_parallel.py's padded batch (batch 10 over 4 ranks, padded to
12) and tests/test_multichip_durability.py's sharded trajectory (3 steps
of ``train(use_mesh=True)`` over a pre-padded ``.tpr`` feed): each held
to the single-process step of the port on the same global batch and the
same draws, losses within 1e-4 relative and parameters within 1e-5, as
the JAX package holds its mesh. Plus a checkpoint written by the 2-rank
run and restored by one process, and ``multihost_process_batch`` with its
peak-overflow switch decided over the global batch.

This file imports no JAX: the spawned ranks import it to find their
functions.
"""

import os
import sys

import numpy as np
import pytest
import torch

from tpupose_torch.config import AugmentConfig, InferenceConfig, ModelConfig, PoseConfig
from tpupose_torch.config import TrainConfig
from tpupose_torch.data import hdf5 as hdf5_io
from tpupose_torch.data import pipeline, tpr
from tpupose_torch.gt.augment import batch_params
from tpupose_torch.infer import PoseEstimator
from tpupose_torch.models import OpenPose
from tpupose_torch.parallel.sharding import pad_batch
from tpupose_torch.testing import limit_threads, spawn_ranks
from tpupose_torch.training import checkpoint, create_state, loop, make_train_step

limit_threads()

STEP_CFG = PoseConfig(model=ModelConfig(boxsize=64, num_stages=1, compute_dtype="float32"),
                      augment=AugmentConfig(max_persons=2))
TRAIN_CFG = PoseConfig(model=ModelConfig(boxsize=64, num_stages=1, compute_dtype="float32"),
                       augment=AugmentConfig(max_persons=2),
                       train=TrainConfig(batch_size=4, log_every=1, checkpoint_every=3))
INFER_CFG = dict(boxsize=64, num_stages=2, compute_dtype="float32")


def _rank_setup(rank, world, address):
    """What every rank does first: one intra-op thread, no tensorflow (the
    TensorBoard writer needs only the tensorboard package), and the group,
    with a RANK variable that an explicit process_id must win over."""
    sys.modules["tensorflow"] = None
    torch.set_num_threads(1)
    os.environ["RANK"] = str(world + 3)
    from tpupose_torch.parallel.distributed import init_multihost

    return init_multihost(address, num_processes=world, process_id=rank)


def step_batch(n, seed):
    rng = np.random.default_rng(seed)
    joints = np.full((n, 2, 18, 3), 2.0, np.float32)
    joints[:, 0, :, 0] = rng.uniform(10, 86, (n, 18))
    joints[:, 0, :, 1] = rng.uniform(10, 86, (n, 18))
    joints[:, 0, :, 2] = 0.0
    return {
        "images": rng.uniform(0, 255, (n, 96, 96, 3)).astype(np.float32),
        "masks": np.ones((n, 96, 96), np.float32),
        "joints": joints,
        "centers": np.tile(np.asarray([[48.0, 48.0]], np.float32), (n, 1)),
        "scales": np.full((n,), 0.8, np.float32),
    }


def one_step(batch, draws, n_real, all_reduce=None):
    """One step of the 1-stage network from its seeded init; (losses, params)."""
    cfg = PoseConfig(model=STEP_CFG.model, augment=STEP_CFG.augment,
                     train=TrainConfig(batch_size=n_real))
    model = OpenPose(num_stages=1, dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    state, tx = create_state(cfg, model.state_dict(), "cpu")
    step = make_train_step(cfg, model, tx, loss_denom=n_real, all_reduce=all_reduce)
    tree, losses = step(state.tree(), draws, batch)
    return {k: float(v) for k, v in losses.items()}, tree["params"]


def rows(tree, rank, world):
    n = next(iter(tree.values())).shape[0] // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in tree.items()}


def estimator(max_peaks):
    est = PoseEstimator(PoseConfig(model=ModelConfig(**INFER_CFG),
                                   inference=InferenceConfig(scale_search=(1.0,),
                                                             max_peaks=max_peaks,
                                                             peak_compact_tiers=())),
                        seed=0, device="cpu")
    with torch.no_grad():
        for branch in (est.model.stage2_L1, est.model.stage2_L2):
            branch.out.weight.mul_(3000.0)
    return est


def infer_images():
    return (np.random.default_rng(11).random((2, 64, 80, 3)) * 255).astype(np.uint8)


def write_tpr(path, n=16, size=64):
    """A pre-padded .tpr dataset at the train geometry."""
    rng = np.random.default_rng(5)
    with tpr.TprWriter(path) as w:
        for _ in range(n):
            joints = np.full((1, 18, 3), 2.0, np.float32)
            joints[0, :, :2] = rng.uniform(8, size - 8, (18, 2))
            joints[0, :, 2] = 0.0
            sample = {"image": rng.integers(0, 255, (size, size, 3), np.uint8),
                      "mask": np.ones((size, size), np.float32), "joints": joints,
                      "center": np.float32([size / 2, size / 2]),
                      "scale_provided": np.float32(0.8),
                      "areas": hdf5_io.estimate_areas(joints)}
            p = hdf5_io.pad_sample(sample, size, size, 2)
            meta = tpr._meta_from_sample(p)
            meta["prepadded"] = {"max_persons": 2}
            w.add(p["image"], np.round(p["mask"] * 255).astype(np.uint8), meta)
    return path


def train_run(path, workdir, max_steps, use_mesh=True):
    feed = pipeline.dataset_batches(path, TRAIN_CFG, target_h=64, target_w=64, shuffle_seed=7,
                                    shard=None)
    hist = []
    try:
        out = loop.train(TRAIN_CFG, feed, workdir=workdir, max_steps=max_steps, seed=21,
                         use_mesh=use_mesh, device="cpu",
                         on_step=lambda i, losses: hist.append(losses["total"]))
    finally:
        feed.close()
    return out, hist


# --- what the ranks run ---------------------------------------------------------------------


def two_rank_job(rank, world, address, path, workdir, max_peaks):
    import torch.distributed as dist

    from tpupose_torch.parallel.distributed import is_primary
    from tpupose_torch.parallel.inference import multihost_process_batch

    out = {"init": _rank_setup(rank, world, address), "primary": is_primary(),
           "rank": dist.get_rank(), "world": dist.get_world_size(),
           "backend": dist.get_backend()}
    total = torch.full((1, 4), float(rank + 1))
    dist.all_reduce(total)
    out["sum"] = float(total.sum())
    # one data-parallel step: the global batch of 2, one row each
    batch = step_batch(2, seed=7)
    draws = batch_params(torch.Generator().manual_seed(1), STEP_CFG.augment, 2)
    out["step"] = one_step(rows(batch, rank, world), rows(draws, rank, world), 2, dist.all_reduce)
    # 3 steps of the loop over the .tpr feed, every rank reading the same stream
    res, hist = train_run(path, workdir, 3)
    out["train"] = (res["steps"], hist, res["state"]["params"])
    # inference: each rank decodes its row of the global batch of 2
    out["people"] = multihost_process_batch(estimator(max_peaks), infer_images()[rank:rank + 1])
    dist.destroy_process_group()
    return out


def four_rank_job(rank, world, address):
    import torch.distributed as dist

    _rank_setup(rank, world, address)
    batch = step_batch(10, seed=3)
    padded, n_real = pad_batch(batch, world)
    draws = batch_params(torch.Generator().manual_seed(5), STEP_CFG.augment, 12)
    out = one_step(rows(padded, rank, world), rows(draws, rank, world), n_real, dist.all_reduce)
    dist.destroy_process_group()
    return out


# --- the tests ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    path = write_tpr(str(d / "ds.tpr"))
    single, single_hist = train_run(path, str(d / "single"), 3, use_mesh=False)
    # the smallest peak count of the two images' busiest channels: at that
    # capacity exactly one image overflows, and decides for both
    flats, _, _ = estimator(96)._scores(infer_images(), None, None)
    counts = torch.isfinite(flats).sum(-1).amax(-1).tolist()
    assert counts[0] != counts[1]
    out = spawn_ranks(two_rank_job, 2, path, str(d / "dp"), min(counts))
    return {"path": path, "dir": d, "single": (single, single_hist), "ranks": out,
            "max_peaks": min(counts)}


def assert_params_close(got, want, atol=1e-5):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=atol, err_msg=k)


def test_init_multihost_with_an_explicit_process_id_and_a_global_sum(runs):
    r0, r1 = runs["ranks"]
    assert r0["init"] and r1["init"]
    assert (r0["rank"], r1["rank"]) == (0, 1) and r0["world"] == r1["world"] == 2
    assert r0["primary"] and not r1["primary"]
    assert r0["backend"] == "gloo"
    assert r0["sum"] == r1["sum"] == (1.0 + 2.0) * 4


def test_one_dp_step_equals_the_single_process_step(runs):
    batch = step_batch(2, seed=7)
    draws = batch_params(torch.Generator().manual_seed(1), STEP_CFG.augment, 2)
    want_losses, want_params = one_step(batch, draws, 2)
    for rank in runs["ranks"]:
        losses, params = rank["step"]
        assert sorted(losses) == sorted(want_losses)
        for k, v in want_losses.items():
            np.testing.assert_allclose(losses[k], v, rtol=1e-4, err_msg=k)
        assert_params_close(params, want_params)
    a, b = (r["step"][1] for r in runs["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a)          # every rank the same update


def test_batch_10_over_4_ranks_padded_to_12_equals_the_unpadded_step():
    batch = step_batch(10, seed=3)
    padded, n_real = pad_batch(batch, 4)
    assert n_real == 10 and padded["images"].shape[0] == 12
    assert padded["weight"].tolist() == [1.0] * 10 + [0.0] * 2
    draws = batch_params(torch.Generator().manual_seed(5), STEP_CFG.augment, 10)
    want_losses, want_params = one_step(batch, draws, 10)
    for losses, params in spawn_ranks(four_rank_job, 4):
        for k, v in want_losses.items():
            np.testing.assert_allclose(losses[k], v, rtol=1e-4, err_msg=k)
        assert_params_close(params, want_params)


def test_three_dp_train_steps_over_the_tpr_feed_follow_the_single_process(runs):
    single, single_hist = runs["single"]
    assert single["steps"] == 3 and len(single_hist) == 3
    for rank in runs["ranks"]:
        steps, hist, params = rank["train"]
        assert steps == 3
        np.testing.assert_allclose(hist, single_hist, rtol=1e-4)
        assert_params_close(params, single["state"]["params"])
    # only rank 0 wrote: one CSV row a step, one checkpoint
    with open(os.path.join(runs["dir"], "dp", "training.csv")) as f:
        assert len(f.read().strip().splitlines()) == 1 + 3
    assert checkpoint.latest_step(os.path.join(runs["dir"], "dp", "checkpoints")) == 3


def test_the_2_rank_checkpoint_restores_in_one_process_bit_for_bit(runs):
    ckpt_dir = os.path.join(runs["dir"], "dp", "checkpoints")
    model = OpenPose(num_stages=1, dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(99))
    template = create_state(TRAIN_CFG, model.state_dict(), "cpu")[0].tree()
    restored = checkpoint.restore(ckpt_dir, template)
    assert restored["step"] == 3
    for rank in runs["ranks"]:
        params = rank["train"][2]
        assert all(torch.equal(restored["params"][k], params[k]) for k in params)
    # one process resumes the 2-rank run: step 4 follows the single-process run's
    more, hist = train_run(runs["path"], os.path.join(runs["dir"], "dp"), 4)
    whole, whole_hist = train_run(runs["path"], os.path.join(runs["dir"], "single4"), 4,
                                  use_mesh=False)
    assert more["steps"] == 1
    np.testing.assert_allclose(hist, whole_hist[3:], rtol=1e-4)
    assert_params_close(more["state"]["params"], whole["state"]["params"])


def test_multihost_process_batch_equals_one_process_batch(runs):
    """Each rank decodes its own row; at this capacity one image overflows,
    and the all-reduced switch turns both ranks' tables to score order, as
    one process's batch of two does."""
    est = estimator(runs["max_peaks"])
    want = est.process_batch(infer_images())
    got = [r["people"][0] for r in runs["ranks"]]
    assert sum(map(len, want)) > 0
    assert [len(p) for p in got] == [len(p) for p in want]
    for pg, pw in zip(got, want):
        for a, b in zip(pg, pw):
            assert a["num_parts"] == b["num_parts"] and abs(a["score"] - b["score"]) <= 1e-4
            assert {k: (v["x"], v["y"]) for k, v in a["keypoints"].items()} == \
                {k: (v["x"], v["y"]) for k, v in b["keypoints"].items()}
    # the row of the image that fits, decoded alone, keeps scan order: other people tables
    flats, _, _ = est._scores(infer_images(), None, None)
    fits = int(torch.isfinite(flats).sum(-1).amax(-1).argmin())
    alone = est._run(infer_images()[fits:fits + 1], None, None)
    whole = est._run(infer_images(), None, None)
    assert not torch.equal(alone["peak_xs"][0], whole["peak_xs"][fits])
