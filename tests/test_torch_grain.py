"""The port's checkpointable feed (tpupose_torch/data/grain_pipeline.py)
against the JAX package's Grain feed, the counterparts of
tests/test_grain_pipeline.py: the batch contract, a deterministic seeded
order, shards that partition the records as Grain's do, mid-epoch resume
from state, the training loop checkpointing and restoring the position,
and spawn-safe workers.

The order within an epoch is the port's own (a numpy permutation seeded
from the seed and the epoch); Grain's is not reproduced, so the two feeds
are held to the same records per epoch and per shard, not the same order.
"""

import numpy as np
import pytest

from tpupose.config import AugmentConfig as JAug, ModelConfig as JModel
from tpupose.config import PoseConfig as JPose, TrainConfig as JTrain
from tpupose.data import hdf5 as jhdf5
from tpupose.data import grain_pipeline as jgrain
from tpupose_torch.config import AugmentConfig, ModelConfig, PoseConfig, TrainConfig
from tpupose_torch.data import grain_pipeline as tgrain
from tpupose_torch.data import pipeline
from tpupose_torch.data.pipeline import is_checkpointable
from tpupose_torch.testing import limit_threads

from tests.test_data import make_sample

limit_threads()


def small_cfg(batch_size=2, max_persons=3):
    kw = dict(train=dict(batch_size=batch_size), augment=dict(max_persons=max_persons))
    return (PoseConfig(model=ModelConfig(num_stages=2), train=TrainConfig(**kw["train"]),
                       augment=AugmentConfig(**kw["augment"])),
            JPose(model=JModel(num_stages=2), train=JTrain(**kw["train"]),
                  augment=JAug(**kw["augment"])))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("grain") / "ds.h5")
    rng = np.random.default_rng(0)
    with jhdf5.SampleWriter(path) as w:
        for i in range(10):
            s = make_sample(rng, h=40, w=48)
            # a fingerprint per record rides scale_provided
            w.add(s["image"], s["mask"], s["joints"], s["center"], np.float32(0.5 + i / 100.0))
    return path


def _scales(batches, n):
    it = iter(batches)
    return [tuple(np.round(next(it)["scales"], 4).tolist()) for _ in range(n)]


def test_batch_contract_matches_the_reference(dataset):
    """Shuffle off: the same records in the same order, padded and cast as
    the reference's Grain feed batches them, byte for byte; every record's
    PadForBatch.map equals the reference's."""
    cfg, jcfg = small_cfg()
    got = list(tgrain.hdf5_grain_batches(dataset, cfg, target_h=32, target_w=32, epochs=1,
                                         shuffle_seed=None))
    want = list(jgrain.hdf5_grain_batches(dataset, jcfg, target_h=32, target_w=32, epochs=1,
                                          shuffle_seed=None))
    assert len(got) == len(want) == 5
    for bg, bw in zip(got, want):
        assert sorted(bg) == sorted(bw)
        for k in bw:
            assert bg[k].dtype == bw[k].dtype and bg[k].shape == bw[k].shape, k
            np.testing.assert_array_equal(bg[k], bw[k], err_msg=k)
    src, jsrc = tgrain.Hdf5Source(dataset), jgrain.Hdf5Source(dataset)
    pad, jpad = tgrain.PadForBatch(32, 32, 3), jgrain.PadForBatch(32, 32, 3)
    assert len(src) == len(jsrc) == 10
    for i in range(10):
        a, b = pad.map(src[i]), jpad.map(jsrc[i])
        assert sorted(a) == sorted(b)
        for k in b:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_seeded_shuffle_is_deterministic_and_reshuffles_each_epoch(dataset):
    cfg, jcfg = small_cfg()

    def mk():
        return tgrain.hdf5_grain_batches(dataset, cfg, target_h=32, target_w=32, epochs=2,
                                         shuffle_seed=7)

    # 10 records / batch 2 / 2 epochs = exactly 10 batches
    s1, s2 = _scales(mk(), 10), _scales(mk(), 10)
    assert s1 == s2
    with pytest.raises(StopIteration):
        _scales(mk(), 11)
    flat = [x for b in s1 for x in b]
    assert flat[:10] != flat[10:20]
    assert sorted(flat[:10]) == sorted(flat[10:20])
    want = [x for b in _scales(jgrain.hdf5_grain_batches(
        dataset, jcfg, target_h=32, target_w=32, epochs=2, shuffle_seed=7), 10) for x in b]
    assert sorted(flat[:10]) == sorted(want[:10])          # the same records, another order
    other = [x for b in _scales(tgrain.hdf5_grain_batches(
        dataset, cfg, target_h=32, target_w=32, epochs=1, shuffle_seed=8), 5) for x in b]
    assert other != flat[:10]


@pytest.mark.parametrize("count", [2, 3])
def test_shards_partition_the_records_as_the_reference(dataset, count):
    cfg, jcfg = small_cfg(batch_size=1)
    seen = []
    for idx in range(count):
        got = {s for b in tgrain.hdf5_grain_batches(
            dataset, cfg, target_h=32, target_w=32, epochs=1, shuffle_seed=3,
            shard=(idx, count)) for s in np.round(b["scales"], 4)}
        want = {s for b in jgrain.hdf5_grain_batches(
            dataset, jcfg, target_h=32, target_w=32, epochs=1, shuffle_seed=3,
            shard=(idx, count)) for s in np.round(b["scales"], 4)}
        assert got == want and len(got) == 10 // count
        seen.append(got)
    assert not set.intersection(*seen)
    with pytest.raises(ValueError, match="bad shard"):
        tgrain.hdf5_grain_batches(dataset, cfg, shard=(2, 2))


def test_shard_auto_reads_the_process_group(dataset, monkeypatch):
    cfg, _ = small_cfg(batch_size=1)
    monkeypatch.setattr(tgrain, "process_shard", lambda: (1, 2))
    got = tgrain.hdf5_grain_batches(dataset, cfg, target_h=32, target_w=32, epochs=1,
                                    shuffle_seed=3, shard="auto")
    explicit = tgrain.hdf5_grain_batches(dataset, cfg, target_h=32, target_w=32, epochs=1,
                                         shuffle_seed=3, shard=(1, 2))
    assert _scales(got, 5) == _scales(explicit, 5)
    monkeypatch.setattr(tgrain, "process_shard", lambda: (0, 11))
    with pytest.raises(ValueError, match="fewer records"):
        tgrain.hdf5_grain_batches(dataset, cfg, shard="auto")


def test_mid_epoch_resume_via_state(dataset):
    cfg, _ = small_cfg()

    def mk():
        return tgrain.hdf5_grain_batches(dataset, cfg, target_h=32, target_w=32, epochs=3,
                                         shuffle_seed=11)

    feed = mk()
    assert is_checkpointable(feed) and isinstance(feed, tgrain.GrainBatches)
    _scales(feed, 3)
    state = feed.get_state()
    assert tgrain.json.loads(state) == {"seed": 11, "shard": [0, 1], "epoch": 0,
                                        "position": 6, "version": 1}
    expected = _scales(feed, 4)                 # crosses into epoch 1
    fresh = mk()
    fresh.set_state(state)
    assert _scales(fresh, 4) == expected
    other = tgrain.hdf5_grain_batches(dataset, cfg, target_h=32, target_w=32, shuffle_seed=12)
    with pytest.raises(ValueError, match="seed 11"):
        other.set_state(state)


def test_train_loop_checkpoints_and_restores_the_position(dataset, tmp_path):
    """A preempted run resumes from both the model step AND the data
    position: no record replayed or skipped, whatever the workers read
    ahead."""
    from tpupose_torch.training import loop

    cfg = PoseConfig(model=ModelConfig(boxsize=64, num_stages=1, compute_dtype="float32"),
                     train=TrainConfig(batch_size=2, base_lr=1e-5, checkpoint_every=2,
                                       log_every=10, max_steps=100),
                     augment=AugmentConfig(max_persons=3))
    consumed: list[tuple] = []

    class Spy(tgrain.GrainBatches):
        def __next__(self):
            b = super().__next__()
            consumed.append(tuple(np.round(b["scales"], 4).tolist()))
            return b

    def mk():
        inner = tgrain.hdf5_grain_batches(dataset, cfg, target_h=64, target_w=64, epochs=10,
                                          shuffle_seed=9)
        return Spy(inner._loader)

    workdir = str(tmp_path / "run")
    loop.train(cfg, mk(), workdir=workdir, max_steps=2, device="cpu")
    first = list(consumed)
    assert len(first) == 2
    loop.train(cfg, mk(), workdir=workdir, max_steps=4, device="cpu")
    resumed = consumed[2:]
    assert len(resumed) == 2
    uninterrupted = _scales(mk(), 4)
    assert first + resumed == uninterrupted


def test_spawned_workers_read_every_record_and_keep_the_position(dataset):
    """worker_count > 0: the HDF5 source re-opens in each spawned process;
    the state is the position after the batches yielded, not after those
    the workers prefetched."""
    cfg, _ = small_cfg(batch_size=1)
    feed = tgrain.hdf5_grain_batches(dataset, cfg, target_h=32, target_w=32, epochs=2,
                                     shuffle_seed=None, worker_count=2, read_buffer=4)
    got = [s for b in _scales(feed, 13) for s in b]
    assert tgrain.json.loads(feed.get_state()) == {"seed": None, "shard": [0, 1], "epoch": 1,
                                                   "position": 3, "version": 1}
    rest = [s for b in feed for s in np.round(b["scales"], 4)]
    feed.close()
    assert len(got) + len(rest) == 20 and sorted(got[:10]) == sorted(got[10:13] + rest)
    # pad_sample rescales scale_provided by the resize factor (32/48)
    assert got[0] == pytest.approx(0.5 * 32 / 48, abs=1e-3)
    assert len(set(got[:10])) == 10
    same = [s for b in pipeline.hdf5_batches(dataset, cfg, target_h=32, target_w=32, epochs=1,
                                             shuffle_seed=None, num_workers=1)
            for s in np.round(b["scales"], 4)]
    assert got[:10] == same
