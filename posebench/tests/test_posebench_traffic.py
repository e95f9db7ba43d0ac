"""The generators repeat for a seed and keep the stated mixes."""

from __future__ import annotations

import numpy as np
import torch

from posebench import scenes, weights
from posebench.checks import sample
from posebench.reference import train as ref_train
from posebench.traffic import stream
from tpupose_torch.config import DEFAULT
from tpupose_torch.gt import augment
from tpupose_torch.training import loop

CPU = torch.device("cpu")
SEED = 2**31 + 5


def test_frames_repeat_per_seed_and_differ_across_seeds():
    a = scenes.frames(SEED, 3, 48, 64, 3, CPU)
    b = scenes.frames(SEED, 3, 48, 64, 3, CPU)
    c = scenes.frames(SEED + 1, 3, 48, 64, 3, CPU)
    assert a.dtype == torch.uint8 and a.shape == (3, 48, 64, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_records_keep_the_mix_of_people():
    recs = scenes.records(SEED, 20, 64, 3, CPU)
    again = scenes.records(SEED, 20, 64, 3, CPU)
    per_scene = [len(r["joints"]) for r in recs]
    assert 20 <= len(recs) <= 60 and set(per_scene) <= {1, 2, 3}
    assert all(np.array_equal(x["image"], y["image"]) and x["center"] == y["center"]
               for x, y in zip(recs, again))
    # one record a person: each scene's record count equals its people
    images = [id(r["image"]) for r in recs]
    for r in recs:
        assert images.count(id(r["image"])) == len(r["joints"])


def test_weights_repeat_per_seed():
    a = weights.make(SEED, CPU, 2)
    b = weights.make(SEED, CPU, 2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["vgg.conv1_1.weight"]
    assert abs(float(w.std()) * (27 ** 0.5) - 1.0) < 0.2


def test_sample_repeats_and_stays_in_range():
    assert sample(SEED, 40, 2) == sample(SEED, 40, 2)
    assert all(0 <= i < 40 for i in sample(SEED, 40, 5))
    assert sample(SEED, 1, 2) == [0]


def test_reference_draws_are_the_programs_recipe():
    got = ref_train.draws(ref_train.step_generator(SEED, 2), vars(DEFAULT.augment), 10)
    want = augment.batch_params(loop.step_generator(SEED, 2), DEFAULT.augment, 10)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_stream_window_keeps_a_seeded_sample():
    w = stream.Window(2, SEED)
    w.start, w.deadline = 0.0, 10.0
    for k in range(20):
        w.arrived(k % 4, [[{"k": k}]], float(k))
    assert w.inside == 11 and w.total == 20 and len(w.kept) == 2
    again = stream.Window(2, SEED)
    again.start, again.deadline = 0.0, 10.0
    for k in range(20):
        again.arrived(k % 4, [[{"k": k}]], float(k))
    assert again.kept == w.kept

