"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a chip and drives the rest of a run
(set-up, window, check, result line) on the CPU at a tiny size, first as
it is and then with one fault planted in the program: an answer altered
where it is produced (both kinds), half of the batch left out (every
other image answered with nobody; in training, the mean taken over the
rest) and a step that returns its state unchanged.
"""

from __future__ import annotations

import io
import json

import pytest

from posebench import manifest
from posebench.run import report
from posebench.tests.conftest import tiny_context
from posebench.traffic import stream, train

BENCH = manifest.benchmark()


def _correct(ctx, driver) -> bool:
    out = io.StringIO()
    assert report(BENCH, ctx, driver.run(ctx), out=out) == 0
    return json.loads(out.getvalue())["correct"]


def test_stream_run_is_correct_until_an_answer_is_altered(monkeypatch):
    from tpupose_torch.infer import PoseEstimator

    ctx = tiny_context("pyr4-vga-b8", seconds=15.0)
    assert _correct(ctx, stream)
    finish = PoseEstimator._finish

    def altered(n, tables):
        people = finish(n, tables)
        for image in people:
            for person in image:
                for kp in person["keypoints"].values():
                    kp["score"] += 0.25
        return people

    monkeypatch.setattr(PoseEstimator, "_finish", staticmethod(altered))
    assert not _correct(tiny_context("pyr4-vga-b8", seconds=15.0), stream)


def test_stream_run_is_not_correct_with_half_of_each_batch_left_out(monkeypatch):
    from posebench import port
    from tpupose_torch.infer import PoseEstimator

    monkeypatch.setattr(PoseEstimator, "_finish", PoseEstimator._finish)
    port.empty_every_other_image()
    assert not _correct(tiny_context("pyr4-vga-b8", seconds=15.0), stream)


def test_train_run_is_correct_without_a_fault():
    assert _correct(tiny_context("finetune-light-b10"), train)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "loss_altered"])
def test_train_run_is_not_correct_with_a_fault(monkeypatch, fault):
    from tpupose_torch.training import optimizer
    from tpupose_torch.training import train as program_train

    if fault == "state_unchanged":
        def update(self, grads, state, params):
            state["count"] += 1
        monkeypatch.setattr(optimizer.MultiSGD, "update", update)
    elif fault == "half_batch":
        descend = program_train._descend

        def half(model, tx, tree, inputs, denom, all_reduce=None):
            n = inputs[0].shape[0] // 2
            return descend(model, tx, tree, tuple(t[:n] for t in inputs), n, all_reduce)
        monkeypatch.setattr(program_train, "_descend", half)
    else:
        stagewise = program_train.loss_lib.stagewise_losses

        def altered(*args, **kwargs):
            losses = stagewise(*args, **kwargs)
            return dict(losses, total=losses["total"] * 1.1)
        monkeypatch.setattr(program_train.loss_lib, "stagewise_losses", altered)
    assert not _correct(tiny_context("finetune-light-b10"), train)
