"""The plain reference agrees with the program where both compute the
same numbers: on the CPU, in f32, at a tiny size."""

from __future__ import annotations

import torch

from posebench import port
from posebench.reference import model as ref_model
from posebench.tests.conftest import tiny_context
from posebench.traffic import stream, train


def test_reference_network_equals_the_programs():
    ctx = tiny_context("pyr4-vga-b8")
    params, pool = stream.inputs(ctx)
    est = port.estimator(ctx.config, params, ctx.device)
    x = torch.rand((1, 96, 128, 3), generator=torch.Generator().manual_seed(3)) - 0.5
    with torch.no_grad():
        paf, heat = est.model(x)[-1]
        rpaf, rheat = ref_model.Net(params, "float32", 2).last(x)
    assert torch.allclose(heat, rheat, atol=1e-5 * float(rheat.abs().max()))
    assert torch.allclose(paf, rpaf, atol=1e-5 * float(rpaf.abs().max()))


def test_reference_decode_finds_the_programs_people():
    numbers = stream.program_readings(tiny_context("pyr4-vga-b8"))
    assert numbers["reference_people"] >= 1
    assert numbers["people_mismatch"] == 0.0 and numbers["paf_gap"] == 0.0
    assert numbers["heat_gap"] < 1e-5


def test_reference_training_steps_follow_the_programs():
    numbers = train.program_readings(tiny_context("finetune-light-b10"))
    assert numbers["feed_rows_wrong"] == 0 and numbers["frozen_moved"] == 0.0
    assert numbers["loss_gap"] < 1e-4
    assert numbers["grad_gap"] < 1e-3 and numbers["update_gap"] < 1e-3
