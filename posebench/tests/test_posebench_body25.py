"""The BODY_25 cell's parts on the CPU: its FLOP count, its weights, its
reference against the port's own plain reference, and a tiny run of its
traffic module whose answers the check accepts."""

from __future__ import annotations

import time

import torch

from posebench import flops, flops_body25, manifest
from posebench.reference import body25 as ref
from posebench.run import Context, judge
from posebench.traffic import stream_body25

CPU = torch.device("cpu")
SEED = 2**31 + 25


def test_flops_are_the_layer_equations():
    pixel = flops_body25.head_flops(8, 8)             # one stride-8 output pixel
    assert pixel == 2 * (9 * (512 * 256 + 256 * 128)) + 37_596_416
    sizes = flops.scale_sizes(720, 1280, (0.5, 1.0, 1.5, 2.0), 368, 8)
    assert [s[2:] for s in sizes] == [(184, 328), (368, 656), (552, 984), (736, 1312)]
    assert abs(flops_body25.pyramid_flops(720, 1280, (0.5, 1.0, 1.5, 2.0)) / 1e12 - 2.1545) < 1e-3
    assert len(flops_body25.epilogue_channels()) == 99


def test_weights_repeat_per_seed_and_name_the_ports_layers():
    from tpupose_torch.models.body25 import OpenPoseBody25

    a, b = stream_body25.make_params(SEED, CPU), stream_body25.make_params(SEED, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert set(a) == set(OpenPoseBody25().state_dict())
    assert all(float(v.min()) == float(v.max()) == 0.25 for k, v in a.items() if k.endswith("slope"))


def test_reference_equals_the_ports_plain_reference():
    from tpupose_torch.reference_impl import body25_ref

    p = stream_body25.make_params(SEED, CPU)
    x = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(3)) - 0.5
    for precision in ("float32", "bfloat16"):
        with torch.no_grad():
            got = ref.Net(p, precision).last(x)
            want = body25_ref.Net(p, precision)(x)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_a_tiny_run_is_correct():
    wl = manifest.workload("body25-pyr4-hd-b8")
    cfg = manifest.config(wl["config"])
    cfg["model"].update(boxsize=96, compute_dtype="float32")
    cfg["inference"].update(max_peaks=16, scale_search=[0.5, 1.0])
    wl["traffic"].update(height=96, width=128, batch=2, pool_batches=2, depth=1)
    wl["check"].update(batches=1, short_floor=1)
    wl["limits"].update(connections={"min": 1}, reference_people={"min": 1},
                        short_images={"max": 0})
    torch.set_num_threads(2)
    ctx = Context("body25-pyr4-hd-b8", wl, cfg, SEED, 4.0, False, CPU, time.perf_counter())
    res = stream_body25.run(ctx)
    ok, shown = judge(res.numbers, wl["limits"])
    assert ok, shown
    assert res.e2e["images_per_s"] > 0 and res.attempted >= 2
