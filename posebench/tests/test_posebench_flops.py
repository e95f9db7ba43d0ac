"""The frozen FLOP arithmetic equals the program's at each cell's sizes."""

from __future__ import annotations

import pytest

from posebench import flops, manifest
from tpupose_torch.utils import flops as program_flops

BENCH = manifest.benchmark()
STREAMS = [w["name"] for w in BENCH["workloads"]
           if manifest.workload(w["name"])["traffic"]["kind"] == "stream"]


@pytest.mark.parametrize("cell", STREAMS)
def test_pyramid_flops_equal_the_programs(cell):
    wl = manifest.workload(cell)
    tr, m = wl["traffic"], manifest.config(wl["config"])
    scales = m["inference"]["scale_search"]
    args = (tr["height"], tr["width"], scales, m["model"]["boxsize"], m["model"]["stride"],
            m["model"]["num_stages"])
    assert flops.pyramid_flops(*args) == program_flops.pyramid_flops(*args)
    for _, _, ph, pw in flops.scale_sizes(*args[:5]):
        assert flops.forward_flops(ph, pw) == program_flops.forward_flops(ph, pw)


@pytest.mark.parametrize("size", [184, 368, 736])
def test_train_flops_split_the_forward(size):
    fwd = flops.forward_flops(size, size)
    assert flops.vgg_flops(size, size) + flops.head_flops(size, size) == fwd
    assert flops.train_flops(size, frozen_vgg=False) == 3 * fwd
    assert flops.train_flops(size) == 3 * fwd - 2 * flops.vgg_flops(size, size)


def test_bounds_are_positive_and_bytes_bound_the_peak_kernel():
    sizes = flops.scale_sizes(480, 640, (0.5, 1.0, 1.5, 2.0), 368, 8)
    assert flops.pyramid_peaks_bound_s(8, sizes, 480, 640, 8) > 0
    assert flops.block1_bound_s(8, 368, 496) > 0
