"""The control fails each cell's check on the card: the reference computed
one precision below the configuration's (fp8 for its bf16 convs, bf16 for
its f32 heads) in the program's place, at the cell's own size.

    python3 -m pytest posebench/tests/test_posebench_control_cuda.py -m cuda
"""

from __future__ import annotations

import time

import pytest

from posebench import manifest
from posebench.run import Context, judge

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cuda, cell):
    wl = manifest.workload(cell)
    config = manifest.config(wl["config"])
    driver = manifest.traffic(wl["traffic"]["kind"])
    ctx = Context(cell, wl, config, 2**31 + 77, 0.0, False, cuda, time.perf_counter())
    ok, shown = judge(driver.control(ctx, "fp8"), wl["limits"])
    assert not ok, shown
