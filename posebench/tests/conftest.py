"""Tiny CPU cells for the tests: the cells' own workload files and limits,
at sizes a CPU test can run (the network at 2 stages and small inputs, in
f32, and a small decode capacity)."""

from __future__ import annotations

import time

import pytest
import torch

from posebench import manifest
from posebench.run import Context, keep_tensorflow_out

keep_tensorflow_out()


def tiny_context(cell: str, seed: int = 2**31 + 11, seconds: float = 1.0) -> Context:
    wl = manifest.workload(cell)
    cfg = manifest.config(wl["config"])
    cfg["model"].update(boxsize=96, num_stages=2, compute_dtype="float32")
    cfg["inference"].update(max_peaks=16)
    tr = wl["traffic"]
    if tr["kind"] == "stream":
        cfg["inference"]["scale_search"] = cfg["inference"]["scale_search"][:2]
        tr.update(height=96, width=128, batch=2, pool_batches=2, depth=1, trace_seconds=0.5)
        wl["check"]["batches"] = 1
        wl["check"]["short_floor"] = 1
        wl["limits"].update(connections={"min": 1}, reference_people={"min": 1},
                            short_images={"max": 0})
    elif tr["kind"] == "train":
        cfg["model"]["boxsize"] = 64
        cfg["train"]["batch_size"] = 2
        tr.update(size=64, scenes=6, threads=2, trace_seconds=0.5)
    torch.set_num_threads(2)
    return Context(cell, wl, cfg, seed, seconds, False, torch.device("cpu"),
                   time.perf_counter())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the program's kernels have no CPU mode)")
    return torch.device("cuda", 0)
