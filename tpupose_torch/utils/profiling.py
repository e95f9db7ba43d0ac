"""Tracing / profiling harness: the port's counterpart of
``tpupose/utils/profiling.py``, with the same names and semantics.

``time_fn`` times a function on the wall clock and blocks on its result
(``torch.cuda.synchronize`` of each card its CUDA tensors lie on, where
the reference blocks with ``jax.block_until_ready``); ``trace`` captures a
``torch.profiler`` trace (host and, where there is a card, CUDA
activity, the hand-written kernels included) as a Chrome/TensorBoard JSON
file in ``logdir``; ``annotate`` names a region inside it, and an NVTX
range when CUDA is present. Nothing on the main path calls them;
``utils/profile_inference.py`` is the inference cells' breakdown.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Callable

import torch


def _cuda_devices(out, found: set) -> set:
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _cuda_devices(v, found)
    return found


def _block(out) -> None:
    for device in _cuda_devices(out, set()):
        torch.cuda.synchronize(device)


def time_fn(
    fn: Callable, *args, warmup: int = 2, iters: int = 10, **kwargs
) -> dict[str, float]:
    """Wall-clock stats for a device function (blocks on results)."""
    for _ in range(warmup):
        _block(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _block(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    return {
        "mean_ms": 1e3 * sum(times) / len(times),
        "p50_ms": 1e3 * times[len(times) // 2],
        "min_ms": 1e3 * times[0],
        "max_ms": 1e3 * times[-1],
    }


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace viewable in TensorBoard or Perfetto:
    one ``<host>_<pid>.<ns>.pt.trace.json`` file in ``logdir``."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(logdir, name))


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a trace."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield
