"""Tracing / profiling harness: the port's counterpart of
``tpupose/utils/profiling.py``, with the same names and semantics, and the
program's own spans and counters.

``time_fn`` times a function on the wall clock and blocks on its result
(``torch.cuda.synchronize`` of each card its CUDA tensors lie on, where
the reference blocks with ``jax.block_until_ready``); ``trace`` captures a
``torch.profiler`` trace (host and, where there is a card, CUDA
activity, the hand-written kernels included) as a Chrome/TensorBoard JSON
file in ``logdir``.

``annotate(name)`` is the program's span. The main path opens one around
each layer's work of a batch or a step (``infer.enqueue``,
``decode.overflow_switch``, ``infer.finish``, ``train.step``,
``train.upload``, ``train.targets``, ``train.update``). While no profiler
records, a span is one flag check and a shared no-op context. While one
records (``torch.profiler.profile``, so also ``trace``), a span enters a
``record_function`` (it lies on the profiler's timeline, above the
kernels it launched, and its device mirror is a user annotation) and adds
its count, total seconds and self seconds (the total less the time its
child spans on the same thread cover) to ``span_totals()``. Under
``torch.export`` a span is a no-op.

``count(name)`` is an always-on counter of the program (the decode's
``decode.tables.sorted`` / ``decode.tables.scan``, BODY_25's
``net.stages.graph`` / ``net.stages.eager``); ``counters()`` returns
them with the kernels' launch counts (``ops.launch_counts()``) as
``launch.<kernel>``; ``add_counts`` adds a replayed CUDA graph's share.
"""

from __future__ import annotations

import contextlib
import os
import socket
import threading
import time
from typing import Callable

import torch
from torch.autograd import profiler as _autograd_profiler


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


# --- spans and counters -----------------------------------------------------------

_lock = threading.Lock()
_spans: dict[str, list] = {}        # name -> [count, total_s, self_s]
_counters: dict[str, int] = {}
_open = threading.local()           # .stack: this thread's open spans, innermost last
_OFF = contextlib.nullcontext()     # the span of a call no profiler records


class _Span:
    __slots__ = ("name", "mark", "t0", "inner")

    def __init__(self, name: str, args: str | None):
        self.name = name
        self.mark = torch.profiler.record_function(name, args)
        self.inner = 0.0            # seconds of child spans

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.mark.__enter__()
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        total = time.perf_counter() - self.t0
        stack = _open.stack
        stack.pop()
        self.mark.__exit__(*exc)
        if stack:
            stack[-1].inner += total
        with _lock:
            agg = _spans.setdefault(self.name, [0, 0.0, 0.0])
            agg[0] += 1
            agg[1] += total
            agg[2] += total - self.inner
        return False


def annotate(name: str, args: object = None):
    """The span ``name`` (a context manager). While a profiler records,
    ``args`` (e.g. a batch's sequence number) is the ``record_function``'s
    argument, which joins one request's spans for a reader of its inputs
    (the Chrome export of torch 2.11 leaves string inputs out)."""
    if not _autograd_profiler._is_profiler_enabled or torch.compiler.is_exporting():
        return _OFF
    return _Span(name, None if args is None else str(args))


def span_totals() -> dict[str, dict]:
    """``{name: {"count", "total_s", "self_s"}}`` of the spans recorded
    since the last ``reset_spans``."""
    with _lock:
        return {name: {"count": c, "total_s": t, "self_s": s}
                for name, (c, t, s) in _spans.items()}


def reset_spans() -> None:
    with _lock:
        _spans.clear()


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` (not while exporting: the count
    would be the tracer's, once)."""
    if torch.compiler.is_exporting():
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def add_counts(counts: dict[str, int]) -> None:
    """Adds a difference of two ``counters()`` readings: the counters and
    kernel launches of work that the device runs again without its Python
    (a CUDA graph's replay)."""
    from tpupose_torch import ops

    kernels = {f"launch.{k.name}": k for k in ops.KERNELS}
    for name, n in counts.items():
        if name in kernels:
            kernels[name].launches += n
        else:
            count(name, n)


def counters() -> dict[str, int]:
    """The counters, and each kernel's launches as ``launch.<kernel>``."""
    from tpupose_torch import ops

    with _lock:
        out = dict(_counters)
    out.update({f"launch.{k}": v for k, v in ops.launch_counts().items()})
    return out


def reset_counters() -> None:
    """Zeroes every counter ``counters()`` returns, the launch counts too."""
    from tpupose_torch import ops

    with _lock:
        _counters.clear()
    ops.reset_launch_counts()
