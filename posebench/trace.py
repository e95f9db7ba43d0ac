"""Host spans and the device trace of a steady sub-window.

``profiled`` runs a function under ``torch.profiler`` (CPU and CUDA
activity). The function marks its steady part with the span ``WINDOW``;
only device activity inside that span counts. ``Trace`` holds what the
per-layer metric readers read: the window's length, the union of device
activity (busy), time by kernel and by class, and the idle gaps, each
named by the innermost of the benchmark's host spans open where it
starts ("program" where none is: the host is in the program's own code).
"""

from __future__ import annotations

import contextlib
import dataclasses

from posebench.classes import classify

WINDOW = "posebench.window"


def nospan(name: str):
    """The span function of an untraced run."""
    return contextlib.nullcontext()


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    by_kernel: dict[str, tuple[int, float]]      # name -> (launches, seconds)
    by_class: dict[str, float]                   # class -> seconds
    gaps: list[tuple[str, float]]                # longest first
    counts: dict                                 # what the traced function counted

    def launches(self, fragment: str) -> int:
        return sum(n for name, (n, _) in self.by_kernel.items() if fragment in name)

    def seconds(self, fragment: str) -> float:
        return sum(s for name, (_, s) in self.by_kernel.items() if fragment in name)

    def breakdown(self) -> dict:
        ops = sorted(self.by_kernel.items(), key=lambda kv: -kv[1][1])[:10]
        return {"device_ops": [[name[:160], s] for name, (_, s) in ops],
                "idle_gaps": [[name, s] for name, s in self.gaps[:10]]}


def _is_device(evt) -> bool:
    return "cuda" in str(evt.device_type).lower()


def _is_kernel(evt, marks: tuple[str, ...]) -> bool:
    """A kernel, copy or set on the device; the host spans' mirrors on the
    device's timeline are not."""
    return (_is_device(evt) and evt.name not in marks
            and not getattr(evt, "is_user_annotation", False))


def profiled(fn, span_names: tuple[str, ...]) -> Trace:
    """Runs ``fn(span)`` under the profiler; ``span(name)`` is a context
    manager that records a host span. ``fn`` returns its counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        counts = fn(record_function)
        torch.cuda.synchronize()
    events = prof.events()
    windows = [e for e in events if e.name == WINDOW and not _is_device(e)]
    if len(windows) != 1:
        raise RuntimeError(f"the traced function marked {len(windows)} windows, want 1")
    w0, w1 = windows[0].time_range.start, windows[0].time_range.end
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.name in span_names and not _is_device(e))
    intervals = []
    by_kernel: dict[str, tuple[int, float]] = {}
    by_class: dict[str, float] = {}
    marks = (*span_names, WINDOW)
    for e in events:
        if not _is_kernel(e, marks):
            continue
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b <= a:
            continue
        intervals.append((a, b))
        s = (b - a) / 1e6
        n, t = by_kernel.get(e.name, (0, 0.0))
        by_kernel[e.name] = (n + 1, t + s)
        label = classify(e.name)
        by_class[label] = by_class.get(label, 0.0) + s
    intervals.sort()
    busy, gaps, cursor = 0.0, [], w0
    for a, b in intervals:
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if w1 > cursor:
        gaps.append((cursor, w1))

    def host_at(t: float) -> str:
        inner = "program"
        for a, b, name in spans:
            if a > t:
                break
            if b >= t:
                inner = name
        return inner

    named = sorted(((host_at(a), (b - a) / 1e6) for a, b in gaps), key=lambda g: -g[1])
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6, by_kernel=by_kernel,
                 by_class=by_class, gaps=named, counts=counts)
