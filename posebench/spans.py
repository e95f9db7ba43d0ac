"""The program's own spans and counters (``tpupose_torch.utils.profiling``)
as the traced run left them: what the ``program_span`` and
``program_counter`` readers read.

The program records a span only while a profiler records, so its store
holds the traced sub-window's spans and the traced function's warm-up
around it; each reader divides by a span's own count from the same store.
A program without the store (no ``span_totals`` / ``counters``) reads as
nothing recorded, and every reader returns None.
"""

from __future__ import annotations


def totals() -> dict[str, dict]:
    """``{name: {"count", "total_s", "self_s"}}``, or {} without the store."""
    from tpupose_torch.utils import profiling

    read = getattr(profiling, "span_totals", None)
    return read() if read is not None else {}


def counters() -> dict[str, int]:
    """The program's counters, or {} without them."""
    from tpupose_torch.utils import profiling

    read = getattr(profiling, "counters", None)
    return read() if read is not None else {}


def ms_per(spans: dict, name: str, unit: str, less: str | None = None) -> float | None:
    """Milliseconds of span ``name`` (less those of span ``less``) per
    recorded ``unit`` span; None where either span is missing."""
    if name not in spans or not spans.get(unit, {}).get("count"):
        return None
    total = spans[name]["total_s"]
    if less is not None:
        if less not in spans:
            return None
        total -= spans[less]["total_s"]
    return 1e3 * total / spans[unit]["count"]


def read(run, kind: str, name: str, unit: str, less: str | None = None) -> float | None:
    """``ms_per`` in a traced run of a cell of traffic ``kind``."""
    if run.trace is None or run.cell["traffic"]["kind"] != kind:
        return None
    return ms_per(totals(), name, unit, less)
