"""The readers of the program's spans and counters (``posebench/spans.py``
and the eight ``program_span`` / ``program_counter`` metrics) on a
synthetic store: each per-unit figure divides by its own span's count,
and a missing span, an untraced run, another kind of cell or a program
without the store reads None."""

from __future__ import annotations

import types

import pytest

from posebench import manifest
from tpupose_torch.utils import profiling

STREAM = {"infer.enqueue": (10, 0.5), "decode.overflow_switch": (10, 0.1),
          "infer.finish": (10, 0.3)}
TRAIN = {"train.step": (4, 0.2), "train.upload": (4, 0.02), "train.targets": (4, 0.04),
         "train.update": (4, 0.08)}
COUNTERS = {"decode.tables.sorted": 3, "decode.tables.scan": 1, "launch.block1": 40}
WANT = {
    "stream": {"overflow_wait_ms_per_batch": 10.0, "enqueue_ms_per_batch": 40.0,
               "answers_ms_per_batch": 30.0, "sorted_tables_share": 75.0},
    "train": {"step_host_ms": 50.0, "upload_ms_per_step": 5.0, "targets_ms_per_step": 10.0,
              "update_ms_per_step": 20.0},
}
NEEDS = {"overflow_wait_ms_per_batch": "decode.overflow_switch",
         "enqueue_ms_per_batch": "decode.overflow_switch", "answers_ms_per_batch": "infer.finish",
         "step_host_ms": "train.step", "upload_ms_per_step": "train.upload",
         "targets_ms_per_step": "train.targets", "update_ms_per_step": "train.update"}
CASES = [(kind, name) for kind, names in WANT.items() for name in names]


def _store(spans: dict) -> dict:
    return {k: {"count": c, "total_s": t, "self_s": t} for k, (c, t) in spans.items()}


def _run(kind: str, traced: bool = True):
    return types.SimpleNamespace(trace=object() if traced else None,
                                 cell={"traffic": {"kind": kind}})


@pytest.fixture
def store(monkeypatch):
    spans = _store({**STREAM, **TRAIN})
    monkeypatch.setattr(profiling, "span_totals", lambda: spans)
    monkeypatch.setattr(profiling, "counters", lambda: dict(COUNTERS))
    return spans


@pytest.mark.parametrize("kind,name", CASES)
def test_each_reader_divides_by_its_own_count(store, kind, name):
    read = manifest.reader(name).read
    assert read(_run(kind)) == pytest.approx(WANT[kind][name])
    other = "train" if kind == "stream" else "stream"
    assert read(_run(other)) is None and read(_run(kind, traced=False)) is None


@pytest.mark.parametrize("kind,name", CASES)
def test_a_reader_without_its_span_or_the_store_reads_none(store, monkeypatch, kind, name):
    if name in NEEDS:
        del store[NEEDS[name]]
    else:
        monkeypatch.setattr(profiling, "counters", lambda: {"launch.block1": 40})
    assert manifest.reader(name).read(_run(kind)) is None
    monkeypatch.delattr(profiling, "span_totals")
    monkeypatch.delattr(profiling, "counters")
    assert manifest.reader(name).read(_run(kind)) is None


def test_every_program_metric_has_a_reader_and_its_cells():
    bench = manifest.benchmark()
    program = {m["name"]: m for m in bench["per_layer"]
               if m["source"] in ("program_span", "program_counter")}
    assert set(program) == set(WANT["stream"]) | set(WANT["train"])
    for name, m in program.items():
        kind = "stream" if name in WANT["stream"] else "train"
        cells = [c for c in m["workloads"]
                 if manifest.workload(c)["traffic"]["kind"] == kind]
        assert cells == m["workloads"] and cells
