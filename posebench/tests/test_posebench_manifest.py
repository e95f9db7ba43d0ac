"""BENCHMARK.json keeps to its character rules, and every cell finds its
parts by name."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from posebench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = manifest.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/") and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_parts_by_name(cell):
    entry = manifest.cell_entry(BENCH, cell)
    wl = manifest.workload(cell)
    assert wl["config"] == entry["config"] and wl["traffic"]["name"] == entry["traffic"]
    config = manifest.config(wl["config"])
    assert config["name"] == wl["config"]
    driver = manifest.traffic(wl["traffic"]["kind"])
    assert all(callable(getattr(driver, f)) for f in ("run", "control", "program_readings"))
    assert wl["limits"]
    e2e = {m["name"] for m in manifest.metrics_of(BENCH, cell, traced=False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = manifest.metrics_of(BENCH, cell, traced=True)
    assert layer
    for m in layer:
        assert callable(manifest.reader(m["name"]).read)
        assert m["moves"] in e2e


def test_an_added_workload_is_picked_up_by_name(tmp_path, monkeypatch):
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(os.path.join(manifest.HERE, sub), tmp_path / sub)
    wl = manifest.workload(CELLS[0])
    wl["traffic"] = dict(wl["traffic"], name="added-mix", batch=4)
    (tmp_path / "workloads" / "added-cell.json").write_text(json.dumps(wl))
    monkeypatch.setattr(manifest, "HERE", str(tmp_path))
    got = manifest.workload("added-cell")
    assert got["traffic"]["batch"] == 4
    assert manifest.config(got["config"])["name"] == got["config"]
    assert callable(manifest.traffic(got["traffic"]["kind"]).run)
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "added-cell", "config": got["config"], "traffic": "added-mix", "chips": 1,
         "why": "a data-only cell"}])
    assert manifest.cell_entry(bench, "added-cell")["traffic"] == "added-mix"


def test_configs_match_their_files():
    for c in BENCH["configs"]:
        data = manifest.config(c["name"])
        assert os.path.relpath(os.path.join(manifest.HERE, "configs", c["name"] + ".json"),
                               manifest.ROOT) == c["file"]
        assert data["reduced"] == c["reduced"] and data["source"] == c["source"]
