"""The port's decode walkthrough (``tpupose_torch.examples.walkthrough``)
against the reference's (``examples/walkthrough.py``), on the CPU.

The reference builds its two-person scene with ``gt_np.create_heatmaps_np``;
the port with ``ops.gt.create_labels`` (the plain version here), its labels
within 1e-6 of the reference's. On the reference's own maps (its labels
through the same resize and noise), ``tpupose.decode.peaks.find_peaks``
gives the port's panel-3 tables (coordinates and valid slots equal, scores
within 1e-5), and ``tpupose.decode.decode_maps`` -> ``to_people`` the
port's people (coordinates and part counts equal, scores within 1e-5).
The reference's functions run in this process; ``tests/test_cli.py`` runs
the reference script itself. The port's module prints what the reference
script prints and writes the same five panels.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from tpupose_torch.examples import walkthrough as twalk
from tpupose_torch.testing import limit_threads

limit_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def reference():
    """The reference walkthrough's labels, peak tables and people."""
    from tpupose.config import DEFAULT
    from tpupose.decode import decode_maps, to_people
    from tpupose.decode.peaks import find_peaks
    from tpupose.reference_impl import gt_np

    labels = gt_np.create_heatmaps_np(twalk.scene_joints())
    heat, paf = twalk.scene_maps(labels)
    cfg = DEFAULT.inference
    pk = find_peaks(heat, max_peaks=cfg.max_peaks, sigma=cfg.peak_sigma, thre1=cfg.thre1)
    tables = decode_maps(heat, paf, cfg)
    return {"labels": labels, "peaks": {k: np.asarray(v) for k, v in pk.items()},
            "people": to_people({k: np.asarray(v) for k, v in tables.items()})}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("walkthrough"))
    return outdir, twalk.walkthrough(outdir, "cpu")


def test_labels_match_the_reference_rasteriser(reference, port):
    got, want = port[1]["labels"], reference["labels"]
    assert got.shape == want.shape == (46, 46, 57) and got.dtype == np.float64
    assert np.abs(got - want).max() <= 1e-6
    assert want[:, :, 38:56].max() > 0.9 and np.abs(want[:, :, :38]).max() > 0.9


def test_peaks_equal_the_reference_find_peaks(reference, port):
    got, want = port[1]["peaks"], reference["peaks"]
    assert got["valid"].shape == want["valid"].shape == (18, 96)
    for key in ("xs", "ys", "valid"):
        assert np.array_equal(got[key], want[key]), key
    assert got["valid"].sum(axis=1).tolist() == [2] * 18
    assert np.abs(got["scores"] - want["scores"]).max() <= 1e-5


def test_people_equal_the_reference_decode(reference, port):
    got, want = port[1]["people"], reference["people"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["num_parts"] == w["num_parts"] == 18
        assert abs(g["score"] - w["score"]) <= 1e-5
        assert {k: (v["x"], v["y"]) for k, v in g["keypoints"].items()} == \
            {k: (v["x"], v["y"]) for k, v in w["keypoints"].items()}
        for part, v in w["keypoints"].items():
            assert abs(g["keypoints"][part]["score"] - v["score"]) <= 1e-5, part
    for panel in twalk.PANELS:
        assert os.path.getsize(os.path.join(port[0], panel)) > 0, panel


def test_module_prints_the_reference_lines_and_writes_the_panels(tmp_path):
    out = str(tmp_path / "panels")
    r = subprocess.run(
        [sys.executable, "-m", "tpupose_torch.examples.walkthrough", "--outdir", out,
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert lines[0] == f"2 people decoded; panels in {out}/"
    assert len(lines) == 3 and r.stdout.count("18 parts") == 2
    assert all(line.startswith(f"  person {i}: 18 parts, score ")
               for i, line in enumerate(lines[1:]))
    assert sorted(os.listdir(out)) == sorted(twalk.PANELS)
