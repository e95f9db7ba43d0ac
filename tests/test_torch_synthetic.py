"""The port's synthetic new-domain dataset
(``tpupose_torch.data.make_synthetic_dataset``) against the reference tool
``tools/make_synthetic_dataset.py``.

One seed and style give the same records from the reference tool (HDF5, run
as a script in a subprocess) and from the port's tool to ``.h5`` and to
``.tpr``: image and mask bit-equal, the JSON meta of every record (joints,
center, scale_provided, areas) equal as written, and the readers'
samples equal. ``--compression none`` writes raw ``.tpr`` records, the
other codecs zlib. The copied ``REL``, ``make_person`` and ``render`` are
the reference's code but for docstrings and comments. The ``.tpr`` output
goes through ``pack_tpr --pre-pad``, ``finetune`` and ``eval`` of the port's
command line unchanged. Small: 6 scenes of 150x150.
"""

import ast
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.test_torch_imports import _Normalise, _code
from tpupose_torch.data import hdf5, tpr
from tpupose_torch.data import make_synthetic_dataset as synth
from tpupose_torch.testing import limit_threads

limit_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--count", "6", "--size", "150"]
CASES = [(style, seed) for style in ("dark", "light", "varied") for seed in (0, 3)]
SAMPLE_KEYS = ("joints", "center", "scale_provided", "areas")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference tool's .h5 for every case, its runs started together."""
    d = tmp_path_factory.mktemp("reference")
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
    runs = {}
    for style, seed in CASES:
        path = str(d / f"{style}{seed}.h5")
        runs[(style, seed)] = path, subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tools", "make_synthetic_dataset.py"),
             "--output", path, *SMALL, "--style", style, "--seed", str(seed)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out = {}
    for case, (path, proc) in runs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err.decode()[-2000:]
        out[case] = path
    return out


def _port(path, *argv):
    with contextlib.redirect_stdout(io.StringIO()) as said:
        assert synth.main(["--output", path, *argv]) == 0
    return said.getvalue()


def _h5_records(path):
    import h5py

    with h5py.File(path, "r") as f:
        group = f["datum"]
        return [(np.asarray(group[k]["image"]), np.asarray(group[k]["mask"]),
                 json.loads(group[k].attrs["meta"])) for k in sorted(group)]


def _tpr_records(path):
    with tpr.TprReader(path) as r:
        return [(*r.read(i), r.meta(i)) for i in range(r.count)]


def _same_samples(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for key in ("image", "mask"):
            assert g[key].dtype == w[key].dtype == np.uint8 and np.array_equal(g[key], w[key])
        for key in SAMPLE_KEYS:
            assert np.asarray(g[key]).dtype == np.asarray(w[key]).dtype, key
            assert np.array_equal(g[key], w[key]), key


@pytest.mark.parametrize("style, seed", CASES)
def test_records_equal_the_reference_tools(reference, tmp_path, style, seed):
    args = [*SMALL, "--style", style, "--seed", str(seed)]
    h5, tp = str(tmp_path / "port.h5"), str(tmp_path / "port.tpr")
    said = _port(h5, *args)
    assert _port(tp, *args) == said.replace(h5, tp)
    want = _h5_records(reference[(style, seed)])
    assert said == f"wrote {len(want)} records -> {h5}\n" and len(want) >= 6
    for got in (_h5_records(h5), _tpr_records(tp)):
        assert len(got) == len(want)
        for (gi, gm, gmeta), (wi, wm, wmeta) in zip(got, want):
            assert gi.shape == (150, 150, 3) and np.array_equal(gi, wi)
            assert np.array_equal(gm, wm)
            assert gmeta == wmeta and set(wmeta) == {"center", "scale_provided", "joints", "areas"}
    ref = list(hdf5.read_samples(reference[(style, seed)]))
    _same_samples(list(hdf5.read_samples(h5)), ref)
    _same_samples(list(tpr.read_samples(tp)), ref)


@pytest.mark.parametrize("compression, codec", [
    ("none", tpr.CODEC_RAW), ("lzf", tpr.CODEC_ZLIB), ("gzip", tpr.CODEC_ZLIB),
])
def test_tpr_codec_follows_compression(tmp_path, compression, codec):
    """Run as ``python -m``: ``--compression none`` writes raw records (their
    stored size is their raw size), ``lzf`` and ``gzip`` zlib."""
    path = str(tmp_path / "s.tpr")
    r = subprocess.run(
        [sys.executable, "-m", "tpupose_torch.data.make_synthetic_dataset", "--output", path,
         *SMALL, "--compression", compression],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0, r.stderr[-2000:]
    with open(path, "rb") as f:
        data = f.read()
    _, _, _, count, index_off = tpr.HEADER.unpack_from(data, 0)
    assert r.stdout == f"wrote {count} records -> {path}\n" and count >= 6
    for i in range(count):
        (_, icomp, iraw, _, mcomp, mraw, *_, icod, mcod, _) = tpr.ENTRY.unpack_from(
            data, index_off + i * tpr.ENTRY.size)
        assert icod == mcod == codec
        assert (icomp == iraw and mcomp == mraw) == (codec == tpr.CODEC_RAW)
    assert len(list(tpr.read_samples(path))) == count


def test_copies_equal_the_reference():
    """``make_person`` and ``render`` are the reference's code but for
    docstrings and comments, and ``REL`` is its table."""
    names = ["make_person", "render"]
    assert _code("tpupose_torch/data/make_synthetic_dataset.py", names) == \
        _code("tools/make_synthetic_dataset.py", names)

    def rel(path):
        with open(os.path.join(REPO, path)) as f:
            tree = _Normalise().visit(ast.parse(f.read()))
        found = [ast.dump(n) for n in tree.body if isinstance(n, ast.Assign)
                 and [getattr(t, "id", None) for t in n.targets] == ["REL"]]
        assert len(found) == 1
        return found[0]

    assert rel("tpupose_torch/data/make_synthetic_dataset.py") == \
        rel("tools/make_synthetic_dataset.py")
    assert len(synth.REL) == 18


def test_tpr_set_goes_through_pack_tpr_finetune_and_eval(tmp_path, monkeypatch, capsys):
    """The domain-adaptation story on the CPU at a small size: make a light
    set to .tpr, pre-pad it, finetune 1 step from it, eval the finetuned
    checkpoint over the unpadded set; the set's GT as detections scores AP 1."""
    import dataclasses

    import tpupose_torch.cli as tcli
    import tpupose_torch.config as tconfig
    from tpupose_torch.data import coco_eval, pack_tpr
    from tpupose_torch.testing import people_from_gt

    monkeypatch.setattr(tconfig, "DEFAULT", dataclasses.replace(
        tconfig.DEFAULT, model=dataclasses.replace(tconfig.DEFAULT.model,
                                                   compute_dtype="float32")))
    raw, fast = str(tmp_path / "light.tpr"), str(tmp_path / "light368.tpr")
    _port(raw, "--count", "3", "--size", "150", "--style", "light", "--seed", "0")
    with contextlib.redirect_stdout(io.StringIO()):
        assert pack_tpr.main(["--input", raw, "--output", fast, "--pre-pad", "368", "368",
                              "--max-persons", "24"]) == 0
    model = ["--stages", "1", "--boxsize", "64", "--device", "cpu"]
    workdir = str(tmp_path / "ft")
    assert tcli.main(["finetune", "--dataset", fast, "--workdir", workdir, "--max-steps", "1",
                      "--batch-size", "2", *model]) == 0
    ran = json.loads(capsys.readouterr().out)
    assert ran["steps"] == 1 and np.isfinite(list(ran["last_losses"].values())).all()
    assert tcli.main(["eval", "--dataset", raw, "--checkpoint", os.path.join(workdir, "checkpoints"),
                      "--scales", "1", "--max-peaks", "32", *model]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0.0 <= printed["AP"] <= 1.0
    gts = [[{"keypoints": j, "area": float(a)} for j, a in zip(s["joints"], s["areas"])]
           for s in tpr.read_samples(raw)]
    assert coco_eval.evaluate([people_from_gt(gt) for gt in gts], gts)["AP"] == 1.0
