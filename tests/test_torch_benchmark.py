"""The port's benchmark (``tpupose_torch.benchmark``, ``utils/flops.py`` and
``cli bench``) against the reference's (``tpupose/benchmark.py``), on the CPU.

Tolerances: FLOP counts equal; the scene's heat and PAF maps within 1e-5 of
the reference's (the gt kernel's plain version is f32 where the reference's
rasteriser is f64: 7.2e-7 apart), its image equal (the truncation to uint8
could move a pixel by 1; none moves); the scipy twin's people on those maps
equal to the reference twin's, and on the reference's maps equal in parts
and within 1e-5 in scores and coordinates; the feed's files byte-equal to
the reference's. The reference's ``main`` is not run: its keys are read
from its source. ``main`` runs here at a tiny configuration (2 stages,
boxsize 64, scales 0.5 and 1.0, ``max_peaks`` 8, counts of 1-2).
"""

import ast
import contextlib
import dataclasses
import io
import itertools
import json
import os

import numpy as np
import pytest

from tpupose_torch import benchmark as tbench
from tpupose_torch.config import DEFAULT
from tpupose_torch.testing import limit_threads
from tpupose_torch.utils import flops as tflops

limit_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dataclasses.replace(
    DEFAULT, model=dataclasses.replace(DEFAULT.model, num_stages=2, boxsize=64),
    inference=dataclasses.replace(DEFAULT.inference, scale_search=(0.5, 1.0), max_peaks=8))
TINY_COUNTS = tbench.Counts(
    batch=2, batch_single=2, n_batches_4scale=1, n_warmup_4scale=1, n_batches=2, n_warmup=1,
    device_iters_single=2, device_iters_4scale=1, latency_iters_single=2,
    latency_iters_4scale=1, train_batch=2, train_iters=1, feed_records=4, feed_batch=2)
# a peak at which the tiny run's MFU is a few per cent, so that its arithmetic shows
TINY_PEAK = 1e12


@pytest.mark.parametrize("h, w, stages", [(368, 368, 6), (64, 64, 2), (184, 368, 6),
                                          (736, 736, 6), (100, 37, 3), (496, 656, 1)])
def test_forward_flops_equal_the_reference(h, w, stages):
    from tpupose.utils import flops as jflops

    assert tflops.forward_flops(h, w, stages) == jflops.forward_flops(h, w, stages)


@pytest.mark.parametrize("h, w", [(368, 368), (656, 496), (720, 1280)])
def test_pyramid_flops_equal_the_reference(h, w):
    from tpupose.utils import flops as jflops

    scales = DEFAULT.inference.scale_search
    assert tflops.pyramid_flops(h, w, scales) == jflops.pyramid_flops(h, w, scales)
    if (h, w) == (368, 368):
        assert round(tflops.forward_flops(h, w) / 1e12, 4) == 0.2719
        assert round(tflops.pyramid_flops(h, w, scales) / 1e12, 3) == 2.039


@pytest.fixture(scope="module")
def scenes():
    from tpupose import benchmark as jbench

    return tbench.synthetic_scene(368), jbench.synthetic_scene()


def test_synthetic_scene_matches_the_reference(scenes):
    (image, heat, paf), (j_image, j_heat, j_paf) = scenes
    assert image.shape == (368, 368, 3) and image.dtype == np.uint8
    assert heat.shape == (368, 368, 19) and paf.shape == (368, 368, 38)
    assert heat.dtype == paf.dtype == np.float32
    assert np.abs(heat - j_heat).max() <= 1e-5 and np.abs(paf - j_paf).max() <= 1e-5
    assert np.array_equal(image, j_image)
    assert image.max() > 200 and heat[..., :18].max() > 0.9


def test_decode_twin_on_the_scene_matches_the_reference(scenes):
    from tpupose.config import DEFAULT as JDEFAULT
    from tpupose.reference_impl import decode_np as jdecode
    from tpupose_torch.reference_impl import decode_np as tdecode

    (_, heat, paf), (_, j_heat, j_paf) = scenes
    subset, cand = tdecode.decode_np(heat, paf, DEFAULT.inference)
    j_subset, j_cand = jdecode.decode_np(heat, paf, JDEFAULT.inference)
    assert np.array_equal(subset, j_subset) and np.array_equal(cand, j_cand)
    assert subset.shape == (2, 20) and (subset[:, -1] == 18).all()
    # on the reference's own maps: the same people, scores within 1e-5
    r_subset, r_cand = jdecode.decode_np(j_heat, j_paf, JDEFAULT.inference)
    assert np.array_equal(subset[:, :18], r_subset[:, :18])
    assert np.abs(subset - r_subset).max() <= 1e-5 and np.abs(cand - r_cand).max() <= 1e-5


def _reference_keys():
    """Top-level keys of the reference's JSON line (``main``'s last dict, with
    ``_measure_train``'s and ``_measure_feed``'s spread into it) and the keys
    of its sub-objects (the runs' and ``_measure_latency``'s), from its AST."""
    with open(os.path.join(ROOT, "tpupose", "benchmark.py")) as f:
        tree = ast.parse(f.read())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}

    def largest_dict(name):
        return max((n for n in ast.walk(funcs[name]) if isinstance(n, ast.Dict)),
                   key=lambda d: len(d.keys))

    def keys(node):
        return {k.value for k in node.keys if isinstance(k, ast.Constant)}

    line = largest_dict("main")
    top = keys(line) | keys(largest_dict("_measure_train")) | keys(largest_dict("_measure_feed"))
    runs = {k.value: keys(v) for k, v in zip(line.keys, line.values)
            if isinstance(k, ast.Constant) and isinstance(v, ast.Dict)}
    return top, runs, keys(largest_dict("_measure_latency"))


def test_line_keys_hold_every_key_of_the_reference():
    top, runs, latency = _reference_keys()
    assert len(top) == 26 and {"value", "train_mfu_pct", "feed_native_tpr_rps"} <= top
    assert set(tbench.LINE_KEYS) == top | {"card"}
    assert runs == {"headline_runs": {"median", "min", "max"},
                    "single_scale_runs": {"median", "min", "max"}}
    assert latency == {"wall_p50_ms", "wall_p99_ms", "device_mean_ms"}


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """``main(device="cpu")`` at the tiny configuration, its baseline cached in
    a fresh file: (stdout lines, stderr, cache path)."""
    cache = str(tmp_path_factory.mktemp("bench") / "baseline.json")
    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        mp.setattr(tflops, "PEAK_BF16_FLOPS", TINY_PEAK)
        tbench.main(baseline_cache=cache, device="cpu", cfg=TINY, size=64, counts=TINY_COUNTS)
    return out.getvalue().splitlines(), err.getvalue(), cache


def test_main_prints_one_line_with_every_key(tiny_run):
    lines, err, cache = tiny_run
    assert len(lines) == 1
    line = json.loads(lines[0])
    _, runs, latency = _reference_keys()
    assert list(line) == list(tbench.LINE_KEYS)
    for key, sub in runs.items():
        assert set(line[key]) == sub
        assert line[key]["min"] <= line[key]["median"] <= line[key]["max"]
    assert set(line["latency_single_scale_ms"]) == set(line["latency_4scale_ms"]) == latency
    assert line["card"] == "cpu" and line["train_batch"] == 2
    assert line["value"] == line["headline_runs"]["median"] > 0
    rates = ["vs_baseline", "single_scale_ips_wall", "single_scale_ips_on_device",
             "pyramid_ips_on_device", "single_scale_vs_baseline", "train_samples_per_s",
             "feed_native_tpr_rps", "feed_hdf5_lzf_rps"]
    assert all(line[k] > 0 for k in rates), {k: line[k] for k in rates}
    # the kernels' plain versions ran: a CPU run launches no kernel
    assert "bench: kernel launches " in err
    launches = json.loads(err.split("bench: kernel launches ")[1].splitlines()[0])
    assert set(launches) == {"block1", "pyramid_peaks", "sample", "assoc", "gt", "peaks",
                             "peak_tables", "dense_epilogue"}
    assert not any(launches.values())


def test_main_mfu_is_its_rates_over_the_peak(tiny_run):
    line = json.loads(tiny_run[0][0])
    mcfg = TINY.model
    fl4 = tflops.pyramid_flops(64, 64, (0.5, 1.0), 64, 8, 2)
    fl1 = tflops.forward_flops(64, 64, 2)
    assert line["model_tflops_per_image_4scale"] == round(fl4 / 1e12, 3)
    for key, rate, fl in (("mfu_4scale_wall_pct", "value", fl4),
                          ("mfu_4scale_on_device_pct", "pyramid_ips_on_device", fl4),
                          ("mfu_single_scale_wall_pct", "single_scale_ips_wall", fl1),
                          ("mfu_single_scale_on_device_pct", "single_scale_ips_on_device", fl1),
                          ("train_mfu_pct", "train_samples_per_s",
                           3 * tflops.forward_flops(mcfg.boxsize, mcfg.boxsize, 2))):
        # to the printed rounding: half a unit of the MFU's last place, and
        # what half a unit of the rate's last place moves it
        mfu_unit, rate_unit = (0.1, 0.1) if key == "train_mfu_pct" else (0.01, 0.001)
        tol = mfu_unit / 2 + 100.0 * rate_unit / 2 * fl / TINY_PEAK + 1e-9
        want = 100.0 * line[rate] * fl / TINY_PEAK
        assert 0 < line[key] <= 100 and abs(line[key] - want) <= tol, key


def test_main_measures_the_baseline_once_into_its_cache(tiny_run):
    lines, err, cache = tiny_run
    line = json.loads(lines[0])
    assert "measuring the reference pipeline's latency on this host's CPU" in err
    with open(cache) as f:
        base = json.load(f)
    assert set(base) == {"decode_s", "fwd_s_per_scale", "reference_cpu_latency_s",
                         "reference_cpu_latency_4scale_s", "note"}
    assert set(base["fwd_s_per_scale"]) == {"32x32", "64x64"}
    assert base["reference_cpu_latency_4scale_s"] == pytest.approx(
        base["decode_s"] + sum(base["fwd_s_per_scale"].values()))
    assert line["vs_baseline"] == round(line["value"] * base["reference_cpu_latency_4scale_s"], 2)
    # a second call reads the cache and measures nothing
    err2 = io.StringIO()
    with contextlib.redirect_stderr(err2):
        assert tbench.get_baseline(cache, TINY, 64) == base
    assert err2.getvalue() == ""


def test_feed_files_equal_the_references(tmp_path, monkeypatch):
    """The reference's ``_measure_feed`` writes its files (3 records, its
    feeds replaced by an endless stub and its clean-up by nothing); the
    port's ``_feed_files`` writes the same ``.tpr`` byte for byte, and an
    HDF5 file of the same records."""
    pytest.importorskip("h5py")
    import shutil
    import tempfile

    from tpupose import benchmark as jbench
    from tpupose.data import pipeline as jpipeline
    from tpupose_torch.data import hdf5 as thdf5

    ref_dir = tmp_path / "reference"
    ref_dir.mkdir()
    monkeypatch.setattr(tempfile, "mkdtemp", lambda *a, **k: str(ref_dir))
    monkeypatch.setattr(shutil, "rmtree", lambda *a, **k: None)
    for name in ("tpr_batches", "hdf5_batches"):
        monkeypatch.setattr(jpipeline, name, lambda *a, **k: itertools.repeat(None))
    jbench._measure_feed(n_records=3, batch=1)
    monkeypatch.undo()

    port_dir = tmp_path / "port"
    port_dir.mkdir()
    tp, h5 = tbench._feed_files(str(port_dir), DEFAULT, 368, 3)
    with open(tp, "rb") as f, open(ref_dir / "feed.tpr", "rb") as g:
        assert f.read() == g.read()
    got = list(thdf5.read_samples(h5))
    want = list(thdf5.read_samples(str(ref_dir / "feed.h5")))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in a)


def test_cli_bench_parses_and_reaches_main(monkeypatch, capsys, tmp_path):
    from tpupose_torch import cli

    with pytest.raises(SystemExit) as exit_:
        cli.main(["bench", "--help"])
    assert exit_.value.code == 0
    usage = capsys.readouterr().out
    assert "--device" in usage and "--baseline-cache" in usage
    calls = []
    monkeypatch.setattr(tbench, "main", lambda **kw: calls.append(kw))
    assert cli.main(["bench", "--device", "cpu", "--baseline-cache", str(tmp_path / "b.json")]) == 0
    assert cli.main(["bench"]) == 0
    assert calls == [{"baseline_cache": str(tmp_path / "b.json"), "device": "cpu"},
                     {"baseline_cache": None, "device": "cuda"}]
