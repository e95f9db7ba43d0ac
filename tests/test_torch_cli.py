"""The port's command line (``tpupose_torch/cli.py``) against the JAX
package's.

demo-image of both CLIs on the same image and weight file prints the same
people (coordinates equal, scores within rtol 1e-5, atol 1e-4, the tolerance
of tests/test_torch_infer.py). Both run with the same arguments, their
``config.DEFAULT`` set to f32 compute for the test (the CLI has no dtype
flag, and two bf16 networks on the CPU agree only to bf16). The JAX CLI's
estimator is built from the JAX loader's tree of the file (its seeded init,
which a full file replaces leaf for leaf, runs the network eagerly at
368x368, the longest step of this file on the CPU).
convert-weights then export-weights gives back the file's arrays bit for
bit; the --config and exit-2 paths and the --max-peaks ladders are those of
tests/test_cli.py; demo-video runs a 4-frame clip.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpupose.cli as jcli
import tpupose.config as jconfig
import tpupose.infer as jinfer
import tpupose_torch.cli as tcli
import tpupose_torch.config as tconfig
from tests.test_torch_weights import _jax_tree, _layers, _write, assert_same_people
from tpupose.models import weights as jweights
from tpupose_torch import topology

JaxEstimator = jinfer.PoseEstimator
# --max-peaks 32: ladders (8, 16) and (16,); at the default 96 the JAX decode's
# tier ladder takes longer to compile than all the rest of this file
MODEL = ["--scales", "0.5", "--stages", "1", "--max-peaks", "32"]


def _run(cli, argv, capsys) -> tuple[int, str, str]:
    try:
        rc = cli.main(argv)
    except SystemExit as e:     # argparse and the CLI's own exits
        rc = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
        if isinstance(e.code, str):
            print(e.code, file=sys.stderr)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    import cv2

    d = tmp_path_factory.mktemp("cli")
    layers = _layers(1, seed=6, head_gain=1000.0)
    image = str(d / "in.png")
    cv2.imwrite(image, (np.random.default_rng(7).random((160, 200, 3)) * 255).astype(np.uint8))
    return {"h5": _write(d, "h5", layers), "caffemodel": _write(d, "caffemodel", layers),
            "image": image, "layers": layers, "dir": d}


@pytest.fixture
def f32_defaults(monkeypatch):
    for mod in (jconfig, tconfig):
        monkeypatch.setattr(mod, "DEFAULT", dataclasses.replace(
            mod.DEFAULT, model=dataclasses.replace(mod.DEFAULT.model, compute_dtype="float32")))


def _jax_estimator_from_params(cfg, weights_path=None, seed=0):
    tree, pretrained = jweights.maybe_load_pretrained(_jax_tree(cfg.model.num_stages),
                                                      weights_path)
    assert pretrained
    return JaxEstimator(cfg, params=jax.tree.map(jnp.asarray, tree))


def _people(stdout: str) -> list:
    return json.loads(stdout[stdout.index("["):])


def test_help_lists_exactly_the_four_commands(capsys):
    rc, out, _ = _run(tcli, ["--help"], capsys)
    assert rc == 0
    usage = out[out.index("{"):out.index("}") + 1]
    assert usage == "{demo-image,demo-video,convert-weights,export-weights}"


def test_demo_image_prints_the_reference_cli_people(files, f32_defaults, monkeypatch, capsys,
                                                    tmp_path):
    monkeypatch.setattr(jinfer, "PoseEstimator", _jax_estimator_from_params)
    argv = ["demo-image", "--image", files["image"], "--weights", files["h5"], *MODEL]
    rc, out, err = _run(jcli, argv, capsys)
    assert rc == 0, err
    want = _people(out)
    assert len(want) >= 3
    overlay, json_path = str(tmp_path / "overlay.png"), str(tmp_path / "people.json")
    rc, out, err = _run(tcli, [*argv, "--device", "cpu", "--output", overlay,
                               "--json", json_path], capsys)
    assert rc == 0, err
    assert "untrained" not in err and os.path.exists(overlay)
    got = _people(out)
    assert_same_people(got, want)
    with open(json_path) as f:
        assert json.load(f) == got


def test_convert_then_export_round_trips_bit_equal(files, f32_defaults, capsys, tmp_path):
    ckpt, back = str(tmp_path / "ckpt"), str(tmp_path / "back.h5")
    rc, out, err = _run(tcli, ["convert-weights", "--weights", files["caffemodel"],
                               "--output", ckpt, "--stages", "1"], capsys)
    assert rc == 0 and "converted" in out, err
    rc, out, err = _run(tcli, ["export-weights", "--checkpoint", ckpt, "--output", back], capsys)
    assert rc == 0 and f"exported {len(files['layers'])} layers" in out, err
    import h5py

    with h5py.File(back) as f:
        for name, (kernel, bias) in files["layers"].items():
            assert np.array_equal(f[name][f"{name}/kernel:0"][()], kernel), name
            assert np.array_equal(f[name][f"{name}/bias:0"][()], bias), name
    # the checkpoint serves as --checkpoint: the same people as the file itself
    base = ["demo-image", "--image", files["image"], *MODEL, "--device", "cpu"]
    rc, out_ckpt, err = _run(tcli, [*base, "--checkpoint", ckpt], capsys)
    assert rc == 0 and "untrained" not in err
    rc, out_file, _ = _run(tcli, [*base, "--weights", files["h5"]], capsys)
    assert _people(out_ckpt) == _people(out_file)
    rc, _, err = _run(tcli, ["export-weights", "--checkpoint", str(tmp_path / "none"),
                             "--output", back], capsys)
    assert rc == 1 and "no checkpoint found" in err


def test_config_ini_json_and_the_weights_it_names(files, f32_defaults, capsys, tmp_path):
    ini = tmp_path / "config"
    rel = os.path.relpath(files["caffemodel"], tmp_path)
    ini.write_text("[param]\nscale_search = [0.5]\nthre1 = 0.1\nthre2 = 0.05\n"
                   f"[models]\n[[1]]\ncaffemodel = '{rel}'\nboxsize = 368\nstride = 8\n"
                   "padValue = 128\n")
    json_path = str(tmp_path / "people.json")
    rc, out, err = _run(tcli, ["demo-image", "--image", files["image"], "--json", json_path,
                               "--config", str(ini), "--stages", "1", "--max-peaks", "32",
                               "--device", "cpu"], capsys)
    assert rc == 0, err
    assert "using weights from reference config" in err and "untrained" not in err
    with open(json_path) as f:
        assert json.load(f) == _people(out)
    rc, out_direct, _ = _run(tcli, ["demo-image", "--image", files["image"], *MODEL,
                                    "--weights", files["caffemodel"], "--device", "cpu"], capsys)
    assert _people(out_direct) == _people(out)


def test_exit_2_error_paths(tmp_path, capsys):
    rc, _, err = _run(tcli, ["demo-image", "--image", "x.png",
                             "--config", str(tmp_path / "nope.ini")], capsys)
    assert rc == 2 and "error: cannot read" in err
    bad = tmp_path / "bad.ini"
    bad.write_text("key_without_any_section = 1\n")
    rc, _, err = _run(tcli, ["demo-image", "--image", "x.png", "--config", str(bad)], capsys)
    assert rc == 2 and "error: cannot parse" in err
    rc, _, err = _run(tcli, ["demo-image", "--image", str(tmp_path / "absent.png"), "--stages",
                             "1", "--scales", "0.5", "--device", "cpu"], capsys)
    assert rc == 2 and "cannot read" in err and "untrained" in err
    rc, _, err = _run(tcli, ["demo-image", "--image", "x.png", "--stages", "1", "--device", "cpu",
                             "--checkpoint", str(tmp_path / "nope")], capsys)
    assert rc != 0 and "no checkpoint found" in err


@pytest.mark.parametrize("max_peaks", [None, 16, 32, 128])
def test_max_peaks_rebuilds_the_tier_ladders_as_the_reference(max_peaks):
    import argparse

    ns = dict(config=None, scales=None, boxsize=None, stages=None, decode_groups=None,
              max_peaks=max_peaks, weights=None, checkpoint=None)
    got = tcli._config(argparse.Namespace(**ns))
    assert dataclasses.asdict(got) == dataclasses.asdict(jcli._config(argparse.Namespace(**ns)))
    want_tiers = {None: (8, 16, 32, 64), 16: (8,), 32: (8, 16), 128: (8, 16, 32, 64, 96)}
    assert got.inference.pair_tiers == want_tiers[max_peaks]
    assert got.inference.max_peaks == (max_peaks or 96)
    assert all(t < got.inference.max_peaks for t in got.inference.peak_compact_tiers)


def _write_clip(path, n_frames=4, w=96, h=96, fps=25.0):
    """A tiny mp4: a bright square drifting over noise (tests/test_cli.py)."""
    import cv2

    bg = np.random.default_rng(7).integers(0, 120, (h, w, 3)).astype(np.uint8)
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    assert wr.isOpened()
    for i in range(n_frames):
        frame = bg.copy()
        x = 8 + 5 * i
        cv2.rectangle(frame, (x, 20), (x + 16, 60), (255, 255, 255), -1)
        wr.write(frame)
    wr.release()


def _frames(path) -> int:
    import cv2

    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def test_demo_video_e2e(tmp_path, capsys):
    clip, out = str(tmp_path / "in.mp4"), str(tmp_path / "out.mp4")
    _write_clip(clip)
    rc, _, err = _run(tcli, ["demo-video", "--input", clip, "--output", out, "--track",
                             "--smooth", "0.5", "--max-frames", "4", "--stages", "1",
                             "--boxsize", "64", "--max-peaks", "16", "--device", "cpu"], capsys)
    assert rc == 0, err
    assert "4 frames" in err and _frames(out) == 4


def test_demo_video_tracking_stable_ids(tmp_path, monkeypatch, capsys):
    """A fake estimator emits one person moving 3 px a frame: the tracker
    gives it one id in every frame (tests/test_cli.py, on the port)."""
    from tpupose_torch.tracking import PoseTracker

    clip, out = str(tmp_path / "in.mp4"), str(tmp_path / "out.mp4")
    _write_clip(clip, n_frames=5)

    class FakeEstimator:
        pretrained = True
        calls = 0

        def process_async(self, image):
            i, self.calls = self.calls, self.calls + 1
            n = topology.NUM_PARTS
            return {"rows": torch.arange(n, dtype=torch.int32)[None],
                    "score": torch.tensor([12.0]), "cnt": torch.tensor([n], dtype=torch.int32),
                    "valid": torch.tensor([True]), "peak_xs": torch.full((n,), 20.0 + 3.0 * i),
                    "peak_ys": torch.linspace(10.0, 60.0, n), "peak_scores": torch.full((n,), 0.9)}

    fake = FakeEstimator()
    monkeypatch.setattr(tcli, "_estimator", lambda args, cfg=None: fake)
    seen_ids = []
    orig_update = PoseTracker.update

    def spying_update(self, people):
        people = orig_update(self, people)
        seen_ids.append([p["track_id"] for p in people])
        return people

    monkeypatch.setattr(PoseTracker, "update", spying_update)
    rc, _, err = _run(tcli, ["demo-video", "--input", clip, "--output", out, "--track",
                             "--smooth", "0.5", "--max-frames", "5", "--stages", "1"], capsys)
    assert rc == 0, err
    assert fake.calls == 5 and len(seen_ids) == 5
    assert all(len(ids) == 1 for ids in seen_ids) and len({ids[0] for ids in seen_ids}) == 1
    assert _frames(out) == 5
