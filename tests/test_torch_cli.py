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

The data path: prepare writes the reference CLI's .tpr file byte for byte
from a synthetic COCO set (testing.coco_keypoint_set: a polygon crowd, an
RLE crowd, an unannotated image); eval over it (--dataset, and
--annotations/--images from a checkpoint of convert-weights) prints the
reference CLI's JSON exactly, on a 2-stage estimator at boxsize 64 (f32;
one JAX estimator serves every reference run: one compile), and
--coco-results writes its records (coordinates equal, scores within
rtol 1e-5, atol 1e-4); the set's GT as detections scores AP 1.0. train
and finetune take 2 steps from a pre-padded .tpr file (2 stages, boxsize
64, batch 2); a run stopped after step 1 and resumed takes the same step
2, bit for bit, its feed position restored from the checkpoint; finetune
leaves every vgg tensor bit-identical.
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
from tpupose_torch.data import coco_eval as tcoco_eval
from tpupose_torch.data import pack_tpr
from tpupose_torch.testing import coco_keypoint_set, people_from_gt
from tpupose_torch.testing import limit_threads

limit_threads()

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
    """The commands whose modules the port holds: the four of the serving
    path, since the data path prepare, train, finetune and eval, since the
    deployment slice export-program, and since the benchmark slice bench:
    the reference CLI's commands, in its order."""
    rc, out, _ = _run(tcli, ["--help"], capsys)
    assert rc == 0
    usage = out[out.index("{"):out.index("}") + 1]
    assert usage == ("{demo-image,demo-video,prepare,train,finetune,eval,convert-weights,"
                     "export-weights,export-program,bench}")
    rc, out, _ = _run(jcli, ["--help"], capsys)
    assert rc == 0 and out[out.index("{"):out.index("}") + 1] == usage


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


# --- the data path: prepare, eval, train, finetune ------------------------------------------
EVAL_MODEL = ["--stages", "2", "--boxsize", "64", "--scales", "1", "--max-peaks", "32"]


def _call(cli, argv) -> tuple[int, str]:
    """cli.main(argv) outside a test's capsys (module fixtures): rc, stdout."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """The synthetic COCO set (one image shape: one JAX compile), the
    reference CLI's prepare of it, and a 2-stage weight file whose heads
    make the random network decode people."""
    d = tmp_path_factory.mktemp("coco")
    ann, images = coco_keypoint_set(str(d), [(96, 128)] * 6, seed=3)
    ref_tpr = str(d / "ref.tpr")
    rc, out = _call(jcli, ["prepare", "--annotations", ann, "--images", images,
                           "--output", ref_tpr])
    assert rc == 0 and "packed" in out
    return {"ann": ann, "images": images, "ref_tpr": ref_tpr, "dir": d,
            "h5": _write(d, "h5", _layers(2, seed=6, head_gain=1000.0))}


@pytest.fixture(scope="module")
def reference_eval(coco):
    """The JAX CLI's eval: --dataset (its prepare's file) and --annotations
    with --coco-results, both through one JAX estimator of the h5 file."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconfig, "DEFAULT", dataclasses.replace(
            jconfig.DEFAULT, model=dataclasses.replace(jconfig.DEFAULT.model,
                                                       compute_dtype="float32")))
        rc, _ = _call(jcli, ["eval", "--annotations", coco["ann"]])       # exit 2, no model
        assert rc == 2
        parser_args = jcli.argparse.Namespace(
            config=None, scales="1", boxsize=64, stages=2, decode_groups=None, max_peaks=32)
        est = _jax_estimator_from_params(jcli._config(parser_args), coco["h5"])
        mp.setattr(jcli, "_estimator", lambda args, cfg=None: est)
        results = str(coco["dir"] / "ref_results.json")
        out = {}
        for key, argv in (("dataset", ["--dataset", coco["ref_tpr"]]),
                          ("annotations", ["--annotations", coco["ann"], "--images",
                                           coco["images"], "--coco-results", results])):
            rc, stdout = _call(jcli, ["eval", *argv, "--weights", coco["h5"], *EVAL_MODEL])
            assert rc == 0
            out[key] = json.loads(stdout)
    with open(results) as f:
        out["coco_results"] = json.load(f)
    return out


def test_prepare_writes_the_reference_clis_file(coco, capsys, tmp_path):
    port_tpr = str(tmp_path / "port.tpr")
    rc, out, err = _run(tcli, ["prepare", "--annotations", coco["ann"], "--images",
                               coco["images"], "--output", port_tpr], capsys)
    assert rc == 0 and out.startswith("packed "), err
    with open(port_tpr, "rb") as a, open(coco["ref_tpr"], "rb") as b:
        assert a.read() == b.read()


def test_eval_prints_the_reference_clis_json(coco, reference_eval, f32_defaults, capsys,
                                             tmp_path):
    rc, out, err = _run(tcli, ["eval", "--dataset", coco["ref_tpr"], "--weights", coco["h5"],
                               *EVAL_MODEL, "--device", "cpu"], capsys)
    assert rc == 0, err
    assert json.loads(out) == reference_eval["dataset"]
    # --annotations, through a checkpoint of the port's converter
    ckpt, results = str(tmp_path / "ckpt"), str(tmp_path / "results.json")
    rc, _, err = _run(tcli, ["convert-weights", "--weights", coco["h5"], "--output", ckpt,
                             "--stages", "2"], capsys)
    assert rc == 0, err
    rc, out, err = _run(tcli, ["eval", "--annotations", coco["ann"], "--images", coco["images"],
                               "--checkpoint", ckpt, *EVAL_MODEL, "--device", "cpu",
                               "--coco-results", results], capsys)
    assert rc == 0, err
    got = json.loads(out)
    assert got == reference_eval["annotations"] and got["AP"] >= 0.0
    with open(results) as f:
        records = json.load(f)
    want = reference_eval["coco_results"]
    assert len(records) == len(want) > 12
    assert sorted({r["image_id"] for r in records}) == list(range(1000, 1006))
    for a, b in zip(records, want):
        assert (a["image_id"], a["category_id"]) == (b["image_id"], b["category_id"])
        np.testing.assert_allclose(a["score"], b["score"], rtol=1e-5, atol=1e-4)
        ka, kb = np.asarray(a["keypoints"]).reshape(17, 3), np.asarray(b["keypoints"]).reshape(17, 3)
        assert np.array_equal(ka[:, :2], kb[:, :2])
        np.testing.assert_allclose(ka[:, 2], kb[:, 2], rtol=1e-5, atol=1e-4)


def test_the_sets_gt_as_detections_scores_ap_1(coco):
    import argparse

    for source in (dict(annotations=coco["ann"], images=coco["images"]),
                   dict(annotations=None, dataset=coco["ref_tpr"])):
        gts = [gt for _, gt, _ in tcli._eval_inputs(argparse.Namespace(**source))]
        assert len(gts) >= 6 and any(g.get("iscrowd") for gt in gts for g in gt)
        res = tcoco_eval.evaluate([people_from_gt(gt) for gt in gts], gts)
        assert res["AP"] == res["AP50"] == res["AR"] == 1.0


@pytest.mark.parametrize("argv, message", [
    (["--dataset", "x.tpr", "--annotations", "a.json"], "mutually exclusive"),
    ([], "one of --dataset or --annotations is required"),
    (["--annotations", "a.json"], "--annotations requires --images"),
])
def test_eval_exit_2_error_paths(capsys, argv, message):
    rc, out, err = _run(tcli, ["eval", *argv, "--device", "cpu"], capsys)
    assert rc == 2 and message in err and out == ""


@pytest.fixture(scope="module")
def train_file(coco, tmp_path_factory):
    fast = str(tmp_path_factory.mktemp("train") / "fast.tpr")
    assert pack_tpr.main(["--input", coco["ref_tpr"], "--output", fast, "--pre-pad", "368",
                          "368", "--max-persons", "24"]) == 0
    return fast


TRAIN = ["--stages", "2", "--boxsize", "64", "--batch-size", "2", "--device", "cpu"]


def test_train_resumes_its_step_and_feed_position_bit_for_bit(train_file, f32_defaults, capsys,
                                                              tmp_path):
    from tpupose_torch.training import checkpoint

    def train(workdir, steps):
        rc, out, err = _run(tcli, ["train", "--dataset", train_file, "--workdir", workdir,
                                   "--max-steps", str(steps), *TRAIN], capsys)
        assert rc == 0, err
        return json.loads(out)

    whole, part = str(tmp_path / "whole"), str(tmp_path / "part")
    two = train(whole, 2)
    assert two["steps"] == 2 and len(two["last_losses"]) == 5
    assert train(part, 1)["steps"] == 1
    with np.load(os.path.join(part, "checkpoints", "step_000000001.npz")) as f:
        assert json.loads(f["data_state"].tobytes()) == {"epoch": 0, "offset": 2, "version": 1}
    resumed = train(part, 2)
    assert resumed["steps"] == 1 and resumed["last_losses"] == two["last_losses"]
    want, got = (checkpoint.restore_params(os.path.join(d, "checkpoints")) for d in (whole, part))
    for scope, layers in want.items():
        for layer, leaves in layers.items():
            for leaf, arr in leaves.items():
                assert np.array_equal(got[scope][layer][leaf], arr), (scope, layer, leaf)


def test_finetune_leaves_every_vgg_tensor_bit_identical(train_file, f32_defaults, capsys,
                                                        tmp_path):
    from tpupose_torch.models import OpenPose
    from tpupose_torch.models import weights as tweights
    from tpupose_torch.training import checkpoint

    rc, out, err = _run(tcli, ["finetune", "--dataset", train_file, "--workdir", str(tmp_path),
                               "--max-steps", "2", *TRAIN], capsys)
    assert rc == 0 and json.loads(out)["steps"] == 2, err
    model = OpenPose(num_stages=2, dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(0))         # loop.train's init
    start = tweights.to_flax(model.state_dict())
    end = checkpoint.restore_params(str(tmp_path / "checkpoints"))
    for layer, leaves in start["vgg"].items():
        for leaf, arr in leaves.items():
            assert np.array_equal(end["vgg"][layer][leaf], arr), (layer, leaf)
    assert not np.array_equal(end["stage2_L1"]["conv1"]["kernel"],
                              start["stage2_L1"]["conv1"]["kernel"])


# --- the multi-device slice: --grain, eval --dp, serve --dp ----------------------------------


def test_train_grain_feed_keeps_its_position_in_the_checkpoint(f32_defaults, capsys, tmp_path):
    """`train --grain --data-workers 0` over an HDF5 dataset: the
    checkpointable feed of data/grain_pipeline.py, its position (records
    consumed, in its epoch) in the step's checkpoint, and a second run
    resumes from it."""
    from tpupose_torch.data import hdf5 as thdf5

    path = str(tmp_path / "ds.h5")
    rng = np.random.default_rng(2)
    with thdf5.SampleWriter(path) as w:
        for i in range(6):
            joints = np.full((1, 18, 3), 2.0, np.float32)
            joints[0, :, :2] = rng.uniform(20, 80, (18, 2))
            joints[0, :, 2] = 0.0
            w.add(rng.integers(0, 255, (96, 112, 3)).astype(np.uint8),
                  np.full((96, 112), 255, np.uint8), joints,
                  np.asarray([56.0, 48.0], np.float32), np.float32(0.3 + i / 100))

    def train(steps):
        rc, out, err = _run(tcli, ["train", "--dataset", path, "--grain", "--data-workers", "0",
                                   "--workdir", str(tmp_path / "run"), "--max-steps", str(steps),
                                   *TRAIN], capsys)
        assert rc == 0, err
        return json.loads(out)

    assert train(2)["steps"] == 2
    with np.load(os.path.join(tmp_path, "run", "checkpoints", "step_000000002.npz")) as f:
        assert json.loads(f["data_state"].tobytes()) == {
            "seed": 0, "shard": [0, 1], "epoch": 0, "position": 4, "version": 1}
    assert train(3)["steps"] == 1
    with np.load(os.path.join(tmp_path, "run", "checkpoints", "step_000000003.npz")) as f:
        assert json.loads(f["data_state"].tobytes())["epoch"] == 1     # 6 records, batch 2


def test_eval_dp_requires_buckets_with_the_reference_text(capsys):
    argv = ["eval", "--annotations", "a.json", "--images", "imgs", "--dp", "2"]
    rc, out, err = _run(tcli, [*argv, "--device", "cpu"], capsys)
    assert rc == 2 and out == ""
    jrc, _, jerr = _run(jcli, argv, capsys)
    assert jrc == 2
    want = "error: --dp requires --buckets (per-image eval never builds device batches to shard)"
    assert want in err and want in jerr
    rc, _, err = _run(tcli, [*argv, "--buckets", "default", "--device", "cpu"], capsys)
    assert rc == 2 and "error: --dp 2 exceeds the 1 visible device(s)" in err


def test_eval_dp_1_prints_the_same_json(coco, f32_defaults, capsys):
    argv = ["eval", "--dataset", coco["ref_tpr"], "--weights", coco["h5"], *EVAL_MODEL,
            "--buckets", "96x128", "--eval-batch", "4", "--max-images", "3", "--device", "cpu"]
    rc, plain, err = _run(tcli, argv, capsys)
    assert rc == 0, err
    rc, dp, err = _run(tcli, [*argv, "--dp", "1"], capsys)
    assert rc == 0 and "data-parallel" not in err, err
    assert json.loads(dp) == json.loads(plain)


@pytest.mark.parametrize("spec, message", [
    ("2", "error: --dp 2 exceeds the 1 visible device(s)"),
    ("0", "error: --dp must be >= 1, got 0"),
    ("many", "error: --dp must be a device count or 'auto', got 'many'"),
])
def test_serve_dp_is_validated_before_the_model_is_built(capsys, monkeypatch, spec, message):
    import tpupose_torch.serve as tserve

    def no_model(*a, **k):
        raise AssertionError("the model was built")

    monkeypatch.setattr(tcli, "_estimator", no_model)
    rc, out, err = _run(tserve, ["--dp", spec, "--device", "cpu"], capsys)
    assert rc == 2 and message in err
