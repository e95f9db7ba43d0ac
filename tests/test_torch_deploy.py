"""Deployment bundles of the port (``tpupose_torch.deploy``) on the CPU.

The contract, as ``tests/test_deploy.py`` holds the reference's: a bundle
written by ``save_bundle`` reproduces the port's live estimator's people
JSON bit for bit (every comparison sees at least one person: the heads
are scaled as in ``tests/test_torch_infer.py``), loads in a fresh process
without the model's code, fails loudly on corruption, and drops into
``BucketedRunner``, the HTTP server (``serve --program``) and the CLI
(``export-program``). Beside that: the bundle against the JAX package's
live estimator on the same weights, within ``test_torch_infer``'s
tolerances (the two frameworks' f32 convolutions sum in different orders);
its ``weights.npz`` equal, key for key, to the JAX bundle's; both branches
of the decode's peak-overflow switch, a ``cond`` in the graph; the six
registered operators under ``torch.library.opcheck``; the graphs calling
them; and programs small beside the weights. Small: one stage, f32 (bf16
where block1 must be in the graph), scale 0.5, a 96x96 bucket.
"""

import dataclasses
import io
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from tpupose_torch.config import InferenceConfig, ModelConfig, PoseConfig
from tpupose_torch.deploy import FORMAT, load_bundle, retarget, save_bundle
from tpupose_torch.infer import PoseEstimator
from tpupose_torch.models import weights as weights_lib
from tpupose_torch.testing import limit_threads

limit_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKET = (96, 96)
INFER = dict(scale_search=(0.5,), max_peaks=16, max_people=16, pair_tiers=(8,),
             peak_compact_tiers=(8,))
CFG = PoseConfig(model=ModelConfig(num_stages=1, compute_dtype="float32"),
                 inference=InferenceConfig(**INFER))


def _params(seed=0):
    """The port's seeded init as a flax tree, its output heads scaled so
    that the random network emits peaks and limbs."""
    est = PoseEstimator(CFG, seed=seed, device="cpu")
    params = weights_lib.to_flax(est.model.state_dict())
    for branch in ("stage1_L1", "stage1_L2"):
        params[branch]["out"]["kernel"] = params[branch]["out"]["kernel"] * 3000.0
    return params


def _same(got, want):
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    return sum(len(p) for p in want)


def _batch(seed=0, n=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (n, *BUCKET, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def params():
    return _params()


@pytest.fixture(scope="module")
def est(params):
    return PoseEstimator(CFG, params=params, device="cpu")


@pytest.fixture(scope="module")
def bundle(est, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("deploy") / "model.tppx")
    manifest = save_bundle(path, est, [BUCKET], max_batch=5)
    assert [tuple(b) for b in manifest["buckets"]] == [BUCKET]
    assert sorted(p["n"] for p in manifest["programs"]) == [1, 2, 4, 8]
    assert manifest["format"] == FORMAT and manifest["device_type"] == "cpu"
    assert manifest["device"] == "cpu"
    assert manifest["torch_version"] == torch.__version__
    assert manifest["paf_readout"] == "scalespace" and manifest["num_stages"] == 1
    return path


@pytest.fixture(scope="module")
def dep(bundle):
    return load_bundle(bundle, device="cpu")


def test_bundle_roundtrip_bit_identical(est, dep):
    imgs = _batch()
    valid = np.asarray([[96, 96], [80, 64]], np.int32)
    live = est.process_batch(imgs, valid_hw=valid)
    assert _same(dep.process_batch(imgs, valid_hw=valid), live) > 0
    # the default valid_hw (the full canvas) equals an explicit full mask
    full = np.asarray([[96, 96]] * 2, np.int32)
    assert _same(dep.process_batch(imgs), dep.process_batch(imgs, valid_hw=full)) > 0
    assert _same(dep.process_batch(imgs), est.process_batch(imgs)) > 0


def test_bundle_single_image_routes_through_buckets(est, dep):
    from tpupose_torch.buckets import to_bucket

    img = _batch(seed=3, n=1)[0][:80, :64]   # off-ladder shape
    out = dep.process(img, draw=True)
    assert out["canvas"].shape == img.shape
    canvas, vh, vw = to_bucket(img, *BUCKET, 1.0)
    live = est.process_batch(canvas[None], valid_hw=np.asarray([[vh, vw]], np.int32))
    assert _same([out["people"]], live) > 0


def test_bundle_bucketed_runner_dropin(est, dep):
    """DeployedEstimator drops into buckets.BucketedRunner unchanged: 3
    images at batch_size 2 make a full flush and a padded remainder."""
    from tpupose_torch.buckets import BucketedRunner

    rng = np.random.default_rng(11)
    images = [rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
              for h, w in [(96, 96), (80, 64), (50, 90)]]
    packed = BucketedRunner(dep, buckets=dep.buckets, scales=dep.scales,
                            batch_size=2).process_many(images)
    live = BucketedRunner(est, buckets=dep.buckets, scales=dep.scales,
                          batch_size=2).process_many(images)
    assert _same(packed, live) > 0


def test_bundle_pow2_padding_and_ceiling(est, dep):
    """--max-batch 5 exports batch-1/2/4/8 programs and serves up to 8; n=3
    runs the n=4 program on the last image repeated, n=6 the n=8 one, and
    equals the live estimator on the same padded batch."""
    assert dep.max_batch == 8 and dep.manifest["max_batch"] == 5
    for n, nb, seed in ((3, 4, 9), (6, 8, 10)):
        imgs = _batch(seed=seed, n=n)
        padded = np.concatenate([imgs, np.repeat(imgs[-1:], nb - n, axis=0)])
        got = dep.process_batch(imgs)
        assert len(got) == n
        assert _same(got, est.process_batch(padded)[:n]) > 0


def test_bundle_rejects_foreign_scales_and_shapes(dep):
    imgs = _batch()
    with pytest.raises(ValueError, match="compiled into the artifact"):
        dep.process_batch(imgs, scales=(1.0,))
    dep.process_batch(imgs, scales=dep.scales)    # the exported ladder passes
    with pytest.raises(ValueError, match="no program"):
        dep.process_batch(np.zeros((9, 96, 96, 3), np.uint8))
    with pytest.raises(ValueError, match="no program"):
        dep.process_batch(np.zeros((1, 64, 96, 3), np.uint8))


def _rewrite(src, dst, edit):
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for info in zin.infolist():
            zout.writestr(info, edit(info.filename, zin.read(info.filename)))


def _flip(data):
    return data[:100] + bytes([data[100] ^ 0xFF]) + data[101:]


def _manifest_edit(**changes):
    def edit(name, data):
        if name != "manifest.json":
            return data
        return json.dumps({**json.loads(data), **changes}).encode()
    return edit


@pytest.mark.parametrize("case, match", [
    ("program", "program programs/96x96_b1.pt2 corrupted"),
    ("weights", "weights corrupted"),
    ("format", "unsupported bundle format 'tppx-v999'"),
    ("device", "exported for 'cuda' devices"),
])
def test_bundle_corruption_detected(bundle, tmp_path, case, match):
    edit = {
        "program": lambda n, d: _flip(d) if n == "programs/96x96_b1.pt2" else d,
        "weights": lambda n, d: _flip(d) if n == "weights.npz" else d,
        "format": _manifest_edit(format="tppx-v999"),
        "device": _manifest_edit(device_type="cuda"),
    }[case]
    bad = str(tmp_path / "bad.tppx")
    _rewrite(bundle, bad, edit)
    with pytest.raises(ValueError, match=match):
        load_bundle(bad, device="cpu")


@pytest.mark.parametrize("manifest, requested, moves", [
    ({"device_type": "cuda", "device": "cuda:0"}, "cuda:0", {}),
    ({"device_type": "cuda", "device": "cuda:0"}, "cuda:1",
     {"cuda:0": "cuda:1", "cuda": "cuda:1"}),
    ({"device_type": "cuda", "device": "cuda:3"}, "cuda:0",
     {"cuda:3": "cuda:0", "cuda": "cuda:0"}),
    # a manifest written before it named the device: cuda:0 or the CPU
    ({"device_type": "cuda"}, "cuda:0", {}),
    ({"device_type": "cuda"}, "cuda:1", {"cuda:0": "cuda:1", "cuda": "cuda:1"}),
    ({"device_type": "cpu"}, "cpu", {}),
    ({"device_type": "cpu", "device": "cpu"}, "cpu", {}),
])
def test_retarget_maps_the_export_device_onto_the_requested_one(manifest, requested, moves):
    assert retarget(manifest, torch.device(requested)) == moves


@pytest.mark.parametrize("manifest, requested, match", [
    ({"device_type": "cuda", "device": "cuda:0"}, "cpu", "exported for 'cuda' devices; "
     "cannot run them on cpu"),
    ({"device_type": "cpu", "device": "cpu"}, "cuda:1", "exported for 'cpu' devices; "
     "cannot run them on cuda:1"),
    ({"device_type": "cuda"}, "cpu", "exported for 'cuda' devices"),
    ({"device_type": "cuda", "device": "cpu"}, "cuda:0", "names device cpu for device type 'cuda'"),
])
def test_retarget_refuses_another_device_type(manifest, requested, match):
    with pytest.raises(ValueError, match=match):
        retarget(manifest, torch.device(requested))


def test_bundle_without_a_device_entry_loads_as_before(est, bundle, tmp_path):
    """A manifest without ``"device"`` reads as ``cpu`` here: it loads and
    runs bit for bit as the bundle that names it."""
    def drop_device(name, data):
        if name != "manifest.json":
            return data
        manifest = json.loads(data)
        del manifest["device"]
        return json.dumps(manifest).encode()

    old = str(tmp_path / "old.tppx")
    _rewrite(bundle, old, drop_device)
    dep = load_bundle(old, device="cpu")
    assert "device" not in dep.manifest and dep.device == torch.device("cpu")
    imgs = _batch(seed=5)
    assert _same(dep.process_batch(imgs), est.process_batch(imgs)) > 0


def test_bundle_fresh_process_no_model_code(est, bundle, tmp_path):
    """A fresh interpreter loads the bundle and reproduces the live output
    without importing the model's code or the live estimator."""
    imgs = _batch(seed=7)
    np.save(tmp_path / "imgs.npy", imgs)
    expected = est.process_batch(imgs)
    assert sum(len(p) for p in expected) > 0
    code = f"""
import json, sys
import numpy as np
import torch
torch.set_num_threads({torch.get_num_threads()})   # the CPU convs round by thread count
from tpupose_torch.deploy import load_bundle
dep = load_bundle({bundle!r}, device="cpu")
people = dep.process_batch(np.load({str(tmp_path / 'imgs.npy')!r}))
for name in ("tpupose_torch.models", "tpupose_torch.models.openpose", "tpupose_torch.infer"):
    assert name not in sys.modules, name
print(json.dumps(people, sort_keys=True))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == json.dumps(expected, sort_keys=True)


def test_bundle_serves_http(est, dep):
    """One request through serve(dep) with the bundle's ladder: its reply is
    the live estimator's people on the same device batch (one canvas)."""
    import http.client

    from tpupose_torch.buckets import to_bucket
    from tpupose_torch.serve import serve
    from tpupose_torch.testing import png_bytes

    srv = serve(dep, port=0, max_batch=2, buckets=dep.buckets, request_timeout_s=300.0)
    try:
        c = http.client.HTTPConnection(*srv.server_address[:2], timeout=300)
        c.request("GET", "/healthz")
        r = c.getresponse()
        assert r.status == 200 and json.loads(r.read())["pretrained"] is True
        img = _batch(seed=5, n=1)[0]
        c.request("POST", "/pose", body=png_bytes(img))
        r = c.getresponse()
        assert r.status == 200
        people = json.loads(r.read())["people"]
    finally:
        srv.shutdown()
        srv.batcher.close()
    canvas, vh, vw = to_bucket(img, *BUCKET, 1.0)
    live = est.process_batch(canvas[None], valid_hw=np.asarray([[vh, vw]], np.int32))
    assert _same([people], json.loads(json.dumps(live))) > 0


@pytest.mark.parametrize("argv", [
    ["--weights", "x.h5"], ["--checkpoint", "ckpt"], ["--config", "x.ini"],
    ["--scales", "1"], ["--boxsize", "256"], ["--stages", "2"], ["--decode-groups", "2"],
    ["--max-peaks", "32"], ["--dp", "2"], ["--buckets", "64x64"], ["--max-batch", "2"],
    ["missing"],
])
def test_serve_main_rejects_conflicting_flags(cli_bundle, tmp_path, argv):
    """Exit code 2, with the live model's flags before the bundle loads and
    with a ladder or a max batch the bundle lacks (its max batch: 1) after."""
    from tpupose_torch import serve as serve_mod

    if argv == ["missing"]:
        argv = ["--program", str(tmp_path / "missing.tppx")]
    else:
        argv = ["--program", cli_bundle, *argv]
    assert serve_mod.main([*argv, "--device", "cpu"]) == 2


@pytest.fixture(scope="module")
def cli_bundle(tmp_path_factory):
    """``cli export-program`` of the default configuration cut to one stage
    and scale 0.5 (bf16, block 1 fused), one 96x96 program."""
    from tpupose_torch import cli

    out = str(tmp_path_factory.mktemp("cli") / "tiny.tppx")
    rc = cli.main([
        "export-program", "--output", out, "--buckets", "96x96", "--max-batch", "1",
        "--scales", "0.5", "--stages", "1", "--device", "cpu",
    ])
    assert rc == 0
    return out


def test_cli_export_program(cli_bundle):
    dep = load_bundle(cli_bundle, device="cpu")
    assert dep.buckets == ((96, 96),) and dep.max_batch == 1 and dep.scales == (0.5,)
    assert dep.manifest["compute_dtype"] == "bfloat16"
    assert len(dep.process_batch(_batch(seed=1, n=1))) == 1


# --- against the JAX package -----------------------------------------------------------------


def _jax_estimator(params):
    import jax
    import jax.numpy as jnp

    from tpupose.config import InferenceConfig as JInference
    from tpupose.config import ModelConfig as JModel
    from tpupose.config import PoseConfig as JPose
    from tpupose.infer import PoseEstimator as JaxEstimator

    cfg = JPose(model=JModel(num_stages=1, compute_dtype="float32"),
                inference=JInference(**INFER))
    return JaxEstimator(cfg, params=jax.tree.map(jnp.asarray, params))


def test_bundle_matches_the_reference_estimator(params, dep):
    from tests.test_torch_infer import _assert_same_people

    imgs = _batch(seed=2)
    valid = np.asarray([[96, 96], [88, 72]], np.int32)
    want = _jax_estimator(params).process_batch(imgs, valid_hw=valid)
    assert sum(len(p) for p in want) > 0
    _assert_same_people(dep.process_batch(imgs, valid_hw=valid), want)


def test_weights_equal_the_reference_bundle_and_formats_are_refused(params, bundle, tmp_path):
    from tpupose import deploy as jdeploy

    jpath = str(tmp_path / "jax.tppx")
    jdeploy.save_bundle(jpath, _jax_estimator(params), [BUCKET], max_batch=1)

    def weights(path):
        with zipfile.ZipFile(path) as zf, np.load(io.BytesIO(zf.read("weights.npz"))) as npz:
            return {k: npz[k] for k in npz.files}

    got, want = weights(bundle), weights(jpath)
    assert list(got) == list(want) and len(got) > 20
    for key in want:
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key
    with pytest.raises(ValueError, match="unsupported bundle format 'tppx-v1'"):
        load_bundle(jpath, device="cpu")
    with pytest.raises(ValueError, match="unsupported bundle format 'tppx-torch-v1'"):
        jdeploy.load_bundle(bundle)


# --- the program: the overflow switch, the operators, the size ---------------------------------


def _graph_targets(ep) -> set[str]:
    """Every call target of a program's graph and of its subgraphs."""
    out = set()
    for gm in ep.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            out |= {str(n.target) for n in gm.graph.nodes if n.op == "call_function"}
    return out


def _program(path, key):
    with zipfile.ZipFile(path) as zf:
        return torch.export.load(io.BytesIO(zf.read(f"programs/{key}.pt2")))


@pytest.mark.parametrize("max_peaks, overflows", [(16, True), (64, False)])
def test_overflow_switch_is_a_cond_on_both_branches(params, est, bundle, dep, tmp_path,
                                                    max_peaks, overflows):
    """Peak tables in score order (a row holds more peaks than max_peaks:
    the module's bundle) and in scan order (max_peaks 64, ladders below
    it), the switch a cond in the program: the bundle equals the live
    estimator in both."""
    from tpupose_torch.decode.peaks import overflowed

    live, path, packed, n = est, bundle, dep, 2
    if max_peaks != CFG.inference.max_peaks:
        cfg = dataclasses.replace(CFG, inference=dataclasses.replace(
            CFG.inference, max_peaks=max_peaks, pair_tiers=(8, 16, 32), peak_compact_tiers=(32,)))
        live = PoseEstimator(cfg, params=params, device="cpu")
        path, n = str(tmp_path / "k.tppx"), 1
        save_bundle(path, live, [BUCKET], max_batch=n)
        packed = load_bundle(path, device="cpu")
    imgs = _batch(seed=4, n=n)
    flats = live._scores(imgs, None, None)[0]
    assert bool(overflowed(flats.reshape(-1, flats.shape[-1]), max_peaks)) is overflows
    targets = _graph_targets(_program(path, f"96x96_b{n}"))
    assert "cond" in targets and "tpupose_torch.peak_tables.default" in targets
    got = packed.process_batch(imgs)
    assert _same(got, live.process_batch(imgs)) > 0


def _called_operators(path, key="96x96_b1") -> set[str]:
    return {t.split(".")[1] for t in _graph_targets(_program(path, key))
            if t.startswith("tpupose_torch.")}


def test_scalespace_program_calls_the_operators(cli_bundle):
    """A bf16 estimator's scale-space program (block 1 fused) calls the
    five kernels of its path as operators (peak_tables in the overflow
    switch's sorted branch)."""
    assert _called_operators(cli_bundle) == {"block1", "pyramid_peak_scores", "sample_avg",
                                             "assoc", "peak_tables"}


def test_fullres_program_calls_peak_scores(params, tmp_path):
    """A ``fullres`` estimator exports a program that holds peak_scores in
    place of pyramid_peak_scores and sample_avg (and peak_tables in the
    overflow switch's sorted branch), and equals it."""
    cfg = PoseConfig(model=ModelConfig(num_stages=1),
                     inference=dataclasses.replace(CFG.inference, paf_readout="fullres"))
    live = PoseEstimator(cfg, params=params, device="cpu")
    path = str(tmp_path / "b.tppx")
    manifest = save_bundle(path, live, [BUCKET], max_batch=1)
    assert manifest["paf_readout"] == "fullres" and manifest["compute_dtype"] == "bfloat16"
    assert _called_operators(path) == {"block1", "peak_scores", "assoc", "peak_tables"}
    imgs = _batch(seed=6, n=1)
    assert _same(load_bundle(path, device="cpu").process_batch(imgs),
                 live.process_batch(imgs)) > 0


def _op_cases():
    """Per operator: (the op, its CPU arguments, the plain version's result
    on them as a tuple)."""
    from tpupose_torch import topology
    from tpupose_torch.decode.scalespace import ScaleSpace
    from tpupose_torch.decode.peaks import TABLE_KEYS, sorted_tables_plain
    from tpupose_torch.ops import assoc, block1, peak_tables, peaks, pyramid_peaks, sample
    from tpupose_torch.testing import adversarial_flats

    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g)

    def space(args):
        return ScaleSpace(args[0], [(44, 52), (88, 96)], (40, 44))

    k, cap = 8, 16
    ts = torch.sort(rnd(2, 19, cap), dim=-1, descending=True).values
    ts[:, :, 12:] = -torch.inf
    chans = [int(c) for c in topology.decode_limb_tables()[1].reshape(-1)]
    maps = [rnd(2, 6, 7, 38), rnd(2, 12, 12, 38)]
    iy = torch.randint(0, 40, (2, 19, 3, 5), generator=g)
    ix = torch.randint(0, 44, (2, 19, 3, 5), generator=g)
    return {
        "block1": (block1._block1_op,
                   (rnd(2, 8, 10, 3), 0.2 * rnd(3, 3, 3, 64), 0.1 * rnd(64),
                    0.05 * rnd(3, 3, 64, 64), 0.1 * rnd(64)),
                   lambda a: (block1.block1_plain(*a),)),
        "pyramid_peak_scores": (
            pyramid_peaks._pyramid_op,
            ([m[..., :19].abs() for m in maps], [44, 52, 88, 96], 40, 44, 18, 3.0, 0.1),
            lambda a: (pyramid_peaks.pyramid_peak_scores_plain(space(a), *a[4:]),)),
        "sample_avg": (
            sample._sample_op, (maps, [44, 52, 88, 96], 40, 44, iy, ix, chans),
            lambda a: (sample.sample_avg_plain(space(a), a[4], a[5],
                                               torch.tensor(a[6]).reshape(-1, 2)),)),
        "assoc": (assoc._assoc_op,
                  (ts, torch.randint(0, k, (2, 19, cap), generator=g).int(),
                   torch.randint(0, k, (2, 19, cap), generator=g).int(),
                   rnd(2, 19, cap).abs(), rnd(2, 19, cap).abs(),
                   torch.randint(0, k + 1, (2, 19), generator=g).int(), k, 6, 10),
                  lambda a: tuple(assoc.assoc_plain(*a)[key] for key in assoc._KEYS)),
        "peak_scores": (peaks._peaks_op, (rnd(2, 20, 24, 19).abs(), 18, 3.0, 0.1),
                        lambda a: (peaks.peak_scores_plain(*a),)),
        "peak_tables": (peak_tables._tables_op, (adversarial_flats(40), 7, 16),
                        lambda a: tuple(sorted_tables_plain(*a)[key] for key in TABLE_KEYS)),
    }


@pytest.mark.parametrize("name", ["block1", "pyramid_peak_scores", "sample_avg", "assoc",
                                  "peak_scores", "peak_tables"])
def test_operator_opcheck_and_cpu_kernel_is_the_plain_version(name):
    """``torch.library.opcheck`` of each registered operator on the CPU
    (schema, fake tensor, autograd registration, AOT dispatch), and the
    operator's CPU result bit-equal to the plain version's."""
    op, args, plain = _op_cases()[name]
    torch.library.opcheck(op, args)
    got, want = op(*args), plain(args)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert str(op._opoverload) == f"tpupose_torch.{name}.default"


@pytest.mark.parametrize("overflows", [True, False])
def test_export_traces_both_table_orders_through_the_operator(overflows):
    """``torch.export`` of a bare ``decode.peaks.peak_tables`` call: the
    overflow switch a cond whose sorted branch is the one node of
    ``tpupose_torch::peak_tables`` (traced through its fake); the program
    equals the eager call bit for bit on a batch that overflows and on one
    that does not."""
    from tpupose_torch.decode import peaks as peaks_mod
    from tpupose_torch.testing import adversarial_flats

    class Tables(torch.nn.Module):
        def forward(self, flat):
            return tuple(peaks_mod.peak_tables(flat, 41, 16).values())

    flat = adversarial_flats(205)
    ep = torch.export.export(Tables(), (flat,), strict=False)
    nodes = [str(n.target) for gm in ep.graph_module.modules()
             if isinstance(gm, torch.fx.GraphModule) for n in gm.graph.nodes]
    assert "cond" in nodes and nodes.count("tpupose_torch.peak_tables.default") == 1
    if not overflows:
        flat[[0, 1, 7, 8, 9]] = -torch.inf
    assert bool(peaks_mod.overflowed(flat, 16)) is overflows
    got, want = ep.module()(flat), peaks_mod.peak_tables(flat, 41, 16)
    for g, key in zip(got, peaks_mod.TABLE_KEYS):
        w = want[key]
        if key == "scores":          # the bits: a -0.0 stays -0.0
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert g.dtype == w.dtype and torch.equal(g, w), key


def test_programs_are_small_beside_the_weights(bundle):
    """The weights are the programs' arguments, stored once: no program
    member is as large as 5 % of weights.npz."""
    with zipfile.ZipFile(bundle) as zf:
        sizes = {i.filename: i.file_size for i in zf.infolist()}
    programs = {n: s for n, s in sizes.items() if n.startswith("programs/")}
    assert len(programs) == 4
    assert max(programs.values()) < 0.05 * sizes["weights.npz"], (programs, sizes["weights.npz"])
