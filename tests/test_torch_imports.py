"""The port stands alone: it imports nothing of the JAX package nor of
jax/flax/optax/orbax/grain, ``import tpupose_torch`` (and its data path)
loads neither h5py nor cv2, and its own copies of the reference's
numpy-only modules (config, topology, drawing, config_io, models/caffe,
the data path's coco_eval, coco_prep, hdf5, tpr, pipeline, pack_tpr and
the C sources of its host libraries, parallel/'s pad_batch and
grain_pipeline's Hdf5Source and PadForBatch, deploy's bundle helpers,
utils/flops.py but for its peak, and the numpy oracles gt_np and
model_np) cannot drift from them (the synthetic
dataset's copies are held in tests/test_torch_synthetic.py).
"""

import ast
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

import tpupose.config as jconfig
import tpupose.topology as jtopology
import tpupose.utils.drawing as jdrawing
import tpupose_torch.config as tconfig
import tpupose_torch.topology as ttopology
import tpupose_torch.utils.drawing as tdrawing
from tpupose_torch.ops import block1 as block1_mod
from tpupose_torch.testing import limit_threads

limit_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"tpupose", "jax", "jaxlib", "flax", "optax", "orbax", "grain"}


def port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for folder, _, names in os.walk(os.path.join(ROOT, "tpupose_torch")):
        files += [os.path.join(folder, n) for n in names if n.endswith(".py")]
    return sorted(files)


def imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_of_the_port_imports_the_reference_or_jax():
    files = port_sources()
    assert len(files) > 30 and any(f.endswith("training/loop.py") for f in files)
    assert {"buckets.py", "tracking.py", "decode_np.py", "peaks.py", "serve.py", "cli.py",
            "config_io.py", "caffe.py", "coco_eval.py", "coco_prep.py", "hdf5.py", "tpr.py",
            "rle.py", "pack_tpr.py", "grain_pipeline.py", "deploy.py",
            "make_synthetic_dataset.py", "walkthrough.py", "benchmark.py", "flops.py",
            "gt_np.py", "model_np.py", "profiling.py", "compile_cache.py"} <= \
        {os.path.basename(f) for f in files}
    assert {f"tpupose_torch/parallel/{m}.py" for m in
            ("__init__", "distributed", "sharding", "inference", "pyramid", "spatial")} <= \
        {os.path.relpath(f, ROOT) for f in files}
    bad = {os.path.relpath(f, ROOT): sorted(imported_roots(f) & FORBIDDEN) for f in files}
    assert {f: b for f, b in bad.items() if b} == {}


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import tpupose_torch, tpupose_torch.infer, tpupose_torch.testing\n"
        "import tpupose_torch.training.loop, tpupose_torch.data.pipeline\n"
        "import tpupose_torch.gt, tpupose_torch.ops, tpupose_torch.utils.drawing\n"
        "import tpupose_torch.buckets, tpupose_torch.tracking, tpupose_torch.reference_impl\n"
        "import tpupose_torch.serve, tpupose_torch.cli, tpupose_torch.config_io\n"
        "import tpupose_torch.models.caffe\n"
        "from tpupose_torch.decode import decode_maps, decode_maps_batch, to_people\n"
        "from tpupose_torch.data import coco_eval, coco_prep, hdf5, pack_tpr, rle, tpr\n"
        "from tpupose_torch.data import grain_pipeline\n"
        "import tpupose_torch.parallel\n"
        "from tpupose_torch.parallel import distributed, inference, pyramid, sharding, spatial\n"
        "import tpupose_torch.deploy\n"
        "from tpupose_torch.data import make_synthetic_dataset\n"
        "from tpupose_torch.examples import walkthrough\n"
        "import tpupose_torch.benchmark, tpupose_torch.utils.flops\n"
        "from tpupose_torch.reference_impl import gt_np, model_np\n"
        "from tpupose_torch.utils import compile_cache, profiling\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "print('LOADED', bad)\n"
        "print('OPTIONAL', sorted(m for m in sys.modules if m in ('h5py', 'cv2')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
    assert "OPTIONAL []" in out.stdout, out.stdout


def describe(cls):
    return [(f.name, str(f.type), f.default, f.default_factory is dataclasses.MISSING)
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["ModelConfig", "InferenceConfig", "AugmentConfig",
                                  "TrainConfig"])
def test_config_copy_equals_the_reference_field_for_field(name):
    tcls, jcls = getattr(tconfig, name), getattr(jconfig, name)
    assert describe(tcls) == describe(jcls)
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())


def test_config_bundle_and_helpers_equal_the_reference():
    assert [f.name for f in dataclasses.fields(tconfig.PoseConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.PoseConfig)]
    assert dataclasses.asdict(tconfig.DEFAULT) == dataclasses.asdict(jconfig.DEFAULT)
    assert tconfig.DEFAULT.model.label_size == jconfig.DEFAULT.model.label_size == 46
    assert tconfig.DEFAULT.inference.num_scales == jconfig.DEFAULT.inference.num_scales
    assert dataclasses.asdict(tconfig.TrainConfig().frozen_vgg()) == \
        dataclasses.asdict(jconfig.TrainConfig().frozen_vgg())
    assert dataclasses.asdict(tconfig.single_scale()) == dataclasses.asdict(jconfig.single_scale())
    assert dataclasses.asdict(tconfig.with_scales([1.0, 1.5])) == \
        dataclasses.asdict(jconfig.with_scales([1.0, 1.5]))
    with pytest.raises(dataclasses.FrozenInstanceError):
        tconfig.DEFAULT.model.boxsize = 1


def public_values(module):
    return {k: v for k, v in vars(module).items()
            if not k.startswith("__") and not callable(v) and not isinstance(v, type(os))}


def test_topology_copy_equals_the_reference_table_for_table():
    t, j = public_values(ttopology), public_values(jtopology)
    assert set(t) == set(j) and len(t) > 15
    for name in j:
        assert t[name] == j[name], name
    for a, b in zip(ttopology.decode_limb_tables(), jtopology.decode_limb_tables()):
        assert a.dtype == b.dtype and (a == b).all()
    assert tdrawing._DRAW_LIMBS == jdrawing._DRAW_LIMBS


def test_block1_refuses_a_gradient_on_the_kernel_route():
    x = torch.zeros(1, 4, 4, 3)
    k1 = torch.zeros(3, 3, 3, 64, requires_grad=True)
    rest = (torch.zeros(64), torch.zeros(3, 3, 64, 64), torch.zeros(64))
    with pytest.raises(RuntimeError, match="inference-only"):
        block1_mod.refuse_grad(x, k1, *rest)
    with pytest.raises(RuntimeError, match="inference-only"):
        block1_mod.refuse_grad(x.requires_grad_(), k1.detach(), *rest)
    with torch.no_grad():
        block1_mod.refuse_grad(x, k1, *rest)            # no graph is recorded: allowed
    block1_mod.refuse_grad(x.detach(), k1.detach(), *rest)
    # the CPU route is the two convs, and autograd goes through it
    y = block1_mod.block1(x.detach(), k1, *rest)
    assert y.requires_grad and y.shape == (1, 2, 2, 64)


def test_trainer_model_keeps_block1_on_the_convs():
    from tpupose_torch.infer import PoseEstimator
    from tpupose_torch.models import OpenPose

    assert OpenPose(num_stages=1).vgg.pallas_block1 is False
    est = PoseEstimator(dataclasses.replace(
        tconfig.DEFAULT, model=tconfig.ModelConfig(num_stages=1)), device="cpu")
    assert est.model.vgg.pallas_block1 is True


# --- the copies of config_io and models/caffe, on the same inputs ----------------------
def _config_io_cases():
    from tests import test_config_io as cases

    return {
        "upstream verbatim": cases.UPSTREAM_VERBATIM,
        "reference style": cases.REFERENCE_STYLE_INI,
        "nested subsection": "[models]\n[[1]]\nboxsize = 256\nstride = 4\npadValue = 0\n",
        "min_num": "[param]\nmin_num = 6\n",
        "part_str mismatch": "[models]\n[[1]]\npart_str = [head, tail]\n",
        "part_str match": "[models]\n[[1]]\npart_str = [%s, pt19]\n" % ", ".join(
            jtopology.PARTS),
        "partial": "[param]\nscale_search = 1\n",
        "no section": "key_without_any_section = 1\n",
    }


@pytest.mark.parametrize("case", sorted(_config_io_cases()))
def test_config_io_copy_reads_every_ini_as_the_reference(tmp_path, case):
    import warnings

    import tpupose.config_io as jio
    import tpupose_torch.config_io as tio

    path = tmp_path / "config"
    path.write_text(_config_io_cases()[case])
    results = []
    for mod in (jio, tio):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                res = mod.read_reference_config(str(path))
                loaded = mod.load_reference_config(str(path))
            except Exception as e:      # the same failure in both
                results.append((type(e).__name__, None, None, None, []))
                continue
        results.append((dataclasses.asdict(res.config), res.weights_hint, sorted(res.ignored),
                        dataclasses.asdict(loaded), [w.category.__name__ for w in caught]))
    assert results[0] == results[1]
    with pytest.raises(FileNotFoundError):
        tio.load_reference_config(str(tmp_path / "nope"))


@pytest.mark.parametrize("legacy", [False, True])
def test_caffe_copy_parses_as_the_reference(tmp_path, legacy):
    import numpy as np

    import tpupose.models.caffe as jcaffe
    import tpupose_torch.models.caffe as tcaffe
    from tests.test_torch_weights import _layers, write_caffemodel

    path = str(tmp_path / "w.caffemodel")
    write_caffemodel(path, _layers(1, seed=9), legacy)
    want, got = jcaffe.parse_caffemodel(path), tcaffe.parse_caffemodel(path)
    assert list(got) == list(want)
    for name in want:
        assert [b.shape for b in got[name]] == [b.shape for b in want[name]]
        assert all(np.array_equal(a, b) for a, b in zip(got[name], want[name]))
    want, got = jcaffe.caffemodel_layers(path), tcaffe.caffemodel_layers(path)
    assert {n: sorted(v) for n, v in got.items()} == {n: sorted(v) for n, v in want.items()}
    for name in want:
        for leaf in want[name]:
            assert np.array_equal(got[name][leaf], want[name][leaf])
    blob = np.arange(2 * 3 * 5 * 7, dtype=np.float32).reshape(2, 3, 5, 7)
    assert np.array_equal(tcaffe.blob_to_kernel(blob), jcaffe.blob_to_kernel(blob))
    with pytest.raises(ValueError, match="4-D"):
        tcaffe.blob_to_kernel(blob[0])


# --- the data path's copies -------------------------------------------------------------


class _Normalise(ast.NodeTransformer):
    """Module and function docstrings dropped, ``tpupose_torch`` read as
    ``tpupose``: what stays is the code."""

    def _strip(self, node):
        self.generic_visit(node)
        body = node.body
        if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
        return node

    visit_Module = visit_FunctionDef = visit_ClassDef = _strip

    def visit_ImportFrom(self, node):
        if node.module and node.module.split(".")[0] == "tpupose_torch":
            node.module = "tpupose" + node.module[len("tpupose_torch"):]
        return node

    def visit_Import(self, node):
        for alias in node.names:
            if alias.name.split(".")[0] == "tpupose_torch":
                alias.name = "tpupose" + alias.name[len("tpupose_torch"):]
        return node


def _code(path, names=None):
    """The normalised AST of a file, or of its top-level ``names``."""
    with open(os.path.join(ROOT, path)) as f:
        tree = _Normalise().visit(ast.parse(f.read()))
    if names is None:
        return ast.dump(tree)
    found = {n.name: ast.dump(n) for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and n.name in names}
    assert sorted(found) == sorted(names), path
    return found


@pytest.mark.parametrize("ref, port, names", [
    ("tpupose/data/coco_eval.py", "tpupose_torch/data/coco_eval.py", None),
    ("tpupose/data/coco_prep.py", "tpupose_torch/data/coco_prep.py", None),
    ("tpupose/data/hdf5.py", "tpupose_torch/data/hdf5.py", None),
    ("tpupose/data/tpr.py", "tpupose_torch/data/tpr.py",
     ["_payload_crc", "_check", "TprWriter", "_PyReader", "_meta_from_sample",
      "_sample_from_parts", "write_samples", "read_samples", "num_samples"]),
    ("tpupose/data/pipeline.py", "tpupose_torch/data/pipeline.py",
     ["batch_samples", "_stack", "prefetch", "dataset_batches", "synthetic_batches"]),
    ("tools/pack_tpr.py", "tpupose_torch/data/pack_tpr.py", ["iter_input", "main"]),
])
def test_data_copies_equal_the_reference(ref, port, names):
    """Verbatim copies but for docstrings and comments (and, in tpr.py and
    pipeline.py, the native library's loading and ``shard="auto"``, which
    differ by design and are held to the reference by tests/test_torch_data.py)."""
    assert _code(port, names) == _code(ref, names)


def test_parallel_and_grain_copies_equal_the_reference():
    """The port's copies of ``pad_batch`` (and its pad values),
    ``pad_to_multiple``, ``Hdf5Source`` and ``PadForBatch.map``: the
    reference's code but for docstrings and comments."""
    names = ["pad_to_multiple", "pad_batch"]
    assert _code("tpupose_torch/parallel/sharding.py", names) == \
        _code("tpupose/parallel/sharding.py", names)
    assert _code("tpupose_torch/data/grain_pipeline.py", ["Hdf5Source"]) == \
        _code("tpupose/data/grain_pipeline.py", ["Hdf5Source"])

    def pad_map(path):
        with open(os.path.join(ROOT, path)) as f:
            tree = _Normalise().visit(ast.parse(f.read()))
        cls = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "PadForBatch")
        return [ast.dump(n) for n in cls.body if isinstance(n, ast.FunctionDef)]

    assert pad_map("tpupose_torch/data/grain_pipeline.py") == \
        pad_map("tpupose/data/grain_pipeline.py")
    import tpupose.parallel.sharding as jsharding
    import tpupose_torch.parallel.sharding as tsharding

    assert tsharding._PAD_VALUES == jsharding._PAD_VALUES


@pytest.mark.parametrize("name", ["gt_np", "model_np"])
def test_oracle_copies_equal_the_reference(name):
    """The port's numpy oracles are the reference's code but for
    docstrings and comments (and ``tpupose_torch`` for ``tpupose``)."""
    got = _code(f"tpupose_torch/reference_impl/{name}.py")
    assert got == _code(f"tpupose/reference_impl/{name}.py") and "FunctionDef" in got


def test_tpr_batches_copy_differs_from_the_reference_only_in_docstrings():
    assert _code("tpupose_torch/data/pipeline.py", ["TprBatches"]) == \
        _code("tpupose/data/pipeline.py", ["TprBatches"])


@pytest.mark.parametrize("source", ["rle.c", "feed.cpp"])
def test_native_sources_are_the_reference_code(source):
    import re

    def code(path):
        with open(os.path.join(ROOT, path)) as f:
            text = re.sub(r"/\*.*?\*/", "", f.read(), flags=re.S)
        lines = (re.sub(r"//.*", "", line).rstrip() for line in text.splitlines())
        return [line for line in lines if line]

    got = code(f"tpupose_torch/native/{source}")
    assert len(got) > 40 and got == code(f"native/{source}")


def test_deploy_helpers_equal_the_reference():
    """``_pow2_sizes`` and ``_unflatten_params`` are the reference's code;
    ``_flatten_params`` (numpy where the reference walks a jax pytree) gives
    the same keys in the same order, the same arrays and the same refusals."""
    import numpy as np

    import tpupose.deploy as jdeploy
    import tpupose_torch.deploy as tdeploy

    names = ["_pow2_sizes", "_unflatten_params"]
    assert _code("tpupose_torch/deploy.py", names) == _code("tpupose/deploy.py", names)
    rng = np.random.default_rng(0)
    tree = {"stage2_L1": {"conv1": {"kernel": rng.random((7, 7, 4, 3)), "bias": rng.random(3)}},
            "cpm": {"conv4_3_CPM": {"kernel": rng.random((3, 3, 2, 2)),
                                    "bias": np.zeros(2, np.float32)}},
            "vgg": {"conv1_10": {"bias": rng.random(1)}, "conv1_1": {"bias": rng.random(2)}}}
    got, want = tdeploy._flatten_params(tree), jdeploy._flatten_params(tree)
    assert list(got) == list(want) and len(got) == 6
    assert all(got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]) for k in want)
    assert tdeploy._order(got) == list(want)
    for bad in ({"a/b": {"c": np.zeros(1)}}, {"a": [np.zeros(1)]}):
        with pytest.raises(ValueError) as t_err:
            tdeploy._flatten_params(bad)
        with pytest.raises(ValueError) as j_err:
            jdeploy._flatten_params(bad)
        assert str(t_err.value).split(";")[0] == str(j_err.value).split(";")[0]
    assert tdeploy._pow2_sizes(5) == jdeploy._pow2_sizes(5) == [1, 2, 4, 8]


def test_flops_copy_is_the_reference_code_but_for_the_peak():
    """``utils/flops.py``: the reference's functions, code for code; of its
    constants only the peak differs (the H100 SXM's dense bf16 rate)."""
    import tpupose.utils.flops as jflops
    import tpupose_torch.utils.flops as tflops

    names = ["_conv", "forward_flops", "pyramid_flops"]
    assert _code("tpupose_torch/utils/flops.py", names) == _code("tpupose/utils/flops.py", names)
    t, j = public_values(tflops), public_values(jflops)
    assert set(t) == set(j)
    assert {k for k in j if t[k] != j[k]} == {"PEAK_BF16_FLOPS"}
    assert tflops.PEAK_BF16_FLOPS == 989e12
