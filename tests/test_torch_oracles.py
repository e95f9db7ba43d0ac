"""The port's numpy oracles, its profiling harness and its build cache.

  reference_impl.gt_np: every function against the JAX package's gt_np on
      seeded inputs, bit for bit (the code is the same; the tables come
      from the port's own topology and config)
  reference_impl.model_np: forward_np against the JAX package's, bit for
      bit, and against the port's OpenPose on the CPU (2 stages, 64x64,
      seeded weights through the weight bridge): f32 within 1e-5 of the
      output's scale (TF32 off); bf16 with block 1 on its kernel's route
      (the plain version on the CPU) within the bf16 contract of
      tests/test_torch_model.py, rtol 0.1 and atol 0.05, the atol taken
      relative to the output's scale: the seeded network's outputs are
      of order 1e-3, where an absolute 0.05 would hold anything
  benchmark.synthetic_scene: the reference's scene, image and maps bit for bit
  utils.profiling: time_fn's figures, a trace file naming its regions
  utils.compile_cache: builds move into the cache and load from it without
      a compiler run; the key holds the compiler's version; serve
      --compile-cache and TPUPOSE_COMPILE_CACHE (in a fresh process)
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpupose.reference_impl import gt_np as j_gt_np
from tpupose.reference_impl import model_np as j_model_np
from tpupose_torch.config import AugmentConfig, ModelConfig
from tpupose_torch.data import _native
from tpupose_torch.models import OpenPose, weights
from tpupose_torch.reference_impl import gt_np, model_np
from tpupose_torch.testing import limit_threads

limit_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- gt_np ------------------------------------------------------------------------------


def _joints(rng, persons=4, size=368):
    j = np.full((persons, 18, 3), 2.0)
    j[:, :, 0] = rng.uniform(-20, size + 20, (persons, 18))
    j[:, :, 1] = rng.uniform(-20, size + 20, (persons, 18))
    j[:, :, 2] = rng.choice([0.0, 1.0, 2.0], (persons, 18), p=[0.6, 0.2, 0.2])
    j[1] = j[0] + np.asarray([3.0, -2.0, 0.0])          # overlapping persons
    j[2, 3] = j[2, 2]                                   # a zero-length limb
    return j


def _gt_cases():
    rng = np.random.default_rng(5)
    joints = _joints(rng)
    mask = rng.uniform(size=(46, 46))
    small = (ModelConfig(boxsize=64, stride=4), AugmentConfig(sigma=3.0, paf_thre=5.0))
    img3 = rng.integers(0, 256, (75, 101, 3)).astype(np.float32)
    img2 = rng.uniform(0, 1, (60, 50))
    aff = j_gt_np.affine_matrix_np((50.0, 37.0), 0.8, 27.0, True, 64, (3.0, -2.5))
    aff2 = j_gt_np.affine_matrix_np((25.0, 30.0), 1.3, -33.0, False, 48)
    return {
        "put_gaussian_maps_np": [(joints,), (joints[:, :, :] * [0.2, 0.2, 1], *small)],
        "put_vector_maps_np": [(joints,), (joints * [0.2, 0.2, 1], *small)],
        "create_heatmaps_np": [(joints,), (joints, mask), (joints * [0.2, 0.2, 1], None, *small)],
        "affine_matrix_np": [((50.0, 37.0), 0.8, 27.0, True, 64, (3.0, -2.5)),
                             ((184.0, 100.0), 1.4, -40.0, False, 368)],
        "warp_image_np": [(img3, aff, 64, (128.0, 64.0, 0.0)), (img2, aff2, 48, 1.0)],
        "warp_image_twopass_np": [(img3, aff, 64, 128.0), (img2, aff2, 48, 1.0)],
        "transform_joints_np": [(joints, aff, True, 64), (joints, aff2, False, 48)],
    }


@pytest.mark.parametrize("name", sorted(_gt_cases()))
def test_gt_np_equals_the_reference_bit_for_bit(name):
    for args in _gt_cases()[name]:
        got = getattr(gt_np, name)(*args)
        want = getattr(j_gt_np, name)(*args)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want), name
    assert getattr(gt_np, name).__module__ == "tpupose_torch.reference_impl.gt_np"


def test_gt_np_labels_have_content():
    labels = gt_np.create_heatmaps_np(_joints(np.random.default_rng(5)))
    assert labels.shape == (46, 46, 57)
    assert (labels[..., :38] != 0).any() and labels[..., 38:56].max() > 0.9
    np.testing.assert_allclose(labels[..., 56], 1.0 - labels[..., 38:56].max(-1))


# --- model_np ---------------------------------------------------------------------------


def _seeded(num_stages=2):
    model = OpenPose(num_stages=num_stages, dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model


def _image(size=64, seed=3):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, (size, size, 3)).astype(np.float32)


def test_forward_np_equals_the_reference_bit_for_bit():
    tree = weights.to_flax(_seeded().state_dict())
    img = _image()
    got, want = model_np.forward_np(tree, img), j_model_np.forward_np(tree, img)
    assert len(got) == len(want) == 2
    for (gp, gh), (wp, wh) in zip(got, want):
        assert gp.shape == (8, 8, 38) and gh.shape == (8, 8, 19)
        assert np.array_equal(gp, wp) and np.array_equal(gh, wh)
    assert len(model_np.forward_np(weights.to_flax(_seeded(3).state_dict()),
                                   np.zeros((16, 16, 3), np.float32))) == 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_np_against_the_ports_network(dtype):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = _seeded()
    want = model_np.forward_np(weights.to_flax(ref.state_dict()), _image())
    model = OpenPose(num_stages=2, dtype=getattr(torch, dtype), pallas_block1=True)
    model.load_state_dict(ref.state_dict())
    model = model.to(memory_format=torch.channels_last).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(_image())[None])
    for (gp, gh), (wp, wh) in zip(got, want):
        for g, w in ((gp, wp), (gh, wh)):
            g = g[0].float().numpy()
            assert g.shape == w.shape
            scale = float(np.abs(w).max())
            if dtype == "float32":
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * scale)
            else:
                np.testing.assert_allclose(g, w, rtol=0.1, atol=0.05 * scale)


# --- the benchmark's scene ----------------------------------------------------------------


def test_synthetic_scene_is_the_references_bit_for_bit():
    from tpupose import benchmark as jbench
    from tpupose_torch import benchmark as tbench

    for got, want in zip(tbench.synthetic_scene(368), jbench.synthetic_scene()):
        assert got.dtype == want.dtype and np.array_equal(got, want)


# --- profiling ------------------------------------------------------------------------------


def test_time_fn_reports_the_references_figures():
    from tpupose_torch.utils.profiling import time_fn

    calls = []
    got = time_fn(lambda x, k: calls.append(k) or x @ x, torch.ones(32, 32), k=1, warmup=1,
                  iters=5)
    assert set(got) == {"mean_ms", "p50_ms", "min_ms", "max_ms"} and len(calls) == 6
    assert 0 < got["min_ms"] <= got["p50_ms"] <= got["max_ms"]
    assert got["min_ms"] <= got["mean_ms"] <= got["max_ms"]


def test_trace_writes_a_file_naming_the_regions(tmp_path):
    from tpupose_torch.utils.profiling import annotate, trace

    with trace(str(tmp_path)):
        with annotate("oracle_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "oracle_region" for e in events)


# --- the build cache --------------------------------------------------------------------------


RLE = ("rle", "rle.c", ["cc", "-O2", "-shared", "-fPIC"])


def test_compile_cache_takes_the_builds_and_a_second_load_builds_nothing(tmp_path, monkeypatch):
    from tpupose_torch.ops import assoc
    from tpupose_torch.utils.compile_cache import enable_compile_cache

    monkeypatch.setattr(_native, "BUILD_DIR", _native.BUILD_DIR)    # restored after the test
    cache = tmp_path / "cache"
    assert enable_compile_cache(str(cache)) is True and cache.is_dir()
    assert _native.BUILD_DIR == str(cache)
    before = _native.builds
    lib = _native.load(*RLE)
    assert os.path.dirname(lib._name) == str(cache) and _native.builds == before + 1
    again = _native.load(*RLE)
    assert again._name == lib._name and _native.builds == before + 1
    assert os.listdir(cache) == [os.path.basename(lib._name)]
    assert os.path.dirname(assoc.KERNEL._lib_path()) == str(cache)


def test_compile_cache_refuses_a_directory_it_cannot_make(tmp_path, monkeypatch):
    from tpupose_torch.utils.compile_cache import enable_compile_cache

    monkeypatch.setattr(_native, "BUILD_DIR", _native.BUILD_DIR)
    (tmp_path / "file").write_text("")
    with pytest.raises(OSError, match="file"):
        enable_compile_cache(str(tmp_path / "file" / "cache"))
    assert _native.BUILD_DIR == os.path.join(ROOT, "tpupose_torch", "_build")


def test_the_build_key_holds_the_compilers_version(monkeypatch):
    from tpupose_torch.ops import _build, gt

    versions = {"now": "cc (GCC) 12.2.0"}
    monkeypatch.setattr(_native, "compiler_version", lambda compiler: versions["now"])
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    host, kernel = _native.lib_path(*RLE), gt.KERNEL._lib_path()
    assert (_native.lib_path(*RLE), gt.KERNEL._lib_path()) == (host, kernel)
    versions["now"] = "cc (GCC) 13.1.0"
    assert _native.lib_path(*RLE) != host and gt.KERNEL._lib_path() != kernel
    assert os.path.dirname(_native.lib_path(*RLE)) == os.path.dirname(host)


def test_serve_compile_cache_flag_enables_the_cache(tmp_path, monkeypatch):
    from tpupose_torch import serve

    monkeypatch.setattr(_native, "BUILD_DIR", _native.BUILD_DIR)
    cache = tmp_path / "served"
    # --warmup without --buckets exits 2 before any model is built
    assert serve.main(["--compile-cache", str(cache), "--warmup", "--device", "cpu"]) == 2
    assert cache.is_dir() and _native.BUILD_DIR == str(cache)


def test_compile_cache_from_the_environment_at_import(tmp_path):
    code = ("import sys\n"
            "import tpupose_torch\n"
            "from tpupose_torch.data import _native, rle\n"
            "lib = rle._load()\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'tpupose'))\n"
            "print(lib._name, _native.builds, bad)\n")
    env = {**os.environ, "PYTHONPATH": ROOT, "TPUPOSE_COMPILE_CACHE": str(tmp_path / "env")}
    said = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        said.append(out.stdout.split())
    (first, n_first, *bad), (second, n_second, *_) = said
    assert os.path.dirname(first) == str(tmp_path / "env") and first == second
    assert (n_first, n_second) == ("1", "0") and bad == ["[]"]
