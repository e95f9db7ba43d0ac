"""Port estimator (tpupose_torch.infer.PoseEstimator) end to end.

One process_batch of both packages on the same bridged params (boxsize
64, 2 stages, scales (0.5, 1.0), f32 compute): the keypoint JSON has the
same people, parts, coordinates and part counts; the float scores agree
within 1e-4 (the decode tests' tolerance: the two frameworks' f32
convolutions sum in different orders, so the network outputs differ in
the last bits). Plus the estimator's API surface, and the port importing
without jax.
"""

import os
import subprocess
import sys
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupose.config import InferenceConfig, ModelConfig, PoseConfig
from tpupose.infer import PoseEstimator as JaxEstimator
from tpupose.models import OpenPose as JaxOpenPose
from tpupose_torch.infer import PoseEstimator
from tpupose_torch.testing import limit_threads

limit_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = PoseConfig(model=ModelConfig(boxsize=64, num_stages=2, compute_dtype="float32"),
                 inference=InferenceConfig(max_peaks=16, peak_compact_tiers=(8,)))
SCALES = (0.5, 1.0)


@lru_cache(maxsize=1)
def _params():
    """Seeded flax init with the final heads scaled up, so the random
    network emits peaks and limbs (a few people per image)."""
    params = JaxOpenPose(num_stages=2, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"]
    params = jax.tree.map(np.asarray, params)
    for branch in ("stage2_L1", "stage2_L2"):
        params[branch]["out"]["kernel"] = params[branch]["out"]["kernel"] * 3000.0
    return params


def _images():
    return (np.random.default_rng(0).random((2, 64, 80, 3)) * 255).astype(np.uint8)


def _assert_same_people(got, want):
    assert len(got) == len(want)
    for pg, pw in zip(got, want):
        assert len(pg) == len(pw)
        for a, b in zip(pg, pw):
            assert a["num_parts"] == b["num_parts"]
            assert sorted(a["keypoints"]) == sorted(b["keypoints"])
            np.testing.assert_allclose(a["score"], b["score"], rtol=1e-5, atol=1e-4)
            for name, kp in a["keypoints"].items():
                assert (kp["x"], kp["y"]) == (b["keypoints"][name]["x"], b["keypoints"][name]["y"])
                np.testing.assert_allclose(kp["score"], b["keypoints"][name]["score"],
                                           rtol=1e-5, atol=1e-4)


def test_process_batch_matches_reference_estimator():
    params = _params()
    imgs = _images()
    want = JaxEstimator(CFG, params=jax.tree.map(jnp.asarray, params)).process_batch(
        imgs, scales=SCALES)
    est = PoseEstimator(CFG, params=params, device="cpu")
    got = est.process_batch(imgs, scales=SCALES)
    assert sum(len(p) for p in want) >= 4
    _assert_same_people(got, want)

    # the same program through the other entry points
    n, tables = est.process_batch_async(imgs, scales=SCALES)
    assert n == 2 and tables["rows"].shape == (2, CFG.inference.max_people, 18)
    _assert_same_people(PoseEstimator._finish(n, tables), want)
    streamed = list(est.stream([imgs, imgs[::-1]], depth=1, scales=SCALES))
    _assert_same_people(streamed[0], want)
    _assert_same_people(streamed[1], want[::-1])


def test_process_single_image_runs_the_configured_pyramid():
    cfg = PoseConfig(model=CFG.model,
                     inference=InferenceConfig(scale_search=SCALES, max_peaks=16))
    est = PoseEstimator(cfg, params=_params(), device="cpu")
    imgs = _images()
    out = est.process(imgs[1])
    assert out["people"] == est.process_batch(imgs[1:])[0]
    assert len(out["people"]) > 0


def test_seeded_random_init_is_deterministic():
    cfg = PoseConfig(model=ModelConfig(boxsize=64, num_stages=2))
    a = PoseEstimator(cfg, seed=3, device="cpu")
    b = PoseEstimator(cfg, seed=3, device="cpu")
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert not a.pretrained


def test_cuda_estimator_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        PoseEstimator(device="cuda")


def test_port_imports_without_jax():
    """The port and its kernels' modules import with jax and flax
    blocked and JAX_PLATFORMS unset."""
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'jaxlib'):\n"
        "    sys.modules[name] = None\n"
        "import tpupose_torch.infer, tpupose_torch.ops, tpupose_torch.decode.api\n"
        "import tpupose_torch.models.weights\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'flax'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('NO_JAX_OK')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO_JAX_OK" in r.stdout
