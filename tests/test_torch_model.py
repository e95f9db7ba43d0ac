"""Port network (tpupose_torch/models) against tpupose.models.OpenPose.

The flax parameter tree goes through the weight bridge, both forwards
see the same numpy image (boxsize 64, 2 stages, full channel widths):
f32 within 1e-4 relative to the output scale (TF32 off), bf16 within
the block-1 kernel test's bound (atol=0.05, rtol=0.1).
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupose.models import OpenPose as JaxOpenPose
from tpupose_torch.models import OpenPose, weights


@lru_cache(maxsize=1)
def _flax_params():
    """f32 params of a 2-stage flax OpenPose (the compute dtype does not
    change the tree or the init)."""
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    params = JaxOpenPose(num_stages=2).init(jax.random.PRNGKey(0), x)["params"]
    return jax.tree.map(np.asarray, params)


def test_weight_bridge_round_trip_and_module_tree():
    params = _flax_params()
    sd = weights.from_flax(params)
    model = OpenPose(num_stages=2)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    back = weights.to_flax(model.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert b.dtype == np.float32 and b.shape == a.shape
        np.testing.assert_array_equal(b, a)
    w = sd["stage2_L1.conv1.weight"]
    assert tuple(w.shape) == (128, 185, 7, 7)


def test_seeded_init_is_flax_default():
    g = torch.Generator().manual_seed(0)
    model = OpenPose(num_stages=2)
    model.reset_parameters(g)
    w = model.vgg.conv4_1.weight.detach()
    std = float(w.std())
    fan_in = 256 * 9
    assert abs(std - fan_in ** -0.5) < 0.05 * fan_in ** -0.5
    assert float(w.abs().max()) <= 2.0 * fan_in ** -0.5 / 0.87962566103423978 + 1e-6
    assert float(model.stage2_L2.out.bias.detach().abs().max()) == 0.0
    again = OpenPose(num_stages=2)
    again.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.equal(again.vgg.conv1_1.weight, model.vgg.conv1_1.weight)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_flax(dtype):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    jdt = jnp.dtype(dtype)
    params = _flax_params()
    x = np.random.default_rng(3).uniform(-0.5, 0.5, (1, 64, 64, 3)).astype(np.float32)
    want = JaxOpenPose(num_stages=2, dtype=jdt).apply({"params": params}, jnp.asarray(x))
    model = OpenPose(num_stages=2, dtype=getattr(torch, dtype))
    model.load_state_dict(weights.from_flax(params))
    model = model.to(memory_format=torch.channels_last)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert len(got) == len(want) == 2
    for (tp, th), (jp, jh) in zip(got, want):
        for t, j in ((tp, jp), (th, jh)):
            j = np.asarray(j, np.float32)
            t = t.float().numpy()
            assert t.shape == j.shape
            if dtype == "float32":
                scale = float(np.abs(j).max())
                np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4 * scale)
            else:
                np.testing.assert_allclose(t, j, atol=0.05, rtol=0.1)
