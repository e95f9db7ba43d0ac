"""Port image ops (tpupose_torch/ops/image.py) against tpupose.ops.image.

Same numpy inputs through both packages; f32 results within 1e-6, at
the four pyramid geometries of a 368x368 image and of a non-square one.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpupose.config import DEFAULT
from tpupose.ops import image as jimg
from tpupose_torch.ops import image as timg

SCALES = (0.5, 1.0, 1.5, 2.0)


@pytest.mark.parametrize("hw", [(368, 368), (240, 368)])
def test_pyramid_geometry_and_resize_pad(hw):
    h, w = hw
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (2, h, w, 3)).astype(np.uint8)
    sizes = timg.scale_sizes(h, w, SCALES, 368, 8)
    assert sizes == jimg.scale_sizes(h, w, SCALES, 368, 8)
    assert timg.pyramid_sizes(DEFAULT.inference, DEFAULT.model, h, w) == sizes
    assert sizes == jimg.pyramid_sizes(DEFAULT.inference, DEFAULT.model, h, w)
    x0_j = jimg.normalize(jnp.asarray(img))
    x0_t = timg.normalize(torch.from_numpy(img))
    np.testing.assert_array_equal(np.asarray(x0_j), x0_t.numpy())
    for rh, rw, ph, pw in sizes:
        xj = jimg.resize_bilinear(x0_j, rh, rw)
        xt = timg.resize_bilinear(x0_t, rh, rw)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-6)
        pj, padj = jimg.pad_right_down(xj, 8, jimg.PAD_NORM)
        pt, padt = timg.pad_right_down(xt, 8, timg.PAD_NORM)
        assert padt == padj and tuple(pt.shape) == (2, ph, pw, 3)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-6)


def test_rgb_order_unbatched_and_upsample_borders():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        timg.normalize(torch.from_numpy(img), "rgb").numpy(),
        np.asarray(jimg.normalize(jnp.asarray(img), "rgb")))
    with pytest.raises(ValueError):
        timg.normalize(torch.from_numpy(img), "xyz")
    # x8 upsample of a low-res map (the decode's chain) and a downscale,
    # unbatched: the border rows/columns are where the two could differ
    low = rng.normal(size=(23, 29, 5)).astype(np.float32)
    for oh, ow in ((184, 232), (11, 13)):
        want = np.asarray(jimg.resize_bilinear(jnp.asarray(low), oh, ow))
        got = timg.resize_bilinear(torch.from_numpy(low), oh, ow).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
