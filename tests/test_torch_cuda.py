"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without a CUDA device. This file
imports no jax, so it also runs where only torch is installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Tolerances: block1 within the bf16 bound of tests/test_pallas_block1.py
(against an f32 truth); pyramid peaks the same peak mask and values
within 1e-5; sample within 1e-5; assoc bit-equal; the decode's integer
tables equal and floats within 1e-4.
"""

import numpy as np
import pytest
import torch

from tpupose.config import InferenceConfig
from tpupose_torch.decode.scalespace import ScaleSpace
from tpupose_torch.ops import block1 as block1_mod
from tpupose_torch.ops import image
from tpupose_torch.ops.assoc import assoc, assoc_plain
from tpupose_torch.ops.block1 import block1, block1_plain
from tpupose_torch.ops.pyramid_peaks import pyramid_peak_scores, pyramid_peak_scores_plain
from tpupose_torch.ops.sample import sample_avg, sample_avg_plain

pytestmark = pytest.mark.cuda
SIZES = image.scale_sizes(368, 368, (0.5, 1.0, 1.5, 2.0), 368, 8)
GEOMS = [s[:2] for s in SIZES]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, scale, seed, device):
    return torch.from_numpy(
        np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)).to(device)


@pytest.mark.parametrize("shape", [(2, 40, 24), (1, 184, 184), (2, 64, 368)])
def test_block1_kernel(cuda, shape):
    n, h, w = shape
    x = _rand((n, h, w, 3), 0.3, 9, cuda)
    wts = (_rand((3, 3, 3, 64), 0.2, 0, cuda), _rand((64,), 0.1, 1, cuda),
           _rand((3, 3, 64, 64), 0.05, 2, cuda), _rand((64,), 0.1, 3, cuda))
    before = block1_mod.KERNEL.launches
    got = block1(x, *wts)
    assert block1_mod.KERNEL.launches == before + 1
    ref = block1_plain(x, *wts)
    truth = block1_plain(x, *wts, dtype=torch.float32)
    assert got.shape == ref.shape == (n, h // 2, w // 2, 64)
    d_ref = (ref.float() - truth).abs().max().item()
    d_got = (got.float() - truth).abs().max().item()
    assert d_got <= 2 * d_ref + 1e-3, (d_got, d_ref)


def _low_maps(rng, c, batch, device):
    out = []
    for _, _, ph, pw in SIZES:
        m = rng.normal(size=(batch, ph // 8, pw // 8, c)).astype(np.float32)
        m = (m + np.roll(m, 1, 1) + np.roll(m, 1, 2)) / 3.0 * 0.6
        out.append(torch.from_numpy(m).to(device))
    return out


def test_pyramid_peaks_kernel(cuda):
    space = ScaleSpace(_low_maps(np.random.default_rng(4), 19, 2, cuda), GEOMS, (368, 368))
    got = pyramid_peak_scores(space, 18, 3.0, 0.1)
    want = pyramid_peak_scores_plain(space, 18, 3.0, 0.1)
    mask = torch.isfinite(want)
    assert mask.sum() > 100
    assert torch.equal(torch.isfinite(got), mask)
    assert (got[mask] - want[mask]).abs().max().item() <= 1e-5


def test_pyramid_peaks_kernel_wide_image(cuda):
    """A 240x960 image: three column tiles, and low-res maps 276 wide."""
    sizes = image.scale_sizes(240, 960, (0.5, 1.0, 1.5), 368, 8)
    rng = np.random.default_rng(6)
    maps = []
    for _, _, ph, pw in sizes:
        m = rng.normal(size=(1, ph // 8, pw // 8, 19)).astype(np.float32)
        maps.append(torch.from_numpy((m + np.roll(m, 1, 1) + np.roll(m, 1, 2)) / 3 * 0.6).to(cuda))
    space = ScaleSpace(maps, [s[:2] for s in sizes], (240, 960))
    got = pyramid_peak_scores(space, 18, 3.0, 0.1)
    want = pyramid_peak_scores_plain(space, 18, 3.0, 0.1)
    mask = torch.isfinite(want)
    assert mask.sum() > 100
    assert torch.equal(torch.isfinite(got), mask)
    assert (got[mask] - want[mask]).abs().max().item() <= 1e-5


def test_sample_kernel(cuda):
    rng = np.random.default_rng(5)
    space = ScaleSpace(_low_maps(rng, 38, 2, cuda), GEOMS, (368, 368))
    iy = torch.from_numpy(rng.integers(0, 368, (2, 19, 12, 12, 10)).astype(np.int32)).to(cuda)
    ix = torch.from_numpy(rng.integers(0, 368, (2, 19, 12, 12, 10)).astype(np.int32)).to(cuda)
    iy[:, :, 0, 0, :4] = torch.tensor([0, 367, 0, 367], dtype=torch.int32)
    ix[:, :, 0, 0, :4] = torch.tensor([0, 0, 367, 367], dtype=torch.int32)
    chans = np.stack([np.arange(0, 38, 2), np.arange(1, 38, 2)], axis=1)
    got = sample_avg(space, iy, ix, chans)
    want = sample_avg_plain(space, iy, ix, torch.as_tensor(chans))
    assert got.shape == (2, 19, 12, 12, 10, 2)
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("seed,k,density", [(0, 16, 0.1), (1, 16, 0.7), (2, 96, 0.01)])
def test_assoc_kernel_bit_equal(cuda, seed, k, density):
    from tpupose_torch.decode.paf import candidates

    rng = np.random.default_rng(seed)
    prior = torch.from_numpy(rng.normal(size=(3, 19, k, k)).astype(np.float32)).to(cuda)
    ok = torch.from_numpy(rng.random((3, 19, k, k)) < density).to(cuda)
    limits = torch.from_numpy(rng.integers(1, k + 1, (3, 19)).astype(np.int32)).to(cuda)
    scores = torch.from_numpy(rng.random((3, 18, k)).astype(np.float32)).to(cuda)
    ts, ta, tb, sa, sb = candidates(prior, ok, scores, min(512, k * k))
    got = assoc(ts, ta, tb, sa, sb, limits, k_slots=k, n_conn=k, max_people=256)
    want = assoc_plain(ts, ta, tb, sa, sb, limits, k_slots=k, n_conn=k, max_people=256)
    assert int(want["active"].sum()) > 0
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_planted_scene_decodes_on_cuda_as_on_cpu(cuda):
    from tpupose_torch.decode.api import decode_impl_batch, to_people
    from tpupose_torch.testing import planted_scene

    heats, pafs = planted_scene(SIZES)
    cfg = InferenceConfig()
    out = {}
    for dev in ("cpu", cuda):
        out[str(dev)] = decode_impl_batch(
            ScaleSpace([h.to(dev) for h in heats], GEOMS, (368, 368)),
            ScaleSpace([p.to(dev) for p in pafs], GEOMS, (368, 368)), cfg)
    cpu, gpu = out["cpu"], out[str(cuda)]
    for key, v in cpu.items():
        g = gpu[key].cpu()
        if v.dtype.is_floating_point:
            assert (g - v).abs().max().item() <= 1e-4, key
        else:
            assert torch.equal(g, v), key
    assert len(to_people({k: v[0].numpy() for k, v in cpu.items()})) == 2
