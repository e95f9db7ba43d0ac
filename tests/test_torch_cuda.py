"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without a CUDA device. This file
imports no jax, so it also runs where only torch is installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Tolerances: block1 within the bf16 bound of tests/test_pallas_block1.py
(against an f32 truth); pyramid peaks the same peak mask and values
within 1e-5 (also at BODY_25's 25 channels, a last group of one); sample
within 1e-5; both on non-finite maps with NaN, +inf and -inf at the plain
version's places and the bits of every non-finite output equal; assoc
bit-equal (COCO-18 and BODY_25); dense_epilogue bit-equal; peaks
bit-equal; peak_tables bit-equal; the
decode's integer tables equal and floats within 1e-4 (scale-space and
full-res); gt the same masks and values within 1e-6; a small train step
within 1e-4 (losses) of the CPU.
"""

import numpy as np
import pytest
import torch

from tpupose_torch.config import InferenceConfig
from tpupose_torch.decode.scalespace import ScaleSpace
from tpupose_torch.ops import block1 as block1_mod
from tpupose_torch.ops import image
from tpupose_torch.ops.assoc import assoc, assoc_plain
from tpupose_torch.ops.block1 import block1, block1_plain
from tpupose_torch.ops.pyramid_peaks import pyramid_peak_scores, pyramid_peak_scores_plain
from tpupose_torch.ops.sample import sample_avg, sample_avg_plain
from tpupose_torch.testing import limit_threads

limit_threads()

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


@pytest.mark.parametrize("from_regs", [False, True])
@pytest.mark.parametrize("shift", [0, 1, 64, 131])
def test_wgmma_tile_at_a_shifted_start_address(cuda, shift, from_regs):
    """One bare wgmma tile against torch.matmul, the pixel operand in the
    activation tile's plane layout and started ``shift`` pixels in: through
    descriptors as conv1_2 takes a tap (weights x 128 pixels), and through
    registers as conv1_1 takes its im2col (64 pixels x weights). bf16
    products are exact in f32 and 16 of them sum within 1e-5 of any order."""
    pixels = _rand((300, 16), 1.0, 11, cuda).to(torch.bfloat16)
    w = _rand((64, 16), 1.0, 12, cuda).to(torch.bfloat16)
    before = block1_mod.KERNEL.launches
    got = block1_mod.wgmma_probe(pixels, w, shift, from_regs)
    torch.cuda.synchronize()
    assert block1_mod.KERNEL.launches == before          # a test entry, not the kernel
    if from_regs:
        want = pixels[shift:shift + 64].float() @ w.float().T
    else:
        want = w.float() @ pixels[shift:shift + 128].float().T
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-5


# the tile is 6 x 62 conv pixels: one row pair, a tile and a ragged second
# one in both directions, every pyramid geometry's last column tile
@pytest.mark.parametrize("shape", [(2, 40, 24), (1, 184, 184), (2, 64, 368), (1, 2, 62),
                                   (1, 126, 130), (8, 736, 736)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block1_kernel_reads_the_models_view_in_place(cuda, dtype):
    """The model hands block1 an NHWC view of NCHW planes: the kernel reads
    it through its strides and gives what it gives for a contiguous copy,
    bit for bit; an in-place update of a weight is seen by the next call."""
    planes = _rand((2, 3, 46, 130), 0.3, 9, cuda).to(dtype)
    view = planes.permute(0, 2, 3, 1)
    assert not view.is_contiguous()
    wts = [_rand((3, 3, 3, 64), 0.2, 0, cuda), _rand((64,), 0.1, 1, cuda),
           _rand((3, 3, 64, 64), 0.05, 2, cuda), _rand((64,), 0.1, 3, cuda)]
    got = block1(view, *wts)
    assert torch.equal(got, block1(view.contiguous(), *wts))
    truth = block1_plain(view, *wts, dtype=torch.float32)
    d_ref = (block1_plain(view, *wts).float() - truth).abs().max().item()
    assert (got.float() - truth).abs().max().item() <= 2 * d_ref + 1e-3
    wts[2].mul_(0.5)
    wts[3].zero_()
    halved = block1(view, *wts)
    truth = block1_plain(view, *wts, dtype=torch.float32)
    d_ref = (block1_plain(view, *wts).float() - truth).abs().max().item()
    assert (halved.float() - truth).abs().max().item() <= 2 * d_ref + 1e-3
    assert not torch.equal(halved, got)


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


# (image size, scales, batch): the 4-scale pyramid at batch 8 (the main
# path), scale 1.0 at batch 16, the 496 x 656 and portrait 656 x 496
# buckets, a 720p frame, a wide non-square image (three column tiles), one
# image
_PYRAMID_CASES = {
    "pyramid, batch 8": ((368, 368), (0.5, 1.0, 1.5, 2.0), 8),
    "scale 1.0, batch 16": ((368, 368), (1.0,), 16),
    "bucket 496x656": ((496, 656), (0.5, 1.0, 1.5, 2.0), 2),
    "portrait bucket 656x496": ((656, 496), (0.5, 1.0, 1.5, 2.0), 2),
    "720p frame": ((720, 1280), (0.5, 1.0, 1.5, 2.0), 1),
    "wide 200x1200": ((200, 1200), (0.5, 1.0, 1.5), 1),
    "pyramid, batch 1": ((368, 368), (0.5, 1.0, 1.5, 2.0), 1),
}


@pytest.mark.parametrize("case", list(_PYRAMID_CASES))
def test_pyramid_peaks_kernel_geometries(cuda, case):
    """The banded kernel against the plain version at the geometries the
    decode runs: one launch, the same peak mask, values within 1e-5. The
    maps are the network's layout, an NHWC view of channels-last planes
    with a 19th channel, read in place; a contiguous copy gives the same
    bits. The kernel's shared memory is what the wrapper's budget says."""
    import ctypes

    from tpupose_torch.decode.scalespace import scale_shapes
    from tpupose_torch.ops import pyramid_peaks as pp

    hw, scales, batch = _PYRAMID_CASES[case]
    sizes = image.scale_sizes(*hw, scales, 368, 8)
    rng = np.random.default_rng(len(case))
    maps = []
    for _, _, ph, pw in sizes:
        m = rng.normal(size=(batch, ph // 8, pw // 8, 19)).astype(np.float32)
        m = (m + np.roll(m, 1, 1) + np.roll(m, 1, 2)) / 3.0 * 0.6
        planes = torch.from_numpy(m).permute(0, 3, 1, 2).to(cuda, memory_format=torch.channels_last)
        maps.append(planes.permute(0, 2, 3, 1))
    space = ScaleSpace(maps, [s[:2] for s in sizes], hw)
    before = pp.KERNEL.launches
    got = pyramid_peak_scores(space, 18, 3.0, 0.1)
    assert pp.KERNEL.launches == before + 1
    want = pyramid_peak_scores_plain(space, 18, 3.0, 0.1)
    mask = torch.isfinite(want)
    assert got.shape == (batch, 18, hw[0] * hw[1]) and mask.sum() > 10 * batch
    assert torch.equal(torch.isfinite(got), mask)
    assert (got[mask] - want[mask]).abs().max().item() <= 1e-5
    dense = ScaleSpace([m.contiguous() for m in maps], space.geoms, hw)
    assert torch.equal(pyramid_peak_scores(dense, 18, 3.0, 0.1), got)
    smem = pp.KERNEL.entry("tp_pyramid_peaks_smem", [ctypes.POINTER(pp._Params)])
    params = pp._params(space, 18, 3.0, 0.1, got)
    assert smem(ctypes.byref(params)) == pp.smem_bytes(scale_shapes(space), hw, 3.0)


def test_pyramid_peaks_kernel_plateau(cuda):
    """Constant maps above the threshold: nearly every pixel is a peak (the
    NMS is >=; which ones depends on the last ulp of the blur, so the mask
    is not held to the plain version's here), more than a block lists for
    its average after the NMS, and the rest are averaged where they are
    found: every finite value is the plain averaged map's, within 1e-5."""
    from tpupose_torch.decode.scalespace import pyramid_heat_maps

    sizes = image.scale_sizes(368, 368, (0.5, 1.0, 1.5, 2.0), 368, 8)
    maps = [torch.full((1, ph // 8, pw // 8, 19), 0.5, device=cuda) for _, _, ph, pw in sizes]
    space = ScaleSpace(maps, [s[:2] for s in sizes], (368, 368))
    got = pyramid_peak_scores(space, 18, 3.0, 0.1)
    avg = pyramid_heat_maps(space.map_scales(lambda m: m[..., :18]), 3.0)[0]
    avg = avg.permute(0, 3, 1, 2).reshape(1, 18, -1)
    found = torch.isfinite(got)
    # the first block's 14 rows of channel 0: more peaks than its list holds
    assert int(found[0, 0].view(368, 368)[:14, :382].sum()) > 1024
    assert (got[found] - avg[found]).abs().max().item() <= 1e-5


def _same_classes(got, want, tol):
    """NaN, +inf and -inf at the same places, the bits of every non-finite
    output equal, the finite ones within ``tol``."""
    for f in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(f(got), f(want))
    fin = torch.isfinite(want)
    assert torch.equal(got[~fin].view(torch.int32), want[~fin].view(torch.int32))
    if fin.any():
        assert (got[fin] - want[fin]).abs().max().item() <= tol


_POISONS = {"nan": [(0, 0, 3, 4, 1, np.nan)], "+inf": [(3, 1, 40, 40, 2, np.inf)],
            "-inf": [(1, 0, 10, 12, 3, -np.inf)],
            "both signs": [(3, 1, 2, 2, 4, np.inf), (3, 1, 80, 2, 4, -np.inf)],
            "two scales": [(0, 0, 1, 1, 5, np.inf), (2, 0, 30, 30, 5, np.inf)]}


@pytest.mark.parametrize("kind", list(_POISONS))
def test_pyramid_peaks_kernel_on_nonfinite_maps(cuda, kind):
    """The contract of decode/scalespace.py: the census kernel, the kernel
    and the pass after it against the dense plain version; the channels the
    poison does not reach as on the clean maps, bit for bit."""
    rng = np.random.default_rng(21)
    maps = [torch.from_numpy(rng.normal(size=(2, ph // 8, pw // 8, 19)).astype(np.float32))
            .to(cuda) for _, _, ph, pw in SIZES]
    clean = pyramid_peak_scores(ScaleSpace(maps, GEOMS, (368, 368)), 18, 3.0, 0.1)
    poisoned = [m.clone() for m in maps]
    for s, b, h, w, c, v in _POISONS[kind]:
        poisoned[s][b, h, w, c] = float(v)
    space = ScaleSpace(poisoned, GEOMS, (368, 368))
    got = pyramid_peak_scores(space, 18, 3.0, 0.1)
    _same_classes(got, pyramid_peak_scores_plain(space, 18, 3.0, 0.1), 1e-5)
    hit = {(b, c) for _, b, _, _, c, _ in _POISONS[kind]}
    for b in range(2):
        for c in range(18):
            if (b, c) not in hit:
                assert torch.equal(got[b, c], clean[b, c])
            else:
                assert not torch.isfinite(got[b, c]).any()


@pytest.mark.parametrize("size", [(368, 368), (496, 656)])
@pytest.mark.parametrize("kind", list(_POISONS))
def test_sample_kernel_on_nonfinite_maps(cuda, kind, size):
    """Both variants (staged at 368x368, direct at the 496x656 bucket)
    against the plain version on poisoned maps, points inside and outside
    the image; the groups the poison does not reach as on the clean maps."""
    from tpupose_torch.ops import sample as sample_mod

    sizes = image.scale_sizes(*size, (0.5, 1.0, 1.5, 2.0), 368, 8)
    rng = np.random.default_rng(22)
    maps = [torch.from_numpy(rng.normal(size=(2, ph // 8, pw // 8, 38)).astype(np.float32))
            .to(cuda) for _, _, ph, pw in sizes]
    space = ScaleSpace(maps, [s[:2] for s in sizes], size)
    poisoned = [m.clone() for m in maps]
    for s, b, h, w, c, v in _POISONS[kind]:
        poisoned[s][b, h % maps[s].shape[1], w % maps[s].shape[2], 2 * c] = float(v)
    space_p = ScaleSpace(poisoned, space.geoms, size)
    shape = (2, 19, 12, 12, 10)
    iy = torch.from_numpy(rng.integers(-2, size[0] + 2, shape).astype(np.int32)).to(cuda)
    ix = torch.from_numpy(rng.integers(-2, size[1] + 2, shape).astype(np.int32)).to(cuda)
    got = sample_avg(space_p, iy, ix, _PAIRS)
    _same_classes(got, sample_avg_plain(space_p, iy, ix, torch.as_tensor(_PAIRS)), 1e-5)
    clean = sample_avg(space, iy, ix, _PAIRS)
    hit = {(b, c) for _, b, _, _, c, _ in _POISONS[kind]}
    for b in range(2):
        for limb in range(19):
            if (b, limb) not in hit:
                assert torch.equal(got[b, limb], clean[b, limb])
    variant = "staged" if sample_mod.staged_bytes(space) <= 227 * 1024 else "direct"
    assert variant == ("staged" if size == (368, 368) else "direct")


def test_census_layouts_match_the_kernels(cuda):
    """ops/pyramid_peaks.census_chunks and ops/sample.census_words and
    census_chunks against the launchers' own counts."""
    import ctypes

    from tpupose_torch.decode.scalespace import scale_shapes
    from tpupose_torch.ops import pyramid_peaks as pp
    from tpupose_torch.ops import sample as sample_mod

    for size in ((368, 368), (496, 656), (720, 1280)):
        sizes = image.scale_sizes(*size, (0.5, 1.0, 1.5, 2.0), 368, 8)
        maps = [torch.zeros((1, ph // 8, pw // 8, 38), device=cuda) for _, _, ph, pw in sizes]
        space = ScaleSpace(maps, [s[:2] for s in sizes], size)
        out = torch.empty((1, 18, size[0] * size[1]), device=cuda)
        params = pp._params(space, 18, 3.0, 0.1, out)
        chunks = pp.KERNEL.entry("tp_pyramid_census_chunks", [ctypes.POINTER(pp._Params)])
        assert chunks(ctypes.byref(params)) == pp.census_chunks(scale_shapes(space))
        iy = torch.zeros((1, 19, 4), dtype=torch.int32, device=cuda)
        p, _, _keep = sample_mod.launch_params(space, iy, iy, _PAIRS.reshape(-1).tolist())
        words = sample_mod.KERNEL.entry("tp_sample_census_words",
                                        [ctypes.POINTER(sample_mod._Params)])
        assert words(ctypes.byref(p)) == p.census_words


_PAIRS = np.stack([np.arange(0, 38, 2), np.arange(1, 38, 2)], axis=1)
# (image size, scales, batch, points per group, channel pairs, variant the
# sizes call for): the pyramid geometry, whose maps and tap table fit a block's
# shared memory (198 KB), and the 496 x 656 bucket, whose do not (279 KB); neighbouring and
# scattered channel pairs (one 8-byte or two 4-byte loads per tap); one
# image; a point count that no number of blocks divides
_SAMPLE_CASES = {
    "pyramid": ((368, 368), (0.5, 1.0, 1.5, 2.0), 2, (12, 12, 10), _PAIRS, "staged"),
    "pyramid, scattered pairs": ((368, 368), (0.5, 1.0, 1.5, 2.0), 2, (12, 12, 10),
                                 (_PAIRS[::-1] * 7 + [[3, 0]]) % 38, "staged"),
    "pyramid, one image, 1009 points": ((368, 368), (0.5, 1.0, 1.5, 2.0), 1, (1009,),
                                        _PAIRS, "staged"),
    "bucket": ((496, 656), (0.5, 1.0, 1.5, 2.0), 2, (12, 12, 10), _PAIRS, "direct"),
    "bucket, scattered pairs, 1009 points": ((496, 656), (0.5, 1.0, 1.5, 2.0), 1, (1009,),
                                             (_PAIRS[::-1] * 7 + [[3, 0]]) % 38, "direct"),
    "bucket, scale 1.0": ((496, 656), (1.0,), 2, (7, 10), _PAIRS, "staged"),
    "wide image, 3 scales": ((240, 960), (0.5, 1.0, 1.5), 1, (7, 10), _PAIRS, "direct"),
}


@pytest.mark.parametrize("case", list(_SAMPLE_CASES))
def test_sample_kernel(cuda, case):
    from tpupose_torch.ops import sample as sample_mod

    (out_h, out_w), scales, batch, per_group, chans, variant = _SAMPLE_CASES[case]
    sizes = image.scale_sizes(out_h, out_w, scales, 368, 8)
    rng = np.random.default_rng(5)
    maps = [torch.from_numpy(rng.normal(size=(batch, ph // 8, pw // 8, 38)).astype(np.float32))
            .to(cuda) for _, _, ph, pw in sizes]
    space = ScaleSpace(maps, [s[:2] for s in sizes], (out_h, out_w))
    shape = (batch, 19, *per_group)
    iy = torch.from_numpy(rng.integers(0, out_h, shape).astype(np.int32)).to(cuda)
    ix = torch.from_numpy(rng.integers(0, out_w, shape).astype(np.int32)).to(cuda)
    corners_y = torch.tensor([0, out_h - 1, 0, out_h - 1], dtype=torch.int32)
    corners_x = torch.tensor([0, 0, out_w - 1, out_w - 1], dtype=torch.int32)
    iy.view(batch, 19, -1)[:, :, :4] = corners_y.to(cuda)
    ix.view(batch, 19, -1)[:, :, :4] = corners_x.to(cuda)
    before = sample_mod.KERNEL.launches
    got = sample_avg(space, iy, ix, chans)
    assert sample_mod.KERNEL.launches == before + 1
    limit = getattr(torch.cuda.get_device_properties(cuda), "shared_memory_per_block_optin",
                    227 * 1024)
    assert ("staged" if sample_mod.staged_bytes(space) <= limit else "direct") == variant
    want = sample_avg_plain(space, iy, ix, torch.as_tensor(chans))
    assert got.shape == (*shape, 2)
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("size", [(368, 368), (496, 656)])
def test_sample_kernel_all_points_equal(cuda, size):
    """The main path's padded peak slots: every point of a group is one
    pixel, so every lane of a warp reads one address (both variants)."""
    out_h, out_w = size
    sizes = image.scale_sizes(out_h, out_w, (0.5, 1.0, 1.5, 2.0), 368, 8)
    rng = np.random.default_rng(8)
    maps = [torch.from_numpy(rng.normal(size=(2, ph // 8, pw // 8, 38)).astype(np.float32))
            .to(cuda) for _, _, ph, pw in sizes]
    space = ScaleSpace(maps, [s[:2] for s in sizes], (out_h, out_w))
    at = torch.from_numpy(rng.integers(0, out_h, (2, 19, 1, 1, 1)).astype(np.int32)).to(cuda)
    iy = at.expand(2, 19, 12, 12, 10).contiguous()
    ix = (at * 3 % out_w).expand(2, 19, 12, 12, 10).contiguous()
    got = sample_avg(space, iy, ix, _PAIRS)
    want = sample_avg_plain(space, iy, ix, torch.as_tensor(_PAIRS))
    assert (got - want).abs().max().item() <= 1e-5
    assert torch.equal(got, got[:, :, :1, :1, :1].expand_as(got))


@pytest.mark.parametrize("size", [(368, 368), (496, 656)])
def test_sample_kernel_points_outside_the_image(cuda, size):
    """Points beyond every edge (by one pixel and by many) read inside the
    maps and agree with the plain version, whose taps clamp (both
    variants)."""
    out_h, out_w = size
    sizes = image.scale_sizes(out_h, out_w, (0.5, 1.0, 1.5, 2.0), 368, 8)
    rng = np.random.default_rng(9)
    maps = [torch.from_numpy(rng.normal(size=(2, ph // 8, pw // 8, 38)).astype(np.float32))
            .to(cuda) for _, _, ph, pw in sizes]
    space = ScaleSpace(maps, [s[:2] for s in sizes], (out_h, out_w))
    shape = (2, 19, 64, 10)
    iy = torch.from_numpy(rng.integers(-3, out_h + 3, shape).astype(np.int32)).to(cuda)
    ix = torch.from_numpy(rng.integers(-3, out_w + 3, shape).astype(np.int32)).to(cuda)
    far = torch.tensor([-1, out_h, -100000, 100000, 2 ** 31 - 1, -2 ** 31], dtype=torch.int32)
    iy[:, :, 0, :6] = far.to(cuda)
    ix[:, :, 1, :6] = (far + torch.tensor([0, out_w - out_h, 0, 0, 0, 0], dtype=torch.int32)).to(cuda)
    got = sample_avg(space, iy, ix, _PAIRS)
    want = sample_avg_plain(space, iy.clamp(-4, out_h + 3), ix.clamp(-4, out_w + 3),
                            torch.as_tensor(_PAIRS))
    assert (got - want).abs().max().item() <= 1e-5


def _crowded_tables(cuda, n_scenes):
    """assoc's inputs on crowded 720x1280 frames (32 people each, four
    scales), as the scale-space decode builds them on the card."""
    from tpupose_torch.decode import paf as paf_mod
    from tpupose_torch.decode import peaks as peaks_mod
    from tpupose_torch.testing import crowded_scene

    cfg = InferenceConfig()
    hw = (720, 1280)
    sizes = image.scale_sizes(*hw, (0.5, 1.0, 1.5, 2.0), 368, 8)
    geoms = [s[:2] for s in sizes]
    scenes = [crowded_scene(sizes, 32, seed) for seed in range(n_scenes)]
    heat = ScaleSpace([torch.cat([sc[0][i] for sc in scenes]).to(cuda) for i in range(4)], geoms, hw)
    pafs = ScaleSpace([torch.cat([sc[1][i] for sc in scenes]).to(cuda) for i in range(4)], geoms, hw)
    k = cfg.max_peaks
    flats = pyramid_peak_scores(heat, 18, cfg.peak_sigma, cfg.thre1)
    pk = {key: v.reshape(n_scenes, 18, k)
          for key, v in peaks_mod.peak_tables(flats.reshape(n_scenes * 18, -1), hw[1], k).items()}
    prior, ok, n_a, n_b = paf_mod.pair_scores(pafs, pk, cfg.mid_num, cfg.thre2,
                                              cfg.connect_min_ratio)
    return paf_mod.candidates(prior, ok, pk["scores"], min(512, k * k)), torch.minimum(n_a, n_b)


@pytest.mark.parametrize("seed,k,density", [(0, 16, 0.1), (1, 16, 0.7), (2, 96, 0.01),
                                            (3, 96, "crowd")])
def test_assoc_kernel_bit_equal(cuda, seed, k, density):
    """csrc/assoc.cu against assoc_plain, bit for bit: random tables and the
    tables of three crowded 720p frames (32 people each); also its
    scan-on-every-step path (the test entry tp_assoc_scan)."""
    from tpupose_torch.decode.paf import candidates

    rng = np.random.default_rng(seed)
    if density == "crowd":
        (ts, ta, tb, sa, sb), limits = _crowded_tables(cuda, 3)
    else:
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
    # the kernel's other way to a step's matched rows: a scan on every step
    from tpupose_torch import topology
    from tpupose_torch.ops import assoc as assoc_mod

    scan = assoc_mod.KERNEL.entry("tp_assoc_scan", assoc_mod.KERNEL.argtypes)
    out = {key: torch.empty_like(v) for key, v in want.items()}
    ins = [t.contiguous() for t in (ts, ta, tb, sa, sb, limits.to(torch.int32))]
    pairs = torch.as_tensor(topology.decode_limb_tables()[0], dtype=torch.int32).to(cuda)
    assert scan(*(t.data_ptr() for t in ins), pairs.data_ptr(), 18, (1 << 17) - 1, ts.shape[0],
                19, ts.shape[2], k, k, 256,
                *(out[key].data_ptr() for key in ("rows", "score", "cnt", "active", "stamp")),
                torch.cuda.current_stream().cuda_stream) == 0
    for key in want:
        assert torch.equal(out[key], want[key]), key


@pytest.mark.parametrize("seed,k,density", [(0, 16, 0.1), (1, 16, 0.7), (2, 96, 0.02),
                                            (3, 96, 0.3)])
def test_assoc_kernel_bit_equal_at_25_parts(cuda, seed, k, density):
    """assoc<25> over BODY_25's 26 limbs (its seeding mask leaves out limbs
    18 and 19) against assoc_plain, bit for bit, and its scan-on-every-step
    path."""
    from tpupose_torch.decode.paf import candidates
    from tpupose_torch.ops import assoc as assoc_mod
    from tpupose_torch.skeletons import BODY25

    rng = np.random.default_rng(seed)
    prior = torch.from_numpy(rng.normal(size=(3, 26, k, k)).astype(np.float32)).to(cuda)
    ok = torch.from_numpy(rng.random((3, 26, k, k)) < density).to(cuda)
    limits = torch.from_numpy(rng.integers(1, k + 1, (3, 26)).astype(np.int32)).to(cuda)
    scores = torch.from_numpy(rng.random((3, 25, k)).astype(np.float32)).to(cuda)
    ts, ta, tb, sa, sb = candidates(prior, ok, scores, min(512, k * k), BODY25)
    kw = dict(k_slots=k, n_conn=k, max_people=256, skeleton=BODY25)
    got = assoc(ts, ta, tb, sa, sb, limits, **kw)
    want = assoc_plain(ts, ta, tb, sa, sb, limits, **kw)
    assert int(want["active"].sum()) > 0 and got["rows"].shape == (3, 256, 25)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    scan = assoc_mod.KERNEL.entry("tp_assoc_scan", assoc_mod.KERNEL.argtypes)
    out = {key: torch.empty_like(v) for key, v in want.items()}
    ins = [t.contiguous() for t in (ts, ta, tb, sa, sb, limits)]
    pairs = torch.as_tensor(BODY25.limb_tables()[0], dtype=torch.int32).to(cuda)
    assert scan(*(t.data_ptr() for t in ins), pairs.data_ptr(), 25, BODY25.seed_mask, 3, 26,
                ts.shape[2], k, k, 256,
                *(out[key].data_ptr() for key in ("rows", "score", "cnt", "active", "stamp")),
                torch.cuda.current_stream().cuda_stream) == 0
    for key in want:
        assert torch.equal(out[key], want[key]), key


@pytest.mark.parametrize("kind", ["clean", "nan", "+inf"])
def test_pyramid_peaks_kernel_at_25_channels(cuda, kind):
    """BODY_25's 25 part channels (groups of 3: the last holds one) of a
    26-channel map against the plain version, clean and poisoned in the
    last group's channel."""
    rng = np.random.default_rng(25)
    maps = _low_maps(rng, 26, 2, cuda)
    if kind != "clean":
        maps[1][1, 5, 7, 24] = float("nan") if kind == "nan" else float("inf")
    space = ScaleSpace(maps, GEOMS, (368, 368))
    got = pyramid_peak_scores(space, 25, 3.0, 0.1)
    want = pyramid_peak_scores_plain(space, 25, 3.0, 0.1)
    assert got.shape == (2, 25, 368 * 368)
    if kind == "clean":
        assert torch.isfinite(want[:, 24]).sum() > 10
    _same_classes(got, want, 1e-5)


# (w, buffer width, offset) of every epilogue of the BODY_25 network
_EPILOGUES = [(96, 288, 0), (96, 288, 96), (96, 288, 192), (128, 384, 0), (128, 384, 128),
              (128, 384, 256), (256, 256, 0), (512, 512, 0), (128, 128, 0)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("w,width,off", _EPILOGUES)
def test_dense_epilogue_kernel_bit_equal(cuda, w, width, off, dtype):
    """csrc/dense_epilogue.cu against its plain version, bit for bit, at
    every (w, buffer width, offset) of the network, over 2 x 23 x 41
    pixels (not a multiple of 8): the slice written, the rest of the
    buffer untouched, and with ``keep`` the input overwritten."""
    from tpupose_torch.ops import dense_epilogue as epi

    g = torch.Generator(device=cuda).manual_seed(w * 7 + off)
    y = torch.randn((2, 23, 41, w), generator=g, device=cuda).to(dtype)
    bias = torch.randn((w,), generator=g, device=cuda)
    slope = torch.rand((w,), generator=g, device=cuda)
    want = epi.dense_epilogue_plain(y, bias, slope)
    for keep in (False, True):
        out = torch.full((2, 23, 41, width), float("nan"), device=cuda).to(dtype)
        mine = y.clone()
        before = epi.KERNEL.launches
        epi.dense_epilogue(mine, bias, slope, out, off, keep)
        torch.cuda.synchronize()
        assert epi.KERNEL.launches == before + 1
        assert torch.equal(out[..., off:off + w], want)
        assert torch.isnan(torch.cat([out[..., :off], out[..., off + w:]], -1).float()).all()
        assert torch.equal(mine, want if keep else y)


def test_body25_network_on_the_card_against_the_reference(cuda):
    """OpenPoseBody25 (block1 and dense_epilogue kernels, cuDNN) against
    reference_impl/body25_ref.py on the card, f32 and bf16, 2 x 184 x 248:
    f32 within 1e-4 of the output's scale (cuDNN's f32 convs sum in their
    own order), bf16 within 0.05 of it (block1's kernel and cuDNN round
    other bf16 values than the reference's convs)."""
    from tpupose_torch.models.body25 import OpenPoseBody25
    from tpupose_torch.reference_impl import body25_ref

    model = OpenPoseBody25(dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(7))
    sd = {k: v.detach().to(cuda) for k, v in model.state_dict().items()}
    x = (torch.rand((2, 184, 248, 3), generator=torch.Generator().manual_seed(8)) - 0.5).to(cuda)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 0.05)):
        net = OpenPoseBody25(dtype=dtype, pallas_block1=True)
        net.load_state_dict(sd)
        net = net.to(cuda, memory_format=torch.channels_last).eval()
        with torch.no_grad():
            (paf, heat), = net(x)
            want_paf, want_heat = body25_ref.Net(sd, str(dtype).split(".")[1])(x)
        for got, want in ((paf, want_paf), (heat, want_heat)):
            scale = want.abs().max().item()
            assert (got - want).abs().max().item() <= tol * scale


# --- BODY_25's stage loop as one CUDA graph a shape (models/stage_graph.py) ---------------


def _body25(cuda, seed: int):
    from tpupose_torch.config import DEFAULT
    from tpupose_torch.infer import PoseEstimator

    return PoseEstimator(DEFAULT, seed=seed, device=cuda, arch="body25")


def _frames(seed: int, h: int = 720, w: int = 1280) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (8, h, w, 3)).astype(np.uint8)


def _call(est, frames, params=None):
    """``program``'s steps over one batch at 4 scales, with ``params`` or the
    model's own weights: ({the people tables, the masked peak scores, each
    scale's last PAF maps}, the counters the call added)."""
    from tpupose_torch.utils import profiling

    profiling.reset_counters()
    with torch.inference_mode():
        x, _ = est._upload(frames, None)
        flats, width, paf_in = est._device_scores(params, x, None, None)
        out = {**est._tables((flats, width, paf_in)), "flats": flats,
               **{f"paf{i}": m for i, m in enumerate(paf_in.maps)}}
    torch.cuda.synchronize()
    return out, profiling.counters()


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_body25_stage_graphs_replay_bit_equal_with_exact_counts(cuda):
    """Batch 8, 720 x 1280 frames, 4 scales: the first call runs the stage
    loop op by op, the second captures and replays it, the third replays
    it; their maps and tables are bit-equal, and each call counts the same launches
    (99 epilogues a scale, the decode's kernels once) and its own 4
    ``net.stages.eager`` or ``net.stages.graph``. A second geometry (480 x
    640) captures graphs of its own; the first still replays bit-equal."""
    est = _body25(cuda, 0)
    hd, vga = _frames(1), _frames(2, 480, 640)
    calls = [_call(est, hd) for _ in range(3)]
    for i, (tables, counts) in enumerate(calls):
        assert _same(tables, calls[0][0]), i
        stages = {"net.stages.eager": 4 * (i == 0), "net.stages.graph": 4 * (i > 0)}
        assert {k: counts.get(k, 0) for k in stages} == stages, (i, counts)
        want = {"launch.block1": 4, "launch.pyramid_peaks": 1, "launch.sample": 1,
                "launch.assoc": 1, "launch.gt": 0, "launch.peaks": 0,
                "launch.peak_tables": counts.get("decode.tables.sorted", 0),
                "launch.dense_epilogue": 396, "net.dense_epilogue": 396}
        assert {k: counts.get(k, 0) for k in want} == want, (i, counts)
        assert {k: v for k, v in counts.items() if k not in stages} == {
            k: v for k, v in calls[0][1].items() if k not in stages}, i
    second = [_call(est, vga) for _ in range(2)]
    assert _same(second[0][0], second[1][0])
    assert [c.get("net.stages.graph", 0) for _, c in second] == [0, 4]
    again, counts = _call(est, hd)
    assert _same(again, calls[0][0]) and counts.get("net.stages.graph", 0) == 4
    assert len(est.model.stage_graphs._keys) == 8


def test_body25_program_with_other_params_runs_them_op_by_op(cuda):
    """``program(params=)`` with another estimator's tensors, after the
    model's own graphs are captured: the op-by-op result of those tensors
    (bit-equal to the other estimator's first, op-by-op call), not a
    replay of the model's own weights."""
    est, other = _body25(cuda, 0), _body25(cuda, 3)
    frames = _frames(4)
    own = [_call(est, frames) for _ in range(2)][-1][0]
    got, counts = _call(est, frames, other.model.state_dict())
    assert counts.get("net.stages.eager", 0) == 4 and counts.get("net.stages.graph", 0) == 0
    want, _ = _call(other, frames)
    assert _same(got, want) and not _same(got, own)


def test_body25_stage_graphs_read_weights_updated_in_place(cuda):
    """``load_state_dict`` into a model whose graphs are captured keeps the
    storages: the next call replays and its tables are those of the new
    weights (bit-equal to an estimator built with them, op by op)."""
    est, other = _body25(cuda, 0), _body25(cuda, 5)
    frames = _frames(6)
    old = [_call(est, frames) for _ in range(2)][-1][0]
    est.model.load_state_dict(other.model.state_dict())
    got, counts = _call(est, frames)
    assert counts.get("net.stages.graph", 0) == 4 and counts.get("net.stages.eager", 0) == 0
    want, _ = _call(other, frames)
    assert _same(got, want) and not _same(got, old)


def test_body25_replayed_epilogues_are_in_the_device_trace(cuda):
    """A replayed batch under ``posebench.trace.profiled``: the trace lists
    the ``dense_epilogue`` kernels by name, 99 a scale (the 96 replayed and
    the front's 3), which ``dense_epilogue_roofline`` reads."""
    from posebench.trace import WINDOW, profiled

    est = _body25(cuda, 0)
    frames = _frames(7)
    for _ in range(2):
        _call(est, frames)

    def traced(span):
        with span(WINDOW):
            _call(est, frames)
        return {}

    trace = profiled(traced, ())
    assert trace.launches("dense_epilogue") == 396 and trace.seconds("dense_epilogue") > 0


@pytest.mark.parametrize("value", [float("nan"), float("inf"), -float("inf")])
def test_assoc_kernel_on_nonfinite_priors(cuda, value):
    """Candidate tables whose priors hold NaN or +-inf on live pairs: the
    kernel bit-equal to assoc_plain (a non-finite prior is never accepted)."""
    from tpupose_torch.decode.paf import candidates

    rng = np.random.default_rng(31)
    k = 16
    prior = torch.from_numpy(rng.normal(size=(3, 19, k, k)).astype(np.float32)).to(cuda)
    ok = torch.from_numpy(rng.random((3, 19, k, k)) < 0.3).to(cuda)
    spots = torch.from_numpy(rng.random((3, 19, k, k)) < 0.05).to(cuda)
    prior[spots] = value
    limits = torch.from_numpy(rng.integers(1, k + 1, (3, 19)).astype(np.int32)).to(cuda)
    scores = torch.from_numpy(rng.random((3, 18, k)).astype(np.float32)).to(cuda)
    tables = candidates(prior, ok | spots, scores, min(512, k * k))
    got = assoc(*tables, limits, k_slots=k, n_conn=k, max_people=256)
    want = assoc_plain(*tables, limits, k_slots=k, n_conn=k, max_people=256)
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


@pytest.mark.parametrize("shape", [(2, 64, 80, 19), (1, 7, 30, 18), (3, 33, 129, 21)])
def test_peaks_kernel_bit_equal(cuda, shape):
    """csrc/peaks.cu against peak_scores_plain, on the card and on the CPU:
    both follow one arithmetic (tap order, separately rounded multiply and
    add), so the blurred field and every >= of the NMS agree bit for bit.
    Tiles cut by the map's edge, a map narrower than the blur radius, and
    channels beyond the 18 scored ones."""
    from tpupose_torch.decode.peaks import gaussian_blur
    from tpupose_torch.ops import peaks as peaks_mod

    noise = torch.from_numpy(
        np.random.default_rng(shape[1]).normal(size=shape).astype(np.float32))
    field = (gaussian_blur(noise, 4.0) * 3.0).to(cuda)
    before = peaks_mod.KERNEL.launches
    got = peaks_mod.peak_scores(field, 18, 3.0, 0.1)
    assert peaks_mod.KERNEL.launches == before + 1
    torch.cuda.synchronize()
    want = peaks_mod.peak_scores_plain(field, 18, 3.0, 0.1)
    assert got.shape == (shape[0], 18, shape[1] * shape[2]) and got.dtype == torch.float32
    assert int(torch.isfinite(want).sum()) >= 8
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), peaks_mod.peak_scores_plain(field.cpu(), 18, 3.0, 0.1))
    with pytest.raises(ValueError, match="shared memory"):
        peaks_mod.peak_scores(field, 18, sigma=13.0)      # radius 52: rings beyond a block
    # radius 0, 4, 8, 16 (templated), 18, 24 and 50 (the generic path)
    for sigma in (0.1, 1.0, 2.0, 4.0, 4.5, 6.0, 12.4):
        assert torch.equal(peaks_mod.peak_scores(field, 18, sigma, 0.1),
                           peaks_mod.peak_scores_plain(field, 18, sigma, 0.1)), sigma


# edges of the kernel's blocks: 62 output columns per strip, at most 46 rows
# per band; maps of one row or column, and narrower than the blur radius
@pytest.mark.parametrize("shape", [(1, 1, 1, 18), (2, 1, 63, 19), (1, 47, 1, 18),
                                   (1, 45, 61, 18), (2, 46, 62, 18), (1, 47, 63, 18),
                                   (1, 93, 125, 20), (3, 5, 9, 18)])
def test_peaks_kernel_block_edges(cuda, shape):
    """csrc/peaks.cu bit-equal to peak_scores_plain (card and CPU) where
    the map ends inside, at and just past a strip or a band, and where the
    blur folds several times. The kernel's shared memory at each radius is
    what the wrapper's budget says."""
    import ctypes

    from tpupose_torch.decode.peaks import gaussian_blur
    from tpupose_torch.ops import peaks as peaks_mod

    noise = torch.from_numpy(
        np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32))
    field = (gaussian_blur(noise, 1.5) * 3.0).to(cuda)
    before = peaks_mod.KERNEL.launches
    got = peaks_mod.peak_scores(field, 18, 3.0, 0.1)
    assert peaks_mod.KERNEL.launches == before + 1
    want = peaks_mod.peak_scores_plain(field, 18, 3.0, 0.1)
    assert got.shape == (shape[0], 18, shape[1] * shape[2])
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), peaks_mod.peak_scores_plain(field.cpu(), 18, 3.0, 0.1))
    for sigma in (4.5, 6.0):                                # the generic path, radius 18, 24
        assert torch.equal(peaks_mod.peak_scores(field, 18, sigma, 0.1),
                           peaks_mod.peak_scores_plain(field, 18, sigma, 0.1)), sigma
    smem = peaks_mod.KERNEL.entry("tp_peaks_smem", [ctypes.c_int])
    assert [smem(r) for r in range(51)] == [peaks_mod.smem_bytes(r) for r in range(51)]


def test_fullres_decode_on_cuda_as_on_cpu(cuda):
    """The planted scene materialised at 368x368, through decode_maps:
    2 people, the card's tables equal to the CPU's."""
    from tpupose_torch.decode import decode_maps, to_people
    from tpupose_torch.ops import peaks as peaks_mod
    from tpupose_torch.testing import planted_scene

    heats, pafs = planted_scene(SIZES)

    heat = image.average_upsampled(heats, SIZES, 368, 368, 8)[0]
    paf = image.average_upsampled(pafs, SIZES, 368, 368, 8)[0]
    cfg = InferenceConfig()
    cpu = decode_maps(heat, paf, cfg)
    before = peaks_mod.KERNEL.launches
    gpu = decode_maps(heat.to(cuda), paf.to(cuda), cfg)
    assert peaks_mod.KERNEL.launches == before + 1
    for key, v in cpu.items():
        g = gpu[key].cpu()
        if v.dtype.is_floating_point:
            assert (g - v).abs().max().item() <= 1e-4, key
        else:
            assert torch.equal(g, v), key
    assert len(to_people({k: v.numpy() for k, v in cpu.items()})) == 2


# the sorted peak tables: (rows, n, w, k, chunks, flats); chunks None is the
# wrapper's own count, a number forces the first stage's split
_TABLE_CASES = {
    "hd": (144, 720 * 1280, 1280, 96, [None], "crowded"),
    "vga": (144, 480 * 640, 640, 96, [None], "crowded"),
    "tiny_k8": (36, 64, 8, 8, [None, 3], "crowded"),
    "tiny_k16": (36, 64, 8, 16, [None, 3], "crowded"),
    "n_below_k": (36, 50, 10, 96, [None, 4], "crowded"),
    "ragged": (5, 100_003, 331, 256, [None, 7, 64], "crowded"),
    "adversarial_k1": (10, 5003, 41, 1, [None, 3], "adversarial"),
    "adversarial_k96": (10, 5003, 41, 96, [None, 3, 40], "adversarial"),
    "adversarial_k256": (10, 5003, 41, 256, [None, 7, 40], "adversarial"),
}


def _flats(rows, n, kind, cuda):
    from tpupose_torch.testing import adversarial_flats, crowded_flats

    if kind == "adversarial":
        return adversarial_flats(n).to(cuda)
    flat = crowded_flats(rows, n, seed=rows + n, device=cuda)
    if n >= 300_000:          # the crowd's scale: rows beyond the capacity
        assert int((torch.isfinite(flat).sum(-1) > 96).sum()) >= rows // 4
    return flat


@pytest.mark.parametrize("case", list(_TABLE_CASES))
def test_peak_tables_kernel_bit_equal(cuda, case):
    """csrc/peak_tables.cu against sorted_tables_plain (its torch.sort on
    the card), bit for bit in all four outputs, the first stage split as
    the wrapper splits it and as forced: every xs, ys and valid equal and
    every score's bits (a -0.0 stays -0.0, NaN and inf give 0). Each call
    launches the kernel once; the guarded peak_tables of an overflowing
    batch goes through it once too."""
    from tpupose_torch.decode import peaks as peaks_mod
    from tpupose_torch.ops import peak_tables as pt_mod

    rows, n, w, k, splits, kind = _TABLE_CASES[case]
    flat = _flats(rows, n, kind, cuda)
    want = peaks_mod.sorted_tables_plain(flat, w, k)
    for chunks in splits:
        before = pt_mod.KERNEL.launches
        got = dict(zip(peaks_mod.TABLE_KEYS, pt_mod.launch(flat, w, k, chunks)))
        torch.cuda.synchronize()
        assert pt_mod.KERNEL.launches == before + 1
        for key in ("xs", "ys", "valid"):
            assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), \
                (key, chunks)
        assert got["scores"].dtype == torch.float32
        assert torch.equal(got["scores"].view(torch.int32), want["scores"].view(torch.int32)), \
            chunks
    if bool(peaks_mod.overflowed(flat, k)):
        before = pt_mod.KERNEL.launches
        got = peaks_mod.peak_tables(flat, w, k)
        assert pt_mod.KERNEL.launches == before + 1
        assert all(torch.equal(got[key], want[key]) for key in ("xs", "ys", "valid"))


def test_peak_tables_kernel_refuses_what_it_cannot_hold(cuda):
    """Over MAX_K slots or another dtype than float32 the kernel raises, and
    nothing launches."""
    from tpupose_torch.ops import peak_tables as pt_mod

    flat = torch.zeros((2, 1000), device=cuda)
    before = pt_mod.KERNEL.launches
    with pytest.raises(ValueError, match="at most 256"):
        pt_mod.peak_tables(flat, 10, pt_mod.MAX_K + 1)
    with pytest.raises(ValueError, match="float32"):
        pt_mod.peak_tables(flat.double(), 10, 96)
    assert pt_mod.KERNEL.launches == before


@pytest.mark.parametrize("shape", [(10, 24, 46, 8, 12), (3, 5, 16, 4, 2), (10, 24, 46, 8, 24),
                                   (2, 3, 200, 8, 3)])
def test_gt_kernel(cuda, shape):
    """csrc/gt.cu against create_labels_plain: the same heat > 0 and band
    masks, values within 1e-6 (expf against torch.exp). Half the persons
    live, or all 24 with joints on and beyond the image's border; a grid of
    200 cells (one label row a block). The kernel's shared memory is what
    the wrapper's budget says."""
    import ctypes

    from tpupose_torch.ops import gt as gt_mod

    n, persons, label, stride, live = shape
    rng = np.random.default_rng(n + live)
    j = np.full((n, persons, 18, 3), 2.0, np.float32)
    j[:, :live, :, :2] = rng.uniform(0, label * stride, (n, live, 18, 2))
    j[:, :live, :, 2] = rng.choice([0.0, 1.0, 2.0], (n, live, 18), p=[0.6, 0.2, 0.2])
    if live == persons:          # joints on the border, just inside and beyond it
        edge = rng.choice([-20.0, -0.5, 0.0, label * stride - 1.0, label * stride + 20.0],
                          (n, live, 18))
        on_x = rng.random((n, live, 18)) < 0.3
        j[:, :, :, 0] = np.where(on_x, edge, j[:, :, :, 0])
        j[:, :, :, 1] = np.where(~on_x & (rng.random((n, live, 18)) < 0.3), edge, j[:, :, :, 1])
    j[0, 1] = j[0, 0] + np.asarray([3.0, -2.0, 0.0], np.float32)
    j[-1, :, :, 2] = 2.0
    joints = torch.from_numpy(j).to(cuda)
    mask = torch.from_numpy(rng.uniform(size=(n, label, label)).astype(np.float32)).to(cuda)
    kw = dict(label_size=label, stride=stride, sigma=7.0 * stride / 8, paf_thre=float(stride))
    before = gt_mod.KERNEL.launches
    got = gt_mod.create_labels(joints, mask, **kw)
    assert gt_mod.KERNEL.launches == before + 1
    want = gt_mod.create_labels_plain(joints, mask, **kw)
    on_cpu = gt_mod.create_labels_plain(joints.cpu(), mask.cpu(), **kw)
    for g, w, c in zip(got, want, on_cpu):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert torch.equal(g != 0, w != 0)
        assert (g - w).abs().max().item() <= 1e-6
        assert (g.cpu() - c).abs().max().item() <= 1e-5
    assert (want[0] != 0).any() and (want[1][..., :18] > 0).any()
    assert not got[0][-1].any() and torch.equal(got[1][-1][..., 18], mask[-1])
    zero = gt_mod.create_labels(joints, torch.zeros_like(mask), **kw)
    assert not zero[0].any() and not zero[1].any()
    smem = gt_mod.KERNEL.entry("tp_gt_smem", [ctypes.c_int] * 3)
    assert smem(persons, label, gt_mod.tile_rows(label)) == gt_mod.smem_bytes(persons, label)


def test_block1_kernel_refuses_a_gradient(cuda):
    x = _rand((1, 8, 8, 3), 0.3, 9, cuda)
    wts = [_rand((3, 3, 3, 64), 0.2, 0, cuda), _rand((64,), 0.1, 1, cuda),
           _rand((3, 3, 64, 64), 0.05, 2, cuda), _rand((64,), 0.1, 3, cuda)]
    wts[0].requires_grad_()
    with pytest.raises(RuntimeError, match="inference-only"):
        block1(x, *wts)
    with torch.no_grad():
        assert block1(x, *wts).shape == (1, 4, 4, 64)


@pytest.mark.parametrize("net_dtype", ["float32", "float64"])
def test_small_train_step_on_cuda_as_on_cpu(cuda, net_dtype):
    """One step of the 2-stage model at boxsize 64 on the card and on the
    CPU: the gt kernel once, block1 never; losses within 1e-4 relative.
    With the network's arithmetic in f64 (so that no ReLU within rounding
    of zero decides differently) the updated parameters within 1e-5."""
    from tpupose_torch.config import AugmentConfig, ModelConfig, PoseConfig, TrainConfig
    from tpupose_torch.data.pipeline import synthetic_batches
    from tpupose_torch.gt.augment import batch_params
    from tpupose_torch.models import OpenPose
    from tpupose_torch.ops import gt as gt_mod
    from tpupose_torch.training import create_state, make_train_step

    cfg = PoseConfig(model=ModelConfig(boxsize=64, num_stages=2, compute_dtype="float32"),
                     augment=AugmentConfig(max_persons=3),
                     train=TrainConfig(batch_size=2, base_lr=1e-4))
    batch = next(synthetic_batches(cfg, 96, 96, seed=4))
    draws = batch_params(torch.Generator().manual_seed(4), cfg.augment, 2)
    dtype = getattr(torch, net_dtype)
    model = OpenPose(num_stages=2, dtype=dtype, head_dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(4))
    res = {}
    before = gt_mod.KERNEL.launches, block1_mod.KERNEL.launches
    for dev in ("cpu", "cuda"):
        state, tx = create_state(cfg, model.state_dict(), dev)
        tree, losses = make_train_step(cfg, model, tx)(state.tree(), draws, batch)
        res[dev] = ({k: float(v) for k, v in losses.items()},
                    {k: v.cpu() for k, v in tree["params"].items()})
    assert (gt_mod.KERNEL.launches, block1_mod.KERNEL.launches) == (before[0] + 1, before[1])
    for k, v in res["cpu"][0].items():
        assert abs(res["cuda"][0][k] / v - 1.0) <= 1e-4, k
    if net_dtype == "float64":
        for k, v in res["cpu"][1].items():
            assert (res["cuda"][1][k] - v).abs().max().item() <= 1e-5, k


def _save_pth(est, path):
    """The estimator's weights as a torch checkpoint of the original release's
    naming: ``model0.<caffe layer>.weight`` (OIHW) / ``.bias``."""
    from tpupose_torch.models import weights as weights_lib

    sd = {}
    for scope, layers in weights_lib.to_flax(est.model.state_dict()).items():
        for layer, leaves in layers.items():
            name = weights_lib._flax_name_to_keras(scope, layer)
            sd[f"model0.{name}.weight"] = torch.from_numpy(
                np.ascontiguousarray(leaves["kernel"].transpose(3, 2, 0, 1)))
            sd[f"model0.{name}.bias"] = torch.from_numpy(leaves["bias"])
    torch.save(sd, path)


def _two_stage_estimator():
    """2 stages, bf16, scales (0.5, 1.0), the last output convs scaled so that
    the random network emits peaks (as chip_smoke.py does)."""
    from tpupose_torch.config import ModelConfig, PoseConfig
    from tpupose_torch.infer import PoseEstimator

    cfg = PoseConfig(model=ModelConfig(num_stages=2),
                     inference=InferenceConfig(scale_search=(0.5, 1.0)))
    est = PoseEstimator(cfg, seed=3, device="cuda")
    img = np.random.default_rng(5).integers(0, 256, (368, 368, 3)).astype(np.uint8)
    heat, paf = est.maps(img)
    with torch.no_grad():
        for branch, peak in (("stage2_L2", heat[..., :18].abs().max()), ("stage2_L1", paf.abs().max())):
            head = getattr(est.model, branch).out
            head.weight.div_(peak)
            head.bias.div_(peak)
    return cfg, est


def test_pth_loaded_estimator_is_bit_equal_to_the_params_built_one(cuda, tmp_path):
    from tpupose_torch.infer import PoseEstimator
    from tpupose_torch.models import weights as weights_lib

    cfg, base = _two_stage_estimator()
    path = str(tmp_path / "w.pth")
    _save_pth(base, path)
    from_file = PoseEstimator(cfg, weights_path=path, device="cuda")
    from_params = PoseEstimator(cfg, params=weights_lib.to_flax(base.model.state_dict()),
                                device="cuda")
    assert from_file.pretrained and from_params.pretrained
    imgs = np.random.default_rng(6).integers(0, 256, (2, 368, 368, 3)).astype(np.uint8)
    got = from_file.process_batch_async(imgs)[1]
    want = from_params.process_batch_async(imgs)[1]
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert sum(len(p) for p in PoseEstimator._finish(2, got)) > 0


def test_bundle_exported_on_the_card_equals_the_live_estimator(cuda, tmp_path):
    """A bundle of the 2-stage estimator (one 368x368 program at batch 2)
    exported and loaded on the card: its tables equal the live estimator's
    at the same batch, and the four scale-space kernels launch inside the
    loaded program."""
    from tpupose_torch import ops
    from tpupose_torch.deploy import load_bundle, save_bundle

    _, est = _two_stage_estimator()
    path = str(tmp_path / "card.tppx")
    manifest = save_bundle(path, est, [(368, 368)], max_batch=2)
    assert manifest["device_type"] == "cuda" and len(manifest["programs"]) == 2
    dep = load_bundle(path)
    imgs = np.random.default_rng(8).integers(0, 256, (2, 368, 368, 3)).astype(np.uint8)
    valid = np.asarray([[368, 368], [300, 280]], np.int32)
    ops.reset_launch_counts()
    n, got = dep.process_batch_async(imgs, valid_hw=valid)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = est.process_batch_async(imgs, valid_hw=valid)[1]
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert sum(len(p) for p in dep._finish(n, got)) > 0
    assert {k: counts[k] for k in ("block1", "pyramid_peaks", "sample", "assoc")} == \
        {"block1": 2, "pyramid_peaks": 1, "sample": 1, "assoc": 1}
    assert counts["gt"] == counts["peaks"] == 0


def test_bundle_exported_on_cuda0_runs_on_cuda1_as_on_cuda0(cuda, tmp_path):
    """A bundle exported on cuda:0 and loaded on cuda:1: every program is
    moved there (no node of its graphs names cuda:0), its kernels launch
    there, and its tables equal those of the same bundle on cuda:0 bit for
    bit. Skips below two cards."""
    from tpupose_torch import ops
    from tpupose_torch.deploy import load_bundle, save_bundle

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    _, est = _two_stage_estimator()
    path = str(tmp_path / "card0.tppx")
    manifest = save_bundle(path, est, [(368, 368)], max_batch=2)
    assert manifest["device"] == "cuda:0"
    on0, on1 = load_bundle(path, "cuda:0"), load_bundle(path, "cuda:1")
    assert on1.device == torch.device("cuda:1")
    for ep in on1._programs.values():
        for gm in ep.graph_module.modules():
            if isinstance(gm, torch.fx.GraphModule):
                for node in gm.graph.nodes:
                    named = [a for a in (*node.args, *node.kwargs.values())
                             if isinstance(a, (torch.device, str)) and str(a).startswith("cuda")]
                    assert all(str(a) == "cuda:1" for a in named), node.format_node()
    imgs = np.random.default_rng(8).integers(0, 256, (2, 368, 368, 3)).astype(np.uint8)
    valid = np.asarray([[368, 368], [300, 280]], np.int32)
    torch.backends.cudnn.deterministic = True
    try:
        want = on0.process_batch_async(imgs, valid_hw=valid)[1]
        ops.reset_launch_counts()
        n, got = on1.process_batch_async(imgs, valid_hw=valid)
        torch.cuda.synchronize(1)
        counts = ops.launch_counts()
    finally:
        torch.backends.cudnn.deterministic = False
    for key in want:
        assert got[key].device == torch.device("cuda:1"), key
        assert torch.equal(got[key].cpu(), want[key].cpu()), key
    assert sum(len(p) for p in on1._finish(n, got)) > 0
    assert {k: counts[k] for k in ("block1", "pyramid_peaks", "sample", "assoc")} == \
        {"block1": 2, "pyramid_peaks": 1, "sample": 1, "assoc": 1}


def test_one_request_through_serve_on_the_card_equals_process(cuda):
    import http.client
    import json

    from tpupose_torch.serve import serve
    from tpupose_torch.testing import png_bytes

    _, est = _two_stage_estimator()
    img = np.random.default_rng(7).integers(0, 256, (368, 368, 3)).astype(np.uint8)
    srv = serve(est, port=0)
    try:
        c = http.client.HTTPConnection(*srv.server_address[:2], timeout=300)
        c.request("POST", "/pose", body=png_bytes(img))
        r = c.getresponse()
        assert r.status == 200
        people = json.loads(r.read())["people"]
    finally:
        srv.shutdown()
    assert people == json.loads(json.dumps(est.process(img)["people"]))
    assert len(people) > 0


# --- the multi-device slice on the one card ---------------------------------------------------


def test_remat_step_on_cuda_equals_remat_off(cuda):
    """A small f32 train step with ``remat`` off and on, deterministic cuDNN:
    the losses bit-equal, the updated parameters within 1e-5."""
    from tpupose_torch.config import AugmentConfig, ModelConfig, PoseConfig, TrainConfig
    from tpupose_torch.data.pipeline import synthetic_batches
    from tpupose_torch.gt.augment import batch_params
    from tpupose_torch.models import OpenPose
    from tpupose_torch.training import create_state, make_train_step

    cfg = PoseConfig(model=ModelConfig(boxsize=64, num_stages=2, compute_dtype="float32"),
                     augment=AugmentConfig(max_persons=3),
                     train=TrainConfig(batch_size=2, base_lr=1e-4))
    batch = next(synthetic_batches(cfg, 96, 96, seed=4))
    draws = batch_params(torch.Generator().manual_seed(4), cfg.augment, 2)
    init = OpenPose(num_stages=2, dtype=torch.float32)
    init.reset_parameters(torch.Generator().manual_seed(4))
    torch.backends.cudnn.deterministic = True
    try:
        out = []
        for remat in (False, True):
            state, tx = create_state(cfg, init.state_dict(), "cuda")
            model = OpenPose(num_stages=2, dtype=torch.float32, remat=remat)
            tree, losses = make_train_step(cfg, model, tx)(state.tree(), draws, batch)
            out.append((losses, tree["params"]))
    finally:
        torch.backends.cudnn.deterministic = False
    (l0, p0), (l1, p1) = out
    assert all(torch.equal(l0[k], l1[k]) for k in l0)
    assert max((p1[k] - v).abs().max().item() for k, v in p0.items()) <= 1e-5


def test_dp_estimator_two_replicas_on_one_card(cuda):
    """Two replicas on cuda:0: each chunk's people are the estimator's on
    that chunk with the batch-wide overflow switch; block1 once per chunk."""
    from tpupose_torch import ops
    from tpupose_torch.config import InferenceConfig, ModelConfig, PoseConfig
    from tpupose_torch.infer import PoseEstimator
    from tpupose_torch.parallel.inference import DataParallelEstimator
    from tpupose_torch.parallel.sharding import Mesh

    est = PoseEstimator(PoseConfig(model=ModelConfig(num_stages=2),
                                   inference=InferenceConfig(scale_search=(1.0,))),
                        seed=0, device="cuda")
    with torch.no_grad():
        for branch in (est.model.stage2_L1, est.model.stage2_L2):
            branch.out.weight.mul_(3000.0)
    imgs = (np.random.default_rng(3).random((4, 96, 96, 3)) * 255).astype(np.uint8)
    dp = DataParallelEstimator(est, Mesh([cuda, cuda], ("data",)))
    ops.reset_launch_counts()
    got = dp.process_batch(imgs)
    torch.cuda.synchronize()
    launched = ops.launch_counts()
    assert launched["block1"] == 2 and launched["assoc"] == 2 and launched["pyramid_peaks"] == 2
    scored = [est._scores(imgs[i:i + 2], None, None) for i in (0, 2)]
    k = est.cfg.inference.max_peaks
    overflow = any(bool((torch.isfinite(f).sum(-1) > k).any()) for f, _, _ in scored)
    want = sum((est._finish(2, est._tables(s, overflow)) for s in scored), [])
    assert [len(p) for p in got] == [len(p) for p in want]
    for pg, pw in zip(got, want):
        for a, b in zip(pg, pw):
            assert a["num_parts"] == b["num_parts"] and abs(a["score"] - b["score"]) <= 1e-4
            assert {n: (v["x"], v["y"]) for n, v in a["keypoints"].items()} == \
                {n: (v["x"], v["y"]) for n, v in b["keypoints"].items()}


def test_spatial_forward_over_two_tiles_on_one_card(cuda):
    """Block 1 of two tiles through the block1 kernel (2-row halo, cropped
    pooled row) bit-equal to the whole image's kernel call; the f32 network's
    final maps over 2 tiles within relative L2 1e-4 of the whole image's."""
    from tpupose_torch.models import OpenPose
    from tpupose_torch.parallel import spatial
    from tpupose_torch.parallel.sharding import Mesh

    x = _rand((1, 88, 64, 3), 0.3, 21, cuda)
    bf = OpenPose(num_stages=2, dtype=torch.bfloat16, pallas_block1=True)
    bf.reset_parameters(torch.Generator().manual_seed(1))
    bf = bf.to(cuda, memory_format=torch.channels_last).eval()
    with torch.no_grad():
        nchw = x.permute(0, 3, 1, 2)
        whole = bf.vgg.block1(nchw)
        bounds = [0, 40, 88]
        tiles = spatial._Tiles([nchw[:, :, a:b] for a, b in zip(bounds, bounds[1:])], bounds,
                               [cuda, cuda])
        got = spatial._block1(tiles, [bf, bf]).gather()
    assert torch.equal(got, whole)                   # the kernel is row-local
    f32 = OpenPose(num_stages=2, dtype=torch.float32)
    f32.reset_parameters(torch.Generator().manual_seed(1))
    f32 = f32.to(cuda, memory_format=torch.channels_last).eval()
    with torch.no_grad():
        want = f32(x)[-1]
    out = spatial.build_spatial_forward(f32, Mesh([cuda, cuda], ("spatial",)))(x)
    for a, b in zip(out, want):
        assert ((a - b).norm() / b.norm()).item() <= 1e-4


def test_paths_with_a_mesh_entry_on_every_card_launch_on_each_card(cuda):
    """The DP estimator, the sharded pyramid and the tiled forward over one
    mesh entry per card: every replica's, canvas chunk's and tile's kernels
    launch on its own card (each launch makes its tensors' card current),
    and the results equal those of the same mesh with every entry on cuda:0."""
    from tpupose_torch import ops
    from tpupose_torch.config import ModelConfig, PoseConfig
    from tpupose_torch.infer import PoseEstimator
    from tpupose_torch.parallel import pyramid, spatial
    from tpupose_torch.parallel.inference import DataParallelEstimator
    from tpupose_torch.parallel.sharding import Mesh

    def same(got, want):
        assert [len(p) for p in got] == [len(p) for p in want]
        for pg, pw in zip(got, want):
            for a, b in zip(pg, pw):
                assert a["num_parts"] == b["num_parts"] and abs(a["score"] - b["score"]) <= 1e-4
                assert {k: (v["x"], v["y"]) for k, v in a["keypoints"].items()} == \
                    {k: (v["x"], v["y"]) for k, v in b["keypoints"].items()}

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    cards = [torch.device("cuda", i) for i in range(n)]
    one = [torch.device("cuda", 0)] * n
    est = PoseEstimator(PoseConfig(model=ModelConfig(num_stages=2),
                                   inference=InferenceConfig(scale_search=(0.5, 1.0))),
                        seed=0, device="cuda:0")
    with torch.no_grad():
        for branch in (est.model.stage2_L1, est.model.stage2_L2):
            branch.out.weight.mul_(3000.0)
    imgs = (np.random.default_rng(3).random((2 * n, 96, 96, 3)) * 255).astype(np.uint8)
    torch.backends.cudnn.deterministic = True
    try:
        ops.reset_launch_counts()
        got = DataParallelEstimator(est, Mesh(cards, ("data",))).process_batch(imgs)
        for d in cards:
            torch.cuda.synchronize(d)
        assert ops.launch_counts()["block1"] == 2 * n and ops.launch_counts()["assoc"] == n
        want = DataParallelEstimator(est, Mesh(one, ("data",))).process_batch(imgs)
        assert sum(map(len, want)) > 0
        same(got, want)
        mesh2 = pyramid.data_scale_mesh(2, cards[:2 * (n // 2)])
        mesh1 = pyramid.data_scale_mesh(2, one[:2 * (n // 2)])
        sharded = [[p["people"] for p in pyramid.sharded_process_batch(est, imgs, m)]
                   for m in (mesh2, mesh1)]
        same(*sharded)
        x = image.normalize(torch.from_numpy(imgs[0]).to(cuda), "bgr")
        x = image.resize_bilinear(x, 8 * 8 * n, 96)[None]
        tiled = [spatial.build_spatial_forward(est.model, Mesh(m, ("spatial",)))(x)
                 for m in (cards, one)]
        for a, b in zip(*tiled):
            assert a.device == cards[0] and ((a - b).norm() / b.norm()).item() <= 1e-6
    finally:
        torch.backends.cudnn.deterministic = False


# --- the benchmark ------------------------------------------------------------------------------


def test_bench_device_rate_and_latency_launch_the_inference_kernels(cuda):
    """``benchmark._measure_on_device`` and ``_measure_latency`` on a
    full-width estimator (VGG19 + 6 stages, 4 scales): positive rates and
    times, and block1, pyramid_peaks, sample and assoc launched, gt and
    peaks not, peak_tables once for each call that took the sorted order."""
    from tpupose_torch import benchmark, ops
    from tpupose_torch.infer import PoseEstimator
    from tpupose_torch.utils import profiling

    image, _, _ = benchmark.synthetic_scene(368)
    est = PoseEstimator(seed=0, device=cuda)
    profiling.reset_counters()
    ips = benchmark._measure_on_device(est, np.stack([image] * 8), None, iters=2)
    lat = benchmark._measure_latency(est, image, (1.0,), iters=3)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert ips > 0 and set(lat) == {"wall_p50_ms", "wall_p99_ms", "device_mean_ms"}
    assert 0 < lat["wall_p50_ms"] <= lat["wall_p99_ms"] and lat["device_mean_ms"] > 0
    # 3 program calls at 4 scales, then 1 + 3 + 1 + 3 at scale 1.0
    sorted_calls = profiling.counters().get("decode.tables.sorted", 0)
    assert counts == {"block1": 3 * 4 + 8, "pyramid_peaks": 11, "sample": 11, "assoc": 11,
                      "gt": 0, "peaks": 0, "peak_tables": sorted_calls, "dense_epilogue": 0}, counts


# --- the program's spans ----------------------------------------------------------------------


def test_program_spans_are_user_annotations_on_the_kernels_time_base(cuda, monkeypatch):
    """A 4-scale stream under ``posebench.trace.profiled``: every device
    mirror of the program's spans is a user annotation, so ``busy_s``,
    ``by_kernel`` and the breakdown leave it out; the host spans and the
    kernels share one time base (each kernel falls between the first span's
    start and the last span's end); the store counts one span a batch."""
    from posebench.trace import WINDOW, _is_device, _is_kernel, profiled
    from tpupose_torch.infer import PoseEstimator
    from tpupose_torch.utils import profiling

    names = ("infer.enqueue", "decode.overflow_switch", "infer.finish")
    est = PoseEstimator(seed=0, device=cuda)
    batches = [np.random.default_rng(i).integers(0, 255, (2, 240, 320, 3)).astype(np.uint8)
               for i in range(3)]
    for _ in est.stream(iter(batches), depth=1):                     # builds and warms
        pass
    torch.cuda.synchronize()
    kept = []

    class Kept(torch.profiler.profile):
        def __enter__(self):
            kept.append(self)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "profile", Kept)

    def window(span):
        with span(WINDOW):
            for _ in est.stream(iter(batches), depth=1):
                pass
            torch.cuda.synchronize()
        return {}

    profiling.reset_spans()
    trace = profiled(window, ())
    totals = profiling.span_totals()
    assert {k: totals[k]["count"] for k in names} == dict.fromkeys(names, len(batches))
    assert not set(trace.by_kernel) & set(names)
    assert not {name for name, _ in trace.breakdown()["device_ops"]} & set(names)
    assert 0 < trace.busy_s <= trace.window_s
    events = kept[0].events()
    mirrors = [e for e in events if e.name in names and _is_device(e)]
    assert any(e.name == "infer.enqueue" for e in mirrors)
    assert all(e.is_user_annotation and not _is_kernel(e, (WINDOW,)) for e in mirrors)
    host = [e for e in events if e.name in names and not _is_device(e)]
    kernels = [e for e in events if _is_kernel(e, (WINDOW,))]
    t0 = min(e.time_range.start for e in host)
    t1 = max(e.time_range.end for e in host)
    assert kernels and all(t0 <= k.time_range.start and k.time_range.end <= t1 for k in kernels)
    profiling.reset_spans()
