"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without a CUDA device. This file
imports no jax, so it also runs where only torch is installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Tolerances: block1 within the bf16 bound of tests/test_pallas_block1.py
(against an f32 truth); pyramid peaks the same peak mask and values
within 1e-5; sample within 1e-5; assoc bit-equal; peaks bit-equal; the
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
    assert scan(*(t.data_ptr() for t in ins), pairs.data_ptr(), ts.shape[0], 19, ts.shape[2], k, k,
                256, *(out[key].data_ptr() for key in ("rows", "score", "cnt", "active", "stamp")),
                torch.cuda.current_stream().cuda_stream) == 0
    for key in want:
        assert torch.equal(out[key], want[key]), key


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
