"""Scale-space peak scores: per-scale low-res heatmaps -> masked scores.

Counterpart of ``tpupose/ops/pallas_pyramid_peaks.py``.
``pyramid_peak_scores`` launches ``csrc/pyramid_peaks.cu`` for CUDA
tensors and runs ``pyramid_peak_scores_plain`` —
``scalespace.pyramid_heat_maps`` + ``peaks.masked_scores``, the path the
Pallas kernel replaced — for CPU tensors. Both are the registered
operator ``tpupose_torch::pyramid_peak_scores``, whose ``ScaleSpace`` is a
list of maps and its geometry as ints.

The kernel takes the operators of ``chain_matrices`` as band tables
(``band_table``, ``device_bands``), built on the host once per geometry,
sigma and device, and reads the maps through their strides.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpupose_torch.decode.peaks import masked_scores
from tpupose_torch.decode.scalespace import (
    ScaleSpace, chain_matrices, pyramid_heat_maps, scale_shapes,
)
from tpupose_torch.ops._build import CudaKernel

_MAX_SCALES = 8
_SMEM_LIMIT = 227 * 1024
# csrc/pyramid_peaks.cu: kRows, kThreads, kGroup, kPeakList, kLPitch, kCensusRows (card
# tests hold smem_bytes and census_chunks to the kernel's own counts)
_ROWS, _THREADS, _GROUP, _PEAK_LIST, _CENSUS_ROWS = 16, 384, 3, 1024, 8
_OUT_ROWS, _COL_TILE, _LPITCH = _ROWS - 2, _THREADS - 2, _ROWS + 4
_PTRS = ctypes.c_void_p * _MAX_SCALES
_INTS = ctypes.c_int * _MAX_SCALES
_LONGS = ctypes.c_longlong * _MAX_SCALES


class _Params(ctypes.Structure):
    _fields_ = [
        ("n_scales", ctypes.c_int), ("batch", ctypes.c_int),
        ("parts", ctypes.c_int), ("out_h", ctypes.c_int),
        ("out_w", ctypes.c_int), ("n_groups", ctypes.c_int),
        ("n_bands", ctypes.c_int), ("n_tiles", ctypes.c_int),
        ("sb", _LONGS), ("sh", _LONGS), ("sw", _LONGS), ("sc", _LONGS),
        ("maps", _PTRS),
        ("ay_start", _PTRS), ("ay_coef", _PTRS), ("bx_start", _PTRS), ("bx_coef", _PTRS),
        ("wy_start", _PTRS), ("wy_coef", _PTRS), ("wx_start", _PTRS), ("wx_coef", _PTRS),
        ("ay_w", _INTS), ("bx_w", _INTS), ("wy_w", _INTS), ("wx_w", _INTS),
        ("hcap", _INTS), ("wcap", _INTS),
        ("inv_n", ctypes.c_float), ("thre1", ctypes.c_float),
        ("out", ctypes.c_void_p),
        ("hl", _INTS), ("wl", _INTS),
        ("census", ctypes.c_void_p), ("census_chunks", ctypes.c_int),
    ]


KERNEL = CudaKernel(
    "pyramid_peaks", "tp_pyramid_peaks", [ctypes.POINTER(_Params), ctypes.c_void_p],
    replaces="tpupose/ops/pallas_pyramid_peaks.py:74",
)
_OPERATORS = ("wy", "wx", "ay", "bx")     # the order of chain_matrices


def band_table(mat: np.ndarray, within: tuple | None = None) -> tuple[np.ndarray, np.ndarray]:
    """(n_out, n_low) operator -> (start (n_out,) int32, coef (width, n_out) f32).

    Row i of ``mat`` is zero outside ``start[i] .. start[i] + width - 1``
    and equals ``coef[:, i]`` there; ``width`` is the widest run of
    non-zero entries of any row, and shorter runs are padded with exact
    zeros (a run near the end of the axis starts early enough to fit).
    With ``within``, the band table of a wider operator over the same
    axes, each padded run also ends by the end of that operator's run of
    the same row, so it lies inside it wherever its non-zero entries do.
    Starts never decrease. Raises ``ValueError`` for an operator that is
    not banded so.
    """
    mat = np.asarray(mat, np.float32)
    n_out, n_low = mat.shape
    nz = mat != 0
    live = nz.any(axis=1)
    first = np.where(live, nz.argmax(axis=1), 0)
    last = np.where(live, n_low - 1 - nz[:, ::-1].argmax(axis=1), 0)
    width = int((last - first + 1)[live].max()) if live.any() else 1
    # an all-zero row takes its predecessor's start
    first = np.maximum.accumulate(np.where(live, first, 0))
    end = np.full(n_out, n_low)
    if within is not None:
        end = np.minimum(end, within[0] + len(within[1]))
    start = np.minimum(first, end - width).astype(np.int32)
    coef = np.take_along_axis(mat, start[:, None] + np.arange(width), axis=1)
    back = np.zeros_like(mat)
    np.put_along_axis(back, start[:, None] + np.arange(width), coef, axis=1)
    if not np.array_equal(back, mat) or (np.diff(start) < 0).any() or start.min(initial=0) < 0:
        raise ValueError("band_table: the operator is not one non-decreasing band per row")
    return start, np.ascontiguousarray(coef.T)


def _block_ends(n: int, step: int) -> tuple[np.ndarray, np.ndarray]:
    """First and last output of each block of the kernel along an axis of
    ``n``: ``step`` outputs and one halo output each side, clipped."""
    firsts = np.arange(0, n, step)
    return np.maximum(firsts - 1, 0), np.minimum(firsts + step, n - 1)


def _reach(start: np.ndarray, width: int, step: int) -> int:
    """Most low-res indices one block reaches: what the kernel stages for it."""
    lo, hi = _block_ends(len(start), step)
    return int((start[hi] + width - start[lo]).max())


def _within(inner: tuple, outer: tuple, step: int) -> bool:
    """Whether every block's runs of ``inner`` lie within the low-res range
    its runs of ``outer`` reach: the kernel keeps the plain chain's left
    products in the blurred chain's rows and columns."""
    (i_start, i_coef), (o_start, o_coef) = inner, outer
    lo, hi = _block_ends(len(o_start), step)
    return bool((i_start[lo] >= o_start[lo]).all()
                and (i_start[hi] + len(i_coef) <= o_start[hi] + len(o_coef)).all())


_BANDS: dict = {}


def bands(shapes: tuple, out_hw: tuple, sigma: float) -> list[dict]:
    """Per scale, the band tables of Wy, Wx, Ay = G Wy and Bx = G Wx (as
    ``band_table`` gives them, from ``chain_matrices``' f32 arrays) and the
    low-res rows and columns one block of the kernel reaches at most."""
    key = (shapes, out_hw, sigma)
    if key not in _BANDS:
        out = []
        for wy, wx, ay, bx in chain_matrices(shapes, out_hw, sigma):
            # the blurred runs first: the plain chain's runs are placed inside them
            tab = {"ay": band_table(ay), "bx": band_table(bx)}
            tab["wy"] = band_table(wy, within=tab["ay"])
            tab["wx"] = band_table(wx, within=tab["bx"])
            ay_start, ay_coef = tab["ay"]
            bx_start, bx_coef = tab["bx"]
            tab["hcap"] = _reach(ay_start, len(ay_coef), _OUT_ROWS)
            tab["wcap"] = _reach(bx_start, len(bx_coef), _COL_TILE)
            if not (_within(tab["wy"], tab["ay"], _OUT_ROWS)
                    and _within(tab["wx"], tab["bx"], _COL_TILE)):
                raise ValueError("pyramid_peak_scores: the plain chain's bands reach beyond "
                                 "the blurred ones")
            out.append(tab)
        _BANDS[key] = out
    return _BANDS[key]


def census_chunks(shapes: tuple) -> int:
    """Census words per image and channel: chunks of the kernel's census
    rows over every scale's low-res rows."""
    return sum(-(-hl // _CENSUS_ROWS) for hl, _, _, _ in shapes)


def smem_bytes(shapes: tuple, out_hw: tuple, sigma: float) -> int:
    """Shared memory a block of the kernel asks for at this geometry
    (``scale_shapes`` of the maps, the image size, the blur); raises
    ``ValueError`` where that is more than a block of the H100 may hold."""
    tables = bands(shapes, out_hw, sigma)
    hsum = sum(t["hcap"] for t in tables)
    wsum = sum(t["wcap"] for t in tables)
    need = 4 * (2 * _ROWS * hsum + _GROUP * wsum * (_LPITCH + _ROWS)
                + _GROUP * (_THREADS // 32) * 2 * _ROWS + _PEAK_LIST + _GROUP)
    if need > _SMEM_LIMIT:
        raise ValueError(f"pyramid_peak_scores: geometry {shapes} -> {out_hw} needs {need} "
                         f"bytes of shared memory a block, more than {_SMEM_LIMIT}")
    return need


# device copies of the band tables, per (geometry, sigma, device)
_DEVICE_BANDS: dict = {}


def device_bands(shapes: tuple, out_hw: tuple, sigma: float, device) -> list[dict]:
    key = (shapes, out_hw, sigma, str(device))
    if key not in _DEVICE_BANDS:
        _DEVICE_BANDS[key] = [
            {name: tuple(torch.from_numpy(a).to(device) for a in t[name]) for name in _OPERATORS}
            for t in bands(shapes, out_hw, sigma)
        ]
    return _DEVICE_BANDS[key]


def pyramid_peak_scores_plain(space: ScaleSpace, parts: int, sigma: float,
                              thre1: float) -> torch.Tensor:
    """Matrix-product formulation in torch (see ``pyramid_peak_scores``)."""
    sub = space.map_scales(lambda m: m[..., :parts])
    avg, smooth = pyramid_heat_maps(sub, sigma)
    return masked_scores(avg, smooth, thre1)


def _space(maps, geoms: list[int], out_h: int, out_w: int) -> ScaleSpace:
    """The ScaleSpace of an operator's arguments (``geoms`` flat: rh, rw per scale)."""
    return ScaleSpace(maps, list(zip(geoms[::2], geoms[1::2])), (out_h, out_w))


@torch.library.custom_op("tpupose_torch::pyramid_peak_scores", mutates_args=(),
                         device_types="cpu")
def _pyramid_op(maps: list[torch.Tensor], geoms: list[int], out_h: int, out_w: int,
                parts: int, sigma: float, thre1: float) -> torch.Tensor:
    space = _space(maps, geoms, out_h, out_w)
    return pyramid_peak_scores_plain(space, parts, sigma, thre1).contiguous()


@_pyramid_op.register_kernel("cuda")
def _pyramid_cuda(maps, geoms, out_h, out_w, parts, sigma, thre1):
    space = _space(maps, geoms, out_h, out_w)
    b = maps[0].shape[0]
    dev = maps[0].device
    maps = [m.detach() if m.dtype == torch.float32 else m.detach().float() for m in maps]
    smem_bytes(scale_shapes(space), space.out_hw, float(sigma))
    if b * -(-out_w // _COL_TILE) > 65535:
        raise ValueError(f"pyramid_peak_scores: {b} images of width {out_w} exceed the grid")
    out = torch.empty((b, parts, out_h * out_w), dtype=torch.float32, device=dev)
    if out.numel():
        census = torch.empty((b, census_chunks(scale_shapes(space)), parts), dtype=torch.int32,
                             device=dev)
        p = _params(ScaleSpace(maps, space.geoms, space.out_hw), parts, float(sigma), thre1, out,
                    census)
        KERNEL.launch(dev, ctypes.byref(p))
    return out


@_pyramid_op.register_fake
def _pyramid_fake(maps, geoms, out_h, out_w, parts, sigma, thre1):
    return maps[0].new_empty((maps[0].shape[0], parts, out_h * out_w), dtype=torch.float32)


def pyramid_peak_scores(space: ScaleSpace, parts: int = 18, sigma: float = 3.0,
                        thre1: float = 0.1) -> torch.Tensor:
    """Per-scale low-res heatmaps -> (B, parts, H*W) masked peak scores.

    space: ScaleSpace of (B, Hl, Wl, C) maps (channels >= ``parts`` are
    ignored). Per channel: avg = scale-averaged chained-bilinear upsample,
    smooth = its sigma-blur (reflect borders); peaks are smooth >= its 4
    neighbours (zero outside) and smooth > thre1. The output holds avg at
    peaks and -inf elsewhere. CPU tensors take the plain version; CUDA
    tensors the kernel, which reads f32 maps in place through their
    strides. Both are the operator ``tpupose_torch::pyramid_peak_scores``.
    """
    maps = space.maps
    b = maps[0].shape[0]
    for m in maps:
        if m.dim() != 4 or m.shape[0] != b or m.shape[-1] < parts or parts < 1:
            raise ValueError(f"pyramid_peak_scores: map {tuple(m.shape)}")
    dev = maps[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"pyramid_peak_scores: unsupported device {dev}")
    if dev.type == "cuda":
        if len(maps) > _MAX_SCALES:
            raise ValueError(f"pyramid_peak_scores: at most {_MAX_SCALES} scales")
        if any(m.device != dev for m in maps):
            raise ValueError("pyramid_peak_scores: maps on different devices")
    geoms = [v for g in space.geoms for v in g]
    return _pyramid_op(list(maps), geoms, *space.out_hw, parts, float(sigma), float(thre1))


def _params(space: ScaleSpace, parts: int, sigma: float, thre1: float,
            out: torch.Tensor, census: torch.Tensor | None = None) -> _Params:
    """The kernel's parameters: f32 maps on one CUDA device, read through
    their strides, the device's band tables of their geometry, and the
    int32 (B, ``census_chunks``, parts) buffer the census kernel fills."""
    maps = space.maps
    shapes = scale_shapes(space)
    tables = bands(shapes, space.out_hw, sigma)
    on_dev = device_bands(shapes, space.out_hw, sigma, maps[0].device)
    out_h, out_w = space.out_hw
    p = _Params()
    p.n_scales, p.batch, p.parts, p.out_h, p.out_w = len(maps), maps[0].shape[0], parts, out_h, out_w
    p.n_groups, p.n_bands = -(-parts // _GROUP), -(-out_h // _OUT_ROWS)
    p.n_tiles = -(-out_w // _COL_TILE)
    for s, (m, tab, dtab) in enumerate(zip(maps, tables, on_dev)):
        p.sb[s], p.sh[s], p.sw[s], p.sc[s] = m.stride()
        p.maps[s] = m.data_ptr()
        for name in _OPERATORS:
            start, coef = dtab[name]
            getattr(p, f"{name}_start")[s] = start.data_ptr()
            getattr(p, f"{name}_coef")[s] = coef.data_ptr()
            getattr(p, f"{name}_w")[s] = coef.shape[0]
        p.hcap[s], p.wcap[s] = tab["hcap"], tab["wcap"]
        p.hl[s], p.wl[s] = m.shape[1], m.shape[2]
    p.census = 0 if census is None else census.data_ptr()
    p.census_chunks = census_chunks(shapes)
    p.inv_n = 1.0 / len(maps)
    p.thre1 = thre1
    p.out = out.data_ptr()
    return p
