"""Scale-space point readout of the PAF line integral.

Counterpart of ``tpupose/ops/pallas_sample.py`` (the readout contract of
``scalespace.sample_avg``). ``sample_avg`` launches ``csrc/sample.cu``
for CUDA tensors and runs ``sample_avg_plain`` for CPU tensors. The
kernel takes its taps from ``tap_table``, which is ``axis_taps`` at every
coordinate and one beyond each edge, built on the host once per geometry.
Both are the registered operator ``tpupose_torch::sample_avg``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpupose_torch.decode.scalespace import (
    ScaleSpace, census, holds, line_classes, tap_footprint,
)
from tpupose_torch.ops._build import CudaKernel

_MAX_SCALES = 8
_STRIDE = 8
_CENSUS_ROWS = 2            # csrc/sample.cu kCensusRows


class _Params(ctypes.Structure):
    _fields_ = [
        ("n_scales", ctypes.c_int), ("batch", ctypes.c_int),
        ("groups", ctypes.c_int), ("out_h", ctypes.c_int),
        ("out_w", ctypes.c_int), ("paired", ctypes.c_int),
        ("points", ctypes.c_longlong),
        ("hl", ctypes.c_int * _MAX_SCALES), ("wl", ctypes.c_int * _MAX_SCALES),
        ("cstride", ctypes.c_int * _MAX_SCALES),
        ("maps", ctypes.c_void_p * _MAX_SCALES),
        ("iy", ctypes.c_void_p), ("ix", ctypes.c_void_p),
        ("chans", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("tap_w", ctypes.c_void_p), ("tap_i", ctypes.c_void_p),
        ("census", ctypes.c_void_p), ("census_words", ctypes.c_int),
        ("channels", ctypes.c_int), ("census_chunks", ctypes.c_int),
    ]


KERNEL = CudaKernel(
    "sample", "tp_sample",
    [ctypes.POINTER(_Params), ctypes.c_void_p],
    replaces="tpupose/ops/pallas_sample.py:130",
)
_TABLES: dict = {}          # (geometry, device) -> tap table on that device
_TABLES_MAX = 32
_CHANS: dict = {}           # (channel pairs, device) -> int32 (L, 2) on that device


def axis_taps(q: torch.Tensor, size_mid: int, size_low: int, out_size: int,
              stride: int = _STRIDE):
    """Low-res taps/weights of the chained bilinear along one axis, for
    integer output coordinates ``q``: (idx, w), each (*q.shape, 4).
    Duplicate (clamped) indices carry additive weights."""
    qf = q.to(torch.float32)
    pos_mid = (qf + 0.5) * (size_mid / out_size) - 0.5
    m0 = torch.floor(pos_mid)
    f_mid = pos_mid - m0
    m0i = torch.clamp(m0.to(torch.int32), 0, size_mid - 1)
    m1i = torch.clamp(m0.to(torch.int32) + 1, 0, size_mid - 1)

    def low_taps(mid_idx):
        pos_low = (mid_idx.to(torch.float32) + 0.5) / float(stride) - 0.5
        l0 = torch.floor(pos_low)
        f = pos_low - l0
        l0i = torch.clamp(l0.to(torch.int32), 0, size_low - 1)
        l1i = torch.clamp(l0.to(torch.int32) + 1, 0, size_low - 1)
        return (l0i, l1i), (1.0 - f, f)

    (a0, a1), (wa0, wa1) = low_taps(m0i)
    (b0, b1), (wb0, wb1) = low_taps(m1i)
    w0 = 1.0 - f_mid
    w1 = f_mid
    idx = torch.stack([a0, a1, b0, b1], dim=-1)
    w = torch.stack([w0 * wa0, w0 * wa1, w1 * wb0, w1 * wb1], dim=-1)
    return idx, w


def tap_table(geoms, low_sizes, out_hw):
    """Every tap set of a geometry: (w (E, 4) f32, idx (E, 4) int16) with
    E = n_scales * (out_h + out_w + 4). A scale's rows are its y tap sets
    at image rows -1 .. out_h, then its x tap sets at columns -1 .. out_w:
    ``axis_taps`` of all coordinates, so the kernel's weights are the plain
    version's bit for bit. The coordinate beyond each edge serves every
    point outside the image: there the clamped taps rest on the edge pixel.

    geoms: per scale (rh, rw), the cropped x8 size; low_sizes: per scale
    (hl, wl), the low-res map size.
    """
    out_h, out_w = out_hw
    ws, idxs = [], []
    for (rh, rw), (hl, wl) in zip(geoms, low_sizes):
        for n, mid, low in ((out_h, rh, hl), (out_w, rw, wl)):
            idx, w = axis_taps(torch.arange(-1, n + 1, dtype=torch.int32), mid, low, n)
            ws.append(w)
            idxs.append(idx.to(torch.int16))
    return torch.cat(ws), torch.cat(idxs)


def _device_tap_table(space, device):
    """``tap_table`` of ``space`` on ``device``, built once per geometry."""
    low = tuple(tuple(m.shape[1:3]) for m in space.maps)
    key = (tuple(tuple(g) for g in space.geoms), low, tuple(space.out_hw), str(device))
    hit = _TABLES.get(key)
    if hit is None:
        while len(_TABLES) >= _TABLES_MAX:
            del _TABLES[next(iter(_TABLES))]
        w, idx = tap_table(space.geoms, low, space.out_hw)
        hit = _TABLES[key] = (w.to(device).contiguous(), idx.to(device).contiguous())
    return hit


def census_words(low_sizes) -> int:
    """Words of the kernel's census record of one (image, channel): per
    scale (hl, wl) a word and a mask of its rows and of its columns, a bit
    per low-res row or column."""
    return sum(1 + -(-hl // 32) + -(-wl // 32) for hl, wl in low_sizes)


def census_chunks(low_rows) -> int:
    """The direct variant's census words per image and channel: chunks of
    the kernel's census rows (2) over every scale's low-res rows."""
    return sum(-(-hl // _CENSUS_ROWS) for hl in low_rows)


def staged_bytes(space) -> int:
    """Shared memory the staged variant needs for ``space``: one image's
    channel pair of every scale, the tap table and the census records of
    the pair. The launcher takes the direct variant where this exceeds what a
    block may opt in to (227 KB on the H100)."""
    out_h, out_w = space.out_hw
    pixels = sum(m.shape[1] * m.shape[2] for m in space.maps)
    record = census_words([m.shape[1:3] for m in space.maps])
    return (pixels * 8 + _MAX_SCALES * 4 + 2 * record * 4
            + len(space.maps) * (out_h + out_w + 4) * 24)


def _device_chans(pairs: list[int], device):
    """The (L, 2) channel pairs on ``device``, uploaded once per table: a
    host-to-device copy per call would hold the host until the stream's
    earlier work is done."""
    key = (tuple(pairs), str(device))
    hit = _CHANS.get(key)
    if hit is None:
        while len(_CHANS) >= _TABLES_MAX:
            del _CHANS[next(iter(_CHANS))]
        hit = _CHANS[key] = torch.tensor(pairs, dtype=torch.int32).reshape(-1, 2).to(device)
    return hit


def _footprints(n: int, size_mid: int, size_low: int, device) -> torch.Tensor:
    """(n + 2, size_low) 0/1 f32: the footprint of each coordinate -1 .. n
    along one axis, its taps of non-zero weight (``tap_footprint``); a
    point beyond an edge has the footprint of the coordinate just beyond."""
    idx, w = axis_taps(torch.arange(-1, n + 1, dtype=torch.int32, device=device),
                       size_mid, size_low, n)
    out = torch.zeros((n + 2, size_low), dtype=torch.float32, device=device)
    return out.scatter_add_(1, idx.to(torch.int64), tap_footprint(idx, w).to(torch.float32))


def _nonfinite_points(v, m, iy, ix, geom, out_hw, ch):
    """One scale's point values ``v`` (B, L, P, 2) under the non-finite
    contract of ``decode.scalespace``: per (image, channel) of the
    (B, Hl, Wl, C) map ``m``, the census of its non-finite entries and
    whether the low-res rows (columns) that hold them all lie in a
    coordinate's footprint, looked up at the points (B, L, P)."""
    b, hl, wl, c = m.shape
    code, rows, cols = census(m)
    img = torch.arange(b, device=m.device).view(b, 1, 1, 1)
    at = img * c + ch                                          # (B, L, 1, 2)
    inside = None
    for q, n, mid, low, lines, axis in ((iy, out_hw[0], geom[0], hl, rows, -3),
                                        (ix, out_hw[1], geom[1], wl, cols, -2)):
        # (B, n + 2, C) in either layout: a coordinate's footprint holds them
        ok = holds(_footprints(n, mid, low, m.device), lines, axis).reshape(-1)
        line = (torch.clamp(q, -1, n) + 1).to(torch.int64)[..., None]
        ok = ok[(img * (n + 2) + line) * c + ch]
        inside = ok if inside is None else inside & ok
    code = code.reshape(-1)[at]
    return torch.where(code == 0, v, line_classes(code, inside))


def sample_avg_plain(space, iy, ix, chans):
    """Gather formulation of the readout, in torch (see ``sample_avg``),
    with the non-finite contract of ``decode.scalespace``."""
    out_h, out_w = space.out_hw
    b, groups = iy.shape[:2]
    shape = iy.shape
    iyf = iy.reshape(b, groups, -1)
    ixf = ix.reshape(b, groups, -1)
    acc = None
    for m, (rh, rw) in zip(space.maps, space.geoms):
        hl, wl, c = m.shape[-3:]
        m32 = m.to(torch.float32)
        flat = m32.reshape(-1)
        y_idx, y_w = axis_taps(iyf, rh, hl, out_h)
        x_idx, x_w = axis_taps(ixf, rw, wl, out_w)
        base = torch.arange(b, device=m.device).view(b, 1, 1) * (hl * wl)
        ch = chans.to(m.device).view(1, groups, 1, 2).to(torch.int64)
        v = None
        for a in range(4):
            r = None
            for e in range(4):
                pix = base + y_idx[..., a].to(torch.int64) * wl + x_idx[..., e]
                val = flat[pix[..., None] * c + ch]           # (B, L, P, 2)
                term = x_w[..., e, None] * val
                r = term if r is None else r + term
            term = y_w[..., a, None] * r
            v = term if v is None else v + term
        v = _nonfinite_points(v, m32, iyf, ixf, (rh, rw), space.out_hw, ch)
        acc = v if acc is None else acc + v
    return (acc / float(len(space.maps))).reshape(*shape, 2)


def _space(maps, geoms: list[int], out_h: int, out_w: int):
    """The ScaleSpace of an operator's arguments (``geoms`` flat: rh, rw per scale)."""
    return ScaleSpace(maps, list(zip(geoms[::2], geoms[1::2])), (out_h, out_w))


@torch.library.custom_op("tpupose_torch::sample_avg", mutates_args=(), device_types="cpu")
def _sample_op(maps: list[torch.Tensor], geoms: list[int], out_h: int, out_w: int,
               iy: torch.Tensor, ix: torch.Tensor, chans: list[int]) -> torch.Tensor:
    pairs = torch.tensor(chans, dtype=torch.int32).reshape(-1, 2)
    return sample_avg_plain(_space(maps, geoms, out_h, out_w), iy, ix, pairs).contiguous()


def launch_params(space, iy: torch.Tensor, ix: torch.Tensor, chans: list[int]):
    """The kernel's parameters for CUDA tensors: (params, output, the tensors
    they point into, which the caller keeps alive until the launch is
    enqueued)."""
    dev = iy.device
    b = iy.shape[0]
    maps = [m.to(torch.float32).contiguous() for m in space.maps]
    iyc = iy.to(torch.int32).contiguous()
    ixc = ix.to(torch.int32).contiguous()
    ch = _device_chans(chans, dev)
    out = torch.empty((*iy.shape, 2), dtype=torch.float32, device=dev)
    p = _Params()
    p.n_scales = len(maps)
    p.batch = b
    p.groups = iy.shape[1]
    p.out_h, p.out_w = space.out_hw
    p.points = iy[0, 0].numel()
    for s, m in enumerate(maps):
        p.hl[s], p.wl[s], p.cstride[s] = m.shape[1], m.shape[2], m.shape[3]
        p.maps[s] = m.data_ptr()
    p.iy, p.ix, p.chans, p.out = (iyc.data_ptr(), ixc.data_ptr(),
                                  ch.data_ptr(), out.data_ptr())
    # one 8-byte load per tap where every pair is two neighbouring channels
    # at an 8-byte aligned offset, chosen here once per launch
    firsts, seconds = chans[::2], chans[1::2]
    p.paired = int(all(c0 % 2 == 0 and c1 == c0 + 1 for c0, c1 in zip(firsts, seconds))
                   and all(m.shape[3] % 2 == 0 and m.data_ptr() % 8 == 0 for m in maps))
    tap_w, tap_i = _device_tap_table(space, dev)
    p.tap_w, p.tap_i = tap_w.data_ptr(), tap_i.data_ptr()
    # the direct variant's census words, written by its census kernel
    p.census_words = census_words([m.shape[1:3] for m in maps])
    p.channels = max(m.shape[3] for m in maps)
    p.census_chunks = census_chunks([m.shape[1] for m in maps])
    census = torch.empty((b, p.census_chunks, p.channels), dtype=torch.int32, device=dev)
    p.census = census.data_ptr()
    return p, out, (maps, iyc, ixc, census)


@_sample_op.register_kernel("cuda")
def _sample_cuda(maps, geoms, out_h, out_w, iy, ix, chans):
    p, out, _keep = launch_params(_space(maps, geoms, out_h, out_w), iy, ix, chans)
    if out.numel():
        KERNEL.launch(iy.device, ctypes.byref(p))
    return out


@_sample_op.register_fake
def _sample_fake(maps, geoms, out_h, out_w, iy, ix, chans):
    return iy.new_empty((*iy.shape, 2), dtype=torch.float32)


def sample_avg(space, iy: torch.Tensor, ix: torch.Tensor, chans) -> torch.Tensor:
    """Scale-averaged chained-bilinear readout at integer image points.

    space: ScaleSpace of per-scale (B, Hl, Wl, C) maps. iy/ix: int (B, L,
    *S) points (one outside the image reads as the plain version's clamped
    taps do, the edge pixel's value); chans: (L, 2) channel pair of each group
    l. Returns (B, L, *S, 2) f32: ``mean_s(upsample_to(maps[s]))`` at the
    points, on channels chans[l]. CPU tensors take ``sample_avg_plain``;
    CUDA tensors the kernel: its staged variant where one image's channel
    pair of every scale and the tap table fit a block's shared memory, its
    direct variant otherwise. Both are the operator
    ``tpupose_torch::sample_avg``, which takes the pairs as a flat list of
    ints (a table of the topology, never a traced value).
    """
    if isinstance(chans, torch.Tensor):
        chans = chans.cpu().numpy()
    chans = np.asarray(chans, dtype=np.int64)
    if iy.shape != ix.shape or iy.dim() < 2 or tuple(chans.shape) != (iy.shape[1], 2):
        raise ValueError(f"sample_avg: points {tuple(iy.shape)}/{tuple(ix.shape)}, "
                         f"chans {tuple(chans.shape)}")
    pairs = chans.reshape(-1).tolist()
    b = iy.shape[0]
    for m in space.maps:
        if m.dim() != 4 or m.shape[0] != b:
            raise ValueError(f"sample_avg: map {tuple(m.shape)} for batch {b}")
        if max(pairs) >= m.shape[-1] or min(pairs) < 0:
            raise ValueError("sample_avg: channel index out of range")
    dev = iy.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"sample_avg: unsupported device {dev}")
    if dev.type == "cuda":
        if len(space.maps) > _MAX_SCALES:
            raise ValueError(f"sample_avg: at most {_MAX_SCALES} scales")
        if any(max(m.shape[1:3]) > 32767 for m in space.maps):
            raise ValueError("sample_avg: the tap table holds 16-bit low-res indices")
        if any(m.device != dev for m in space.maps):
            raise ValueError("sample_avg: maps and points on different devices")
    geoms = [v for g in space.geoms for v in g]
    return _sample_op(list(space.maps), geoms, *space.out_hw, iy, ix, pairs)
