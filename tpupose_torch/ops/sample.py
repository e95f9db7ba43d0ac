"""Scale-space point readout of the PAF line integral.

Counterpart of ``tpupose/ops/pallas_sample.py`` (the readout contract of
``scalespace.sample_avg``). ``sample_avg`` launches ``csrc/sample.cu``
for CUDA tensors and runs ``sample_avg_plain`` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from tpupose_torch.ops._build import CudaKernel

_MAX_SCALES = 8
_STRIDE = 8


class _Params(ctypes.Structure):
    _fields_ = [
        ("n_scales", ctypes.c_int), ("batch", ctypes.c_int),
        ("groups", ctypes.c_int), ("out_h", ctypes.c_int),
        ("out_w", ctypes.c_int), ("points", ctypes.c_longlong),
        ("hl", ctypes.c_int * _MAX_SCALES), ("wl", ctypes.c_int * _MAX_SCALES),
        ("rh", ctypes.c_int * _MAX_SCALES), ("rw", ctypes.c_int * _MAX_SCALES),
        ("cstride", ctypes.c_int * _MAX_SCALES),
        ("sy", ctypes.c_float * _MAX_SCALES), ("sx", ctypes.c_float * _MAX_SCALES),
        ("maps", ctypes.c_void_p * _MAX_SCALES),
        ("iy", ctypes.c_void_p), ("ix", ctypes.c_void_p),
        ("chans", ctypes.c_void_p), ("out", ctypes.c_void_p),
    ]


KERNEL = CudaKernel(
    "sample", "tp_sample", [ctypes.POINTER(_Params), ctypes.c_void_p],
    replaces="tpupose/ops/pallas_sample.py:130",
)


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


def sample_avg_plain(space, iy, ix, chans):
    """Gather formulation of the readout, in torch (see ``sample_avg``)."""
    out_h, out_w = space.out_hw
    b, groups = iy.shape[:2]
    shape = iy.shape
    iyf = iy.reshape(b, groups, -1)
    ixf = ix.reshape(b, groups, -1)
    acc = None
    for m, (rh, rw) in zip(space.maps, space.geoms):
        hl, wl, c = m.shape[-3:]
        flat = m.to(torch.float32).reshape(-1)
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
        acc = v if acc is None else acc + v
    return (acc / float(len(space.maps))).reshape(*shape, 2)


def sample_avg(space, iy: torch.Tensor, ix: torch.Tensor, chans) -> torch.Tensor:
    """Scale-averaged chained-bilinear readout at integer image points.

    space: ScaleSpace of per-scale (B, Hl, Wl, C) maps. iy/ix: int (B, L,
    *S) points inside the image; chans: (L, 2) channel pair of each group
    l. Returns (B, L, *S, 2) f32: ``mean_s(upsample_to(maps[s]))`` at the
    points, on channels chans[l]. CPU tensors take ``sample_avg_plain``;
    CUDA tensors the kernel.
    """
    chans = torch.as_tensor(chans, dtype=torch.int32, device="cpu")
    if iy.shape != ix.shape or iy.dim() < 2 or tuple(chans.shape) != (iy.shape[1], 2):
        raise ValueError(f"sample_avg: points {tuple(iy.shape)}/{tuple(ix.shape)}, "
                         f"chans {tuple(chans.shape)}")
    b = iy.shape[0]
    for m in space.maps:
        if m.dim() != 4 or m.shape[0] != b:
            raise ValueError(f"sample_avg: map {tuple(m.shape)} for batch {b}")
        if int(chans.max()) >= m.shape[-1] or int(chans.min()) < 0:
            raise ValueError("sample_avg: channel index out of range")
    dev = iy.device
    if dev.type == "cpu":
        return sample_avg_plain(space, iy, ix, chans)
    if dev.type != "cuda":
        raise ValueError(f"sample_avg: unsupported device {dev}")
    if len(space.maps) > _MAX_SCALES:
        raise ValueError(f"sample_avg: at most {_MAX_SCALES} scales")
    maps = [m.to(torch.float32).contiguous() for m in space.maps]
    if any(m.device != dev for m in maps):
        raise ValueError("sample_avg: maps and points on different devices")
    iyc = iy.to(torch.int32).contiguous()
    ixc = ix.to(torch.int32).contiguous()
    ch = chans.to(dev).contiguous()
    out = torch.empty((*iy.shape, 2), dtype=torch.float32, device=dev)
    out_h, out_w = space.out_hw
    p = _Params()
    p.n_scales = len(maps)
    p.batch = b
    p.groups = iy.shape[1]
    p.out_h, p.out_w = out_h, out_w
    p.points = iy[0, 0].numel()
    for s, (m, (rh, rw)) in enumerate(zip(maps, space.geoms)):
        p.hl[s], p.wl[s], p.cstride[s] = m.shape[1], m.shape[2], m.shape[3]
        p.rh[s], p.rw[s] = rh, rw
        p.sy[s] = rh / out_h       # rounded to f32, as the reference's constant
        p.sx[s] = rw / out_w
        p.maps[s] = m.data_ptr()
    p.iy, p.ix, p.chans, p.out = (iyc.data_ptr(), ixc.data_ptr(),
                                  ch.data_ptr(), out.data_ptr())
    if out.numel():
        KERNEL.launch(ctypes.byref(p), torch.cuda.current_stream(dev).cuda_stream)
    return out
