"""Scale-space peak scores: per-scale low-res heatmaps -> masked scores.

Counterpart of ``tpupose/ops/pallas_pyramid_peaks.py``.
``pyramid_peak_scores`` launches ``csrc/pyramid_peaks.cu`` for CUDA
tensors and runs ``pyramid_peak_scores_plain`` —
``scalespace.pyramid_heat_maps`` + ``peaks.masked_scores``, the path the
Pallas kernel replaced — for CPU tensors.
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
_PTRS = ctypes.c_void_p * _MAX_SCALES
_INTS = ctypes.c_int * _MAX_SCALES


class _Params(ctypes.Structure):
    _fields_ = [
        ("n_scales", ctypes.c_int), ("batch", ctypes.c_int),
        ("parts", ctypes.c_int), ("out_h", ctypes.c_int),
        ("out_w", ctypes.c_int),
        ("hl", _INTS), ("wl", _INTS),
        ("maps", _PTRS), ("wy", _PTRS), ("wxt", _PTRS), ("ay", _PTRS),
        ("bxt", _PTRS),
        ("inv_n", ctypes.c_float), ("thre1", ctypes.c_float),
        ("out", ctypes.c_void_p),
    ]


KERNEL = CudaKernel(
    "pyramid_peaks", "tp_pyramid_peaks", [ctypes.POINTER(_Params), ctypes.c_void_p],
    replaces="tpupose/ops/pallas_pyramid_peaks.py:74",
)

# device copies of the constant matrices, per (geometry, sigma, device)
_DEVICE_MATS: dict = {}


def _device_mats(shapes, out_hw, sigma, device):
    key = (shapes, out_hw, sigma, str(device))
    if key not in _DEVICE_MATS:
        mats = []
        for wy, wx, ay, bx in chain_matrices(shapes, out_hw, sigma):
            mats.append(tuple(
                torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
                for a in (wy, wx.T, ay, bx.T)
            ))
        _DEVICE_MATS[key] = mats
    return _DEVICE_MATS[key]


def pyramid_peak_scores_plain(space: ScaleSpace, parts: int, sigma: float,
                              thre1: float) -> torch.Tensor:
    """Matrix-product formulation in torch (see ``pyramid_peak_scores``)."""
    sub = space.map_scales(lambda m: m[..., :parts])
    avg, smooth = pyramid_heat_maps(sub, sigma)
    return masked_scores(avg, smooth, thre1)


def pyramid_peak_scores(space: ScaleSpace, parts: int = 18, sigma: float = 3.0,
                        thre1: float = 0.1) -> torch.Tensor:
    """Per-scale low-res heatmaps -> (B, parts, H*W) masked peak scores.

    space: ScaleSpace of (B, Hl, Wl, C) maps (channels >= ``parts`` are
    ignored). Per channel: avg = scale-averaged chained-bilinear upsample,
    smooth = its sigma-blur (reflect borders); peaks are smooth >= its 4
    neighbours (zero outside) and smooth > thre1. The output holds avg at
    peaks and -inf elsewhere. CPU tensors take the plain version; CUDA
    tensors the kernel.
    """
    maps = space.maps
    b = maps[0].shape[0]
    for m in maps:
        if m.dim() != 4 or m.shape[0] != b or m.shape[-1] < parts:
            raise ValueError(f"pyramid_peak_scores: map {tuple(m.shape)}")
    dev = maps[0].device
    if dev.type == "cpu":
        return pyramid_peak_scores_plain(space, parts, sigma, thre1)
    if dev.type != "cuda":
        raise ValueError(f"pyramid_peak_scores: unsupported device {dev}")
    if len(maps) > _MAX_SCALES:
        raise ValueError(f"pyramid_peak_scores: at most {_MAX_SCALES} scales")
    # channel-major (B, parts, Hl, Wl): each channel's map is contiguous
    maps = [m[..., :parts].to(torch.float32).permute(0, 3, 1, 2).contiguous() for m in maps]
    if any(m.device != dev for m in maps):
        raise ValueError("pyramid_peak_scores: maps on different devices")
    out_h, out_w = space.out_hw
    mats = _device_mats(scale_shapes(space), space.out_hw, float(sigma), dev)
    out = torch.empty((b, parts, out_h * out_w), dtype=torch.float32, device=dev)
    p = _Params()
    p.n_scales, p.batch, p.parts, p.out_h, p.out_w = len(maps), b, parts, out_h, out_w
    for s, (m, (wy, wxt, ay, bxt)) in enumerate(zip(maps, mats)):
        p.hl[s], p.wl[s] = m.shape[2], m.shape[3]
        p.maps[s] = m.data_ptr()
        p.wy[s], p.wxt[s] = wy.data_ptr(), wxt.data_ptr()
        p.ay[s], p.bxt[s] = ay.data_ptr(), bxt.data_ptr()
    p.inv_n = 1.0 / len(maps)
    p.thre1 = thre1
    p.out = out.data_ptr()
    if out.numel():
        KERNEL.launch(ctypes.byref(p), torch.cuda.current_stream(dev).cuda_stream)
    return out
