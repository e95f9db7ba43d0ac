"""Peak scores of materialised heatmaps: blur + NMS + threshold, fused.

Counterpart of ``tpupose/ops/pallas_peaks.py``. ``peak_scores`` launches
``csrc/peaks.cu`` for CUDA tensors and runs ``peak_scores_plain`` for CPU
tensors. The plain version fixes the arithmetic the kernel follows:
horizontal pass, then vertical pass, taps in index order, each tap a
separately rounded multiply and add — so the two agree bit for bit on
one device, and the ``>=`` of the NMS falls the same way in both. Both are
the registered operator ``tpupose_torch::peak_scores``.
"""

from __future__ import annotations

import ctypes

import torch

from tpupose_torch.decode.peaks import (
    gaussian_kernel1d, scan_tables, symmetric_index, tap_pass,
)
from tpupose_torch.ops._build import CudaKernel
from tpupose_torch.skeletons import COCO18, Skeleton

_MAX_TAPS = 128
_SMEM_LIMIT = 227 * 1024
# csrc/peaks.cu: kMaxRadius, kWarps, kGenWarps, kCols, kBandRows, kRing (a card
# test holds smem_bytes to the kernel's own count)
_MAX_RADIUS, _WARPS, _GEN_WARPS, _COLS, _BAND_ROWS, _RING = 16, 18, 6, 64, 46, 16


class _Params(ctypes.Structure):
    _fields_ = [
        ("batch", ctypes.c_int), ("h", ctypes.c_int), ("w", ctypes.c_int),
        ("cstride", ctypes.c_int), ("parts", ctypes.c_int), ("radius", ctypes.c_int),
        ("thre1", ctypes.c_float), ("taps", ctypes.c_float * _MAX_TAPS),
        ("maps", ctypes.c_void_p), ("out", ctypes.c_void_p),
    ]


KERNEL = CudaKernel(
    "peaks", "tp_peaks", [ctypes.POINTER(_Params), ctypes.c_void_p],
    replaces="tpupose/ops/pallas_peaks.py:73",
)


def smem_bytes(radius: int) -> int:
    """Shared memory the kernel asks for at a blur radius: a ring of input
    rows (each channel's row padded to 2 mod 32 floats) of 18 channels up
    to radius 16; beyond, the generic path's ring of 6 channels, each
    thread's 2r + 1 horizontal results (two columns) and the taps. Raises
    ``ValueError`` where that is more than a block of the H100 may hold
    (radius 51 and up, sigma 12.625 and up)."""
    if radius < 0:
        raise ValueError(f"peak_scores: blur radius {radius}")
    pitch = (_COLS + 2 * radius - 2 + 31) // 32 * 32 + 2
    if radius <= _MAX_RADIUS:
        return 4 * _RING * _WARPS * pitch
    need = 4 * (_RING * _GEN_WARPS * pitch + (2 * radius + 1) * (2 * 32 * _GEN_WARPS + 1))
    if need > _SMEM_LIMIT:
        raise ValueError(f"peak_scores: blur radius {radius} needs {need} bytes of shared "
                         f"memory a block for its rings, more than {_SMEM_LIMIT}")
    return need


def peak_scores_plain(maps: torch.Tensor, parts: int = 18, sigma: float = 3.0,
                      thre1: float = 0.1) -> torch.Tensor:
    """``peak_scores`` in plain PyTorch ops, in the kernel's arithmetic."""
    taps = gaussian_kernel1d(sigma)
    r = (len(taps) - 1) // 2
    b, h, w = maps.shape[:3]
    x = maps[..., :parts].to(torch.float32).permute(0, 3, 1, 2)          # (B, C, H, W)
    xp = x.index_select(2, symmetric_index(h, r, x.device))
    xp = xp.index_select(3, symmetric_index(w, r, x.device))
    smooth = tap_pass(tap_pass(xp, taps, 3), taps, 2)                     # (B, C, H, W)
    pad = torch.nn.functional.pad(smooth, (1, 1, 1, 1))                   # zero border
    is_peak = (
        (smooth >= pad[..., :-2, 1:-1])
        & (smooth >= pad[..., 2:, 1:-1])
        & (smooth >= pad[..., 1:-1, :-2])
        & (smooth >= pad[..., 1:-1, 2:])
        & (smooth > torch.tensor(thre1, dtype=torch.float32, device=x.device))
    )
    scores = torch.where(is_peak, x, torch.full_like(x, -torch.inf))
    return scores.reshape(b, parts, h * w)


@torch.library.custom_op("tpupose_torch::peak_scores", mutates_args=(), device_types="cpu")
def _peaks_op(maps: torch.Tensor, parts: int, sigma: float, thre1: float) -> torch.Tensor:
    return peak_scores_plain(maps, parts, sigma, thre1).contiguous()


@_peaks_op.register_kernel("cuda")
def _peaks_cuda(maps, parts, sigma, thre1):
    dev = maps.device
    taps = gaussian_kernel1d(sigma)
    r = (len(taps) - 1) // 2
    smem_bytes(r)
    b, h, w, c = maps.shape
    if b > 65535 or -(-h // _BAND_ROWS) > 65535:
        raise ValueError(f"peak_scores: maps {tuple(maps.shape)} exceed the kernel's grid")
    x = maps.detach().to(torch.float32).contiguous()
    out = torch.empty((b, parts, h * w), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    p = _Params()
    p.batch, p.h, p.w, p.cstride, p.parts, p.radius = b, h, w, c, parts, r
    p.thre1 = thre1
    p.taps[: len(taps)] = [float(t) for t in taps]
    p.maps, p.out = x.data_ptr(), out.data_ptr()
    KERNEL.launch(dev, ctypes.byref(p))
    return out


@_peaks_op.register_fake
def _peaks_fake(maps, parts, sigma, thre1):
    b, h, w, _ = maps.shape
    return maps.new_empty((b, parts, h * w), dtype=torch.float32)


def peak_scores(maps: torch.Tensor, parts: int = 18, sigma: float = 3.0,
                thre1: float = 0.1) -> torch.Tensor:
    """Materialised heatmaps -> (B, parts, H*W) masked peak scores.

    maps: (B, H, W, C) with C >= ``parts`` (further channels are
    ignored). Per channel: smooth = the map's sigma-blur (separable,
    borders repeat the edge sample); peaks are smooth >= its 4 neighbours
    (zero outside) and smooth > thre1. The output holds the unblurred map
    at peaks and -inf elsewhere. CPU tensors take ``peak_scores_plain``;
    CUDA tensors the kernel. Both are the operator
    ``tpupose_torch::peak_scores``.
    """
    if maps.dim() != 4 or maps.shape[-1] < parts or parts < 1:
        raise ValueError(f"peak_scores: maps {tuple(maps.shape)}, want (B, H, W, C >= {parts})")
    if maps.device.type not in ("cpu", "cuda"):
        raise ValueError(f"peak_scores: unsupported device {maps.device}")
    return _peaks_op(maps, parts, float(sigma), float(thre1))


def find_peaks_kernel(heatmap: torch.Tensor, max_peaks: int = 96, sigma: float = 3.0,
                      thre1: float = 0.1, skeleton: Skeleton = COCO18) -> dict[str, torch.Tensor]:
    """Drop-in for ``decode.peaks.find_peaks`` backed by ``peak_scores``:
    (H, W, 19) averaged heatmap -> scan-order (18, K) tables (COCO-18)."""
    flat = peak_scores(heatmap[None], skeleton.num_parts, sigma, thre1)[0]
    return scan_tables(flat, heatmap.shape[1], max_peaks)
