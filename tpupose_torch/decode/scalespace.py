"""Scale-space readout: the per-scale low-res network outputs, never
upsampled.

Counterpart of ``tpupose/decode/scalespace.py``. The scale-averaged
full-res maps the reference decode reads are linear in the low-res maps:
per axis, the x8 bilinear upsample -> crop -> bilinear resize chain
(``ops.image.upsample_to`` in the reference) is a constant matrix, and so
is the sigma=3 reflect-border blur. The peaks stage therefore needs only
small per-scale matrix products (``pyramid_heat_maps``, or the fused
kernel ``ops/pyramid_peaks.py``), and the PAF line integral evaluates
the chained interpolant at its integer sample points directly
(``sample_avg``, kernel ``ops/sample.py``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from tpupose_torch.decode.peaks import gaussian_kernel1d


class ScaleSpace:
    """Per-scale low-res maps + static resize geometry.

    ``maps``: one tensor per pyramid scale, (Hl, Wl, C) or batched
    (B, Hl, Wl, C), where (Hl, Wl) is the PADDED network-output grid.
    ``geoms``: matching (rh, rw) — the pre-pad resize size each scale's
    x8 upsample is cropped to. ``out_hw``: the image size the decode's
    coordinates live in.
    """

    def __init__(self, maps, geoms, out_hw):
        self.maps = tuple(maps)
        self.geoms = tuple(tuple(int(v) for v in g) for g in geoms)
        self.out_hw = tuple(int(v) for v in out_hw)
        if len(self.maps) != len(self.geoms):
            raise ValueError("one (rh, rw) geom per scale map")

    def map_scales(self, fn) -> "ScaleSpace":
        """Apply ``fn`` to every scale's map, keeping the geometry."""
        return ScaleSpace([fn(m) for m in self.maps], self.geoms, self.out_hw)


def _linear_resize_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) weights of a half-pixel-centre 2-tap linear resize
    (clamped edge taps accumulate)."""
    m = np.zeros((n_out, n_in), np.float64)
    scale = n_in / n_out
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        j0 = int(np.floor(src))
        f = src - j0
        m[i, min(max(j0, 0), n_in - 1)] += 1.0 - f
        m[i, min(max(j0 + 1, 0), n_in - 1)] += f
    return m


def resize_chain_matrix(size_low: int, rh: int, out_size: int,
                        stride: int = 8) -> np.ndarray:
    """(out_size, size_low) f32 matrix of the upsample chain along one
    axis: x``stride`` bilinear -> crop to ``rh`` -> bilinear to
    ``out_size``."""
    w1 = _linear_resize_matrix(size_low * stride, size_low)[:rh]
    w2 = _linear_resize_matrix(out_size, rh)
    return np.asarray(w2 @ w1, np.float32)


def gaussian_reflect_matrix(size: int, sigma: float) -> np.ndarray:
    """(size, size) f32 matrix of the scipy-'reflect' gaussian blur along
    one axis (d c b a | a b c d | d c b a)."""
    k = gaussian_kernel1d(sigma).astype(np.float64)
    r = (len(k) - 1) // 2
    m = np.zeros((size, size), np.float64)
    for i in range(size):
        for t in range(-r, r + 1):
            j = i + t
            while j < 0 or j >= size:
                if j < 0:
                    j = -1 - j
                if j >= size:
                    j = 2 * size - 1 - j
            m[i, j] += k[t + r]
    return m.astype(np.float32)


@lru_cache(maxsize=64)
def chain_matrices(sizes: tuple, out_hw: tuple, sigma: float) -> tuple:
    """Per scale (Wy, Wx, G@Wy, G@Wx) as f32 numpy arrays, built exactly
    as the reference builds them. ``sizes``: ((hl, wl, rh, rw), ...)."""
    out_h, out_w = out_hw
    gy = gaussian_reflect_matrix(out_h, sigma)
    gx = gaussian_reflect_matrix(out_w, sigma)
    mats = []
    for hl, wl, rh, rw in sizes:
        wy = resize_chain_matrix(hl, rh, out_h)
        wx = resize_chain_matrix(wl, rw, out_w)
        mats.append((wy, wx, gy @ wy, gx @ wx))
    return tuple(mats)


def scale_shapes(space: ScaleSpace) -> tuple:
    """((hl, wl, rh, rw), ...) of a ScaleSpace."""
    return tuple(
        (m.shape[-3], m.shape[-2], rh, rw)
        for m, (rh, rw) in zip(space.maps, space.geoms)
    )


def pyramid_heat_maps(space: ScaleSpace, sigma: float):
    """(averaged, blurred-averaged) full-res maps from per-scale low-res:

        avg  = sum_s  Wy_s @ M_s @ Wx_s^T / n
        blur = sum_s (G @ Wy_s) @ M_s @ (G @ Wx_s)^T / n

    f32 products (TF32 must be off on CUDA). Accepts (Hl, Wl, C) or
    batched (B, Hl, Wl, C) maps; returns (..., H, W, C).
    """
    n = float(len(space.maps))
    mats = chain_matrices(scale_shapes(space), space.out_hw, float(sigma))
    avg = None
    blur = None
    for m, (wy, wx, ay, bx) in zip(space.maps, mats):
        m32 = m.to(torch.float32)

        def apply(left, right, x=m32):
            left = torch.from_numpy(left).to(x.device)
            right = torch.from_numpy(right).to(x.device)
            t = torch.einsum("yh,...hwc->...ywc", left, x)
            return torch.einsum("...ywc,xw->...yxc", t, right)

        a = apply(wy, wx) / n
        b = apply(ay, bx) / n
        avg = a if avg is None else avg + a
        blur = b if blur is None else blur + b
    return avg, blur
