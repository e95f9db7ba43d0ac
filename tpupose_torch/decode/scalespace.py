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

Non-finite maps. The reference evaluates these readouts as dense
contractions: the upsample as ``jax.image.resize``'s weight matrices, the
heat chain as einsums over ``chain_matrices``, the PAF point readout as a
weighted one-hot product. There every output takes ``0 * x`` for every
input outside its taps, so a NaN or an inf anywhere in a low-res channel
reaches the whole channel. The port computes the same readouts locally
(interpolation, band tables, gathers) and follows this contract instead
of the dense arithmetic. Take one scale's term of one channel,

    out[y, x] = sum_{h,w} A[y, h] * M[h, w] * B[x, w],

with non-negative weights, and let E be the non-finite entries of M:

  * E empty: ``out`` is the finite value, bit for bit as without the rule;
  * a NaN in E: every output of the term is NaN;
  * otherwise ``out[y, x]`` is +-inf where every entry of E lies in the
    footprint of (y, x) (``A[y, h] != 0`` and ``B[x, w] != 0``) and all of
    E has one sign, and NaN everywhere else.

Terms then add across scales in IEEE arithmetic (NaN absorbs, +inf plus
-inf is NaN). A tap of weight exactly 0 is outside the footprint even
where its index is listed. The footprint is a product set, so E lies in it
exactly where the rows of E lie in A's footprint of y and its columns in
B's of x: ``holds`` counts both with 0/1 matrices, and an output's class
is the sum of its row's and its column's share (``line_classes``) of the
channel's code (``census``). An
axis a term does not contract (a resize to the same size, which
``jax.image.resize`` skips) is a batch axis: the rule then holds per row.
The two resizes of ``ops.image.upsample_to_batch`` follow the rule in
turn (the crop between them changes nothing); ``ops.sample`` and
``ops.pyramid_peaks`` follow it in their plain versions and kernels, each
with a census of the non-finite entries per (image, channel, scale) that
leaves the finite path as it was.
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


def census(m: torch.Tensor):
    """The non-finite entries of a (..., H, W, C) map as codes that add as
    the contract's classes do: per channel (..., 1, 1, C) -0.0 where it holds
    none, +inf or -inf where all it holds are of that sign, NaN where it
    holds a NaN or both signs (the sum of its non-finite entries); and the
    rows (..., H, 1, C) and columns (..., 1, W, C) that hold one, as 0/1
    f32."""
    marked = torch.where(torch.isfinite(m), torch.zeros_like(m), m)
    rows = marked.sum(dim=-2, keepdim=True)
    code = rows.sum(dim=-3, keepdim=True)
    # a sum of zeros is +0.0, and x + 0.0 is not x for x = -0.0
    code = torch.where(code == 0, torch.full_like(code, -0.0), code)
    return (code, (rows != 0).to(torch.float32),
            (marked.sum(dim=-3, keepdim=True) != 0).to(torch.float32))


def holds(support: torch.Tensor, lines: torch.Tensor, axis: int) -> torch.Tensor:
    """Whether each output's footprint along ``axis`` (-3 rows, -2 columns)
    holds every marked line: ``support`` (n_out, n_in) 0/1, ``lines`` 0/1
    along ``axis`` -> bool with that axis n_out long. A 0/1 product counts
    the marked lines each output reaches; the rule needs all of them (with
    none marked, every output holds them)."""
    reached = torch.movedim(torch.tensordot(support, torch.movedim(lines, axis, 0), dims=1),
                            0, axis)
    return reached == lines.sum(dim=axis, keepdim=True)


def line_classes(code: torch.Tensor, held: torch.Tensor) -> torch.Tensor:
    """One axis's share of the contract's classes: the channel's ``code``
    where ``held`` (for a channel without a non-finite entry, -0.0, a term
    that adds nothing, whatever the value), NaN elsewhere. A row's share
    plus a column's is the output's class: NaN absorbs, and two infinities
    of one sign stay one."""
    return torch.where(held, code, torch.full_like(code, torch.nan))


def tap_footprint(idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., 4) taps of a point along one axis (``ops.sample.axis_taps``)
    -> (..., 4) bool: the taps that make up its footprint, each listed
    index once (at its first tap) and only where its summed weight, the
    entry of the reference's weighted one-hot row, is non-zero."""
    same = idx[..., :, None] == idx[..., None, :]
    nonzero = (same & (w[..., None, :] != 0)).any(dim=-1)
    earlier = torch.ones((4, 4), dtype=torch.bool, device=idx.device).tril(-1)
    return nonzero & ~(same & earlier).any(dim=-1)


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
