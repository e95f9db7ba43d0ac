"""Gaussian blur, peak NMS masks and fixed-capacity peak tables.

Counterpart of ``tpupose/decode/peaks.py``: ``gaussian_blur`` and
``find_peaks`` on a materialised map (the oracle of the fused kernel
``ops/peaks.py``), ``masked_scores``, and the table building. One
full-capacity path: the reference's compaction tiers are bit-identical
to it by construction.

Slots hold peaks in row-major scan order (the reference's ``np.nonzero``
order). ``scan_tables`` keeps the first ``max_peaks`` of a row that holds
more (the reference's ``peak_tables``); ``peak_tables`` is the decode's
guarded form (the reference's ``peak_tables_tiered``): when ANY row of
the whole call holds more than ``max_peaks`` peaks, every row switches to
score-descending order, with ties — including the ``-inf`` filler —
lowest index first and NaN last, as ``lax.top_k`` orders them.
"""

from __future__ import annotations

import numpy as np
import torch

from tpupose_torch.skeletons import COCO18, Skeleton
from tpupose_torch.utils.profiling import annotate, count


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage-compatible 1D gaussian (normalised, radius=trunc*sigma)."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def symmetric_index(n: int, r: int, device=None) -> torch.Tensor:
    """Source indices of an axis of length ``n`` padded by ``r`` on both
    sides with the edge sample repeated (``jnp.pad(mode="symmetric")``,
    scipy ``reflect``: d c b a | a b c d | d c b a). Folds as often as a
    map narrower than ``r`` needs."""
    j = torch.arange(-r, n + r, device=device) % (2 * n)
    return torch.where(j < n, j, 2 * n - 1 - j)


def tap_pass(x: torch.Tensor, taps: np.ndarray, dim: int) -> torch.Tensor:
    """Valid correlation of ``x`` with ``taps`` along ``dim``, accumulated
    in tap order 0..T-1 with a separately rounded multiply and add per
    tap (no fused multiply-add on any device)."""
    n = x.shape[dim] - len(taps) + 1
    acc = float(taps[0]) * x.narrow(dim, 0, n)
    for k in range(1, len(taps)):
        acc = acc + float(taps[k]) * x.narrow(dim, k, n)
    return acc


def gaussian_blur(maps: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable gaussian over (..., H, W, C) with scipy 'reflect' borders,
    vertical pass first, as the reference's oracle convolves."""
    taps = gaussian_kernel1d(sigma)
    r = (len(taps) - 1) // 2
    h, w = maps.shape[-3], maps.shape[-2]
    x = maps.to(torch.float32)
    x = x.index_select(-3, symmetric_index(h, r, x.device))
    x = x.index_select(-2, symmetric_index(w, r, x.device))
    return tap_pass(tap_pass(x, taps, -3), taps, -2)


def masked_scores(parts: torch.Tensor, smooth: torch.Tensor, thre1: float) -> torch.Tensor:
    """4-neighbour local-max NMS (zero outside) + threshold.

    parts/smooth: (..., H, W, C) averaged map and its blur. Returns
    (..., C, H*W): ``parts`` at peaks, -inf elsewhere.
    """
    h, w, c = parts.shape[-3:]
    pad = torch.nn.functional.pad(smooth, (0, 0, 1, 1, 1, 1))   # zero border
    is_peak = (
        (smooth >= pad[..., :-2, 1:-1, :])      # row above
        & (smooth >= pad[..., 2:, 1:-1, :])     # row below
        & (smooth >= pad[..., 1:-1, :-2, :])    # column left
        & (smooth >= pad[..., 1:-1, 2:, :])     # column right
        & (smooth > thre1)
    )
    scores = torch.where(is_peak, parts, torch.full_like(parts, -torch.inf))
    return scores.reshape(*parts.shape[:-3], h * w, c).transpose(-1, -2)


def overflowed(flat: torch.Tensor, max_peaks: int) -> torch.Tensor:
    """Whether any row of the (R, N) masked scores holds more than
    ``max_peaks`` peaks: a 0-d bool tensor on their device (no sync)."""
    return (torch.isfinite(flat).sum(dim=-1) > max_peaks).any()


def peak_tables(flat: torch.Tensor, w: int, max_peaks: int,
                overflow: bool | None = None) -> dict[str, torch.Tensor]:
    """(R, N) masked scores (-inf off-peak) -> (R, K) peak tables.

    Returns xs/ys int32, scores f32 (0 in empty slots) and valid bool.
    The overflow decision is global over the R rows (one host sync, the
    span ``decode.overflow_switch``), or ``overflow`` when the caller
    decided it over a larger batch; the counters ``decode.tables.sorted``
    and ``decode.tables.scan`` count the orders taken. Under
    ``torch.export`` the decision stays on the device: both orders are in
    the program, as the two branches of a ``torch.cond``.
    """
    k = max_peaks
    if overflow is None:
        overflow = overflowed(flat, k)
        if torch.compiler.is_exporting():
            out = torch.cond(overflow, lambda f: _tuple(sorted_tables(f, w, k)),
                             lambda f: _tuple(scan_tables(f, w, k)), (flat,))
            return dict(zip(TABLE_KEYS, out))
        with annotate("decode.overflow_switch"):
            overflow = bool(overflow)
    count("decode.tables.sorted" if overflow else "decode.tables.scan")
    return sorted_tables(flat, w, k) if overflow else scan_tables(flat, w, k)


TABLE_KEYS = ("xs", "ys", "scores", "valid")


def _tuple(tables: dict[str, torch.Tensor]) -> tuple[torch.Tensor, ...]:
    return tuple(tables[key] for key in TABLE_KEYS)


def sorted_tables(flat: torch.Tensor, w: int, max_peaks: int) -> dict[str, torch.Tensor]:
    """``peak_tables`` in score-descending order whatever the counts, ties
    lowest index first, and a NaN score below -inf: the order
    ``lax.top_k`` gives on the reference's CPU, which ranks floats by their
    bits and puts the NaN that ``0 * inf`` makes there (sign bit set) last.
    A NaN at a peak only arises so (a peak needs a blurred value that is
    not NaN, so its map holds no NaN, only an inf), and it ranks last here
    whatever its bits, on every device. The operator of ``ops/peak_tables``:
    ``sorted_tables_plain`` for a CPU tensor, its CUDA kernel for a CUDA
    one."""
    # imported here: the kernel's module imports this one for its plain version
    from tpupose_torch.ops import peak_tables as _tables_op

    return _tables_op.peak_tables(flat, w, max_peaks)


def sorted_tables_plain(flat: torch.Tensor, w: int, max_peaks: int) -> dict[str, torch.Tensor]:
    """``sorted_tables`` in plain PyTorch ops. The sort key is f64, where
    -inf of the scores becomes the least finite f64 and NaN -inf; a stable
    sort keeps equal keys (+0.0 and -0.0 among them) in index order."""
    key = flat.to(torch.float64)
    key = torch.where(torch.isneginf(key), torch.finfo(torch.float64).min, key)
    key = torch.where(torch.isnan(key), -torch.inf, key)
    _, idx = torch.sort(key, dim=-1, descending=True, stable=True)
    idx = idx[:, :max_peaks]
    top = torch.gather(flat, -1, idx)
    ok = torch.isfinite(top)
    return {
        "xs": (idx % w).to(torch.int32),
        "ys": (idx // w).to(torch.int32),
        "scores": torch.where(ok, top, torch.zeros_like(top)),
        "valid": ok,
    }


def scan_tables(flat: torch.Tensor, w: int, max_peaks: int) -> dict[str, torch.Tensor]:
    """``peak_tables`` in scan order whatever the counts: a row holding
    more than ``max_peaks`` peaks keeps its first ``max_peaks``."""
    r, n = flat.shape
    k = max_peaks
    valid = torch.isfinite(flat)
    count = valid.sum(dim=-1)
    # the i-th peak of a row goes to slot i; the rest of the row's pixels
    # (and its peaks beyond the capacity) scatter into one discarded
    # trailing slot
    slot = torch.cumsum(valid, dim=-1) - 1
    rows = torch.arange(r, device=flat.device)[:, None]
    target = torch.where(valid & (slot < k), rows * k + slot, r * k).reshape(-1)
    lin = torch.arange(n, device=flat.device).expand(r, n).reshape(-1)
    pos = torch.zeros(r * k + 1, dtype=torch.int64, device=flat.device)
    pos.scatter_(0, target, lin)
    sc = torch.zeros(r * k + 1, dtype=flat.dtype, device=flat.device)
    sc.scatter_(0, target, torch.where(valid, flat, torch.zeros_like(flat)).reshape(-1))
    ok = torch.arange(k, device=flat.device)[None, :] < count[:, None]
    pos = torch.where(ok, pos[:-1].reshape(r, k), 0)
    return {
        "xs": (pos % w).to(torch.int32),
        "ys": (pos // w).to(torch.int32),
        "scores": torch.where(ok, sc[:-1].reshape(r, k), 0.0),
        "valid": ok,
    }


def nms_tables(parts: torch.Tensor, smooth: torch.Tensor, max_peaks: int,
               thre1: float) -> dict[str, torch.Tensor]:
    """4-neighbour local-max NMS + threshold of one (H, W, C) map ->
    scan-order (C, K) tables."""
    return scan_tables(masked_scores(parts, smooth, thre1), parts.shape[1], max_peaks)


def find_peaks(heatmap: torch.Tensor, max_peaks: int = 96, sigma: float = 3.0,
               thre1: float = 0.1, skeleton: Skeleton = COCO18) -> dict[str, torch.Tensor]:
    """(H, W, 19) averaged heatmap -> (18, K) peak tables (COCO-18; the
    skeleton's parts): xs/ys int32, scores f32 (the unsmoothed map's
    values), valid bool, in row-major scan order."""
    parts = heatmap[:, :, : skeleton.num_parts].to(torch.float32)
    return nms_tables(parts, gaussian_blur(parts, sigma), max_peaks, thre1)
