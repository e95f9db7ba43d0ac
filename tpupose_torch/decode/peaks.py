"""Peak NMS masks and fixed-capacity peak tables.

Counterpart of ``tpupose/decode/peaks.py`` (``masked_scores`` and the
table building of ``peak_tables_tiered``). One full-capacity path: the
reference's compaction tiers are bit-identical to it by construction.

Slots hold peaks in row-major scan order (the reference's ``np.nonzero``
order). When ANY row of the whole call holds more than ``max_peaks``
peaks, every row switches to score-descending order (the reference's
overflow guard), with ties — including the ``-inf`` filler — lowest index
first, as ``lax.top_k`` orders them.
"""

from __future__ import annotations

import numpy as np
import torch


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage-compatible 1D gaussian (normalised, radius=trunc*sigma)."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


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


def peak_tables(flat: torch.Tensor, w: int, max_peaks: int) -> dict[str, torch.Tensor]:
    """(R, N) masked scores (-inf off-peak) -> (R, K) peak tables.

    Returns xs/ys int32, scores f32 (0 in empty slots) and valid bool.
    The overflow decision is global over the R rows (one host sync).
    """
    r, n = flat.shape
    k = max_peaks
    valid = torch.isfinite(flat)
    count = valid.sum(dim=-1)
    if bool((count > k).any()):
        top, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
        top, idx = top[:, :k], idx[:, :k]
        ok = torch.isfinite(top)
        return {
            "xs": (idx % w).to(torch.int32),
            "ys": (idx // w).to(torch.int32),
            "scores": torch.where(ok, top, torch.zeros_like(top)),
            "valid": ok,
        }
    # scan order: the i-th peak of a row goes to slot i; the rest of the
    # row's pixels scatter into one discarded trailing slot
    slot = torch.cumsum(valid, dim=-1) - 1
    rows = torch.arange(r, device=flat.device)[:, None]
    target = torch.where(valid, rows * k + slot, r * k).reshape(-1)
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
