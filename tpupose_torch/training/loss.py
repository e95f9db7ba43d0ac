"""Stage-wise masked L2 training losses.

Counterpart of ``tpupose/training/loss.py``: every one of the 12 heads
(6 stages x {PAF, heatmap}) contributes
``eucl_loss = sum((pred - gt)^2) / batch / 2``, where both prediction and
ground truth are multiplied by the per-pixel miss-mask (predictions here,
the ground truth already in the GT path). Sums accumulate in f32; a head
in a narrower type is promoted first.
"""

from __future__ import annotations

import torch


def _f32_at_least(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def eucl_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
              denom: int | None = None) -> torch.Tensor:
    """sum((m*pred - m*gt)^2) / N / 2 for one head.

    pred/gt: (N, L, L, C); mask: (N, L, L) in [0, 1]. ``denom`` overrides
    the batch-size divisor — used when a batch is padded (padded rows
    carry a zero mask, so only the divisor must track the real count).
    """
    n = denom if denom is not None else pred.shape[0]
    d = (_f32_at_least(pred) - _f32_at_least(gt)) * mask[..., None]
    return torch.sum(torch.square(d)) / n / 2.0


def stagewise_losses(outputs, paf_gt: torch.Tensor, heat_gt: torch.Tensor,
                     mask: torch.Tensor, denom: int | None = None) -> dict[str, torch.Tensor]:
    """Per-head loss dict + total over the list of per-stage (paf, heat).

    ``paf_gt``/``heat_gt`` are already mask-multiplied (GT path
    semantics); the mask is applied to predictions here.
    """
    losses: dict[str, torch.Tensor] = {}
    total = 0.0
    m = mask.to(torch.float32)[..., None]
    ones = torch.ones_like(mask, dtype=torch.float32)
    for t, (paf, heat) in enumerate(outputs, start=1):
        lp = eucl_loss(_f32_at_least(paf) * m, paf_gt, ones, denom)
        lh = eucl_loss(_f32_at_least(heat) * m, heat_gt, ones, denom)
        losses[f"stage{t}_L1"] = lp
        losses[f"stage{t}_L2"] = lh
        total = total + lp + lh
    losses["total"] = total
    return losses
