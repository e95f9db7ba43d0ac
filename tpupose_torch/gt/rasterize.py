"""Batched on-device GT rasterisation: putGaussianMaps / putVecMaps.

Counterpart of ``tpupose/gt/rasterize.py``. The whole batch rasterises on
the device of its joints, inside the training step:

  * heatmaps: exp(-d^2 / 2 sigma^2) per (person, part) on the stride-8
    grid with the exp(-4.6052) cut-off, max-combined over persons,
    clipped to 1, background = 1 - max(parts);
  * PAFs: per-limb unit vectors painted in a paf_thre-wide band along
    the bone, count-averaged where persons overlap;
  * the miss-mask multiplies into all 57 channels.

Joints are (N, P, 18, 3) = (x, y, v) in input-image pixels; v < 2 means
present. Absent persons are padding rows with v = 2. The work itself is
``ops.gt.create_labels``: the hand-written CUDA kernel for CUDA tensors,
its plain PyTorch version for CPU tensors.
"""

from __future__ import annotations

import torch

from tpupose_torch.config import AugmentConfig, ModelConfig
from tpupose_torch.ops.gt import create_labels  # noqa: F401  (this module's API)


def labels_for_config(joints: torch.Tensor, mask: torch.Tensor, model: ModelConfig,
                      aug: AugmentConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """``create_labels`` with the geometry of a configuration."""
    return create_labels(joints, mask, label_size=model.label_size, stride=model.stride,
                         sigma=aug.sigma, paf_thre=aug.paf_thre)
