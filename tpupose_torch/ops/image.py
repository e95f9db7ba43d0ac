"""Image ops: normalise, resize, pad, pyramid geometry.

Counterpart of ``tpupose/ops/image.py``. Tensors are NHWC (or HWC), as
in the reference.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tpupose_torch.config import InferenceConfig, ModelConfig

PAD_NORM = 128.0 / 256.0 - 0.5  # the gray pad value in normalised space (0.0)


def normalize(img: torch.Tensor, channel_order: str = "bgr") -> torch.Tensor:
    """img/256 - 0.5 in f32; ``channel_order`` names the incoming order and
    RGB input is flipped to the BGR the weights expect."""
    if channel_order == "rgb":
        img = img.flip(-1)
    elif channel_order != "bgr":
        raise ValueError(f"unknown channel_order: {channel_order!r}")
    return img.to(torch.float32) / 256.0 - 0.5


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Half-pixel-centre bilinear resize without antialiasing
    (cv2.INTER_LINEAR, ``jax.image.resize(..., "linear", antialias=False)``).
    Works on (H, W, C) or (N, H, W, C); returns a tensor of the same rank.
    """
    x = img[None] if img.dim() == 3 else img
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w), mode="bilinear",
                      align_corners=False, antialias=False)
    y = y.permute(0, 2, 3, 1)
    return y[0] if img.dim() == 3 else y


def pad_right_down(img: torch.Tensor, stride: int, pad_value: float):
    """Pad bottom/right to multiples of ``stride``. Returns (padded,
    (pad_down, pad_right))."""
    h, w = img.shape[-3], img.shape[-2]
    pad_d = (stride - h % stride) % stride
    pad_r = (stride - w % stride) % stride
    return F.pad(img, (0, 0, 0, pad_r, 0, pad_d), value=pad_value), (pad_d, pad_r)


def scale_sizes(h: int, w: int, scales, boxsize: int, stride: int):
    """Per-scale geometry: (resize_h, resize_w, padded_h, padded_w). The
    height is resized to scale*boxsize, then padded to stride multiples."""
    out = []
    for s in scales:
        f = s * boxsize / h
        rh = max(int(round(h * f)), 1)
        rw = max(int(round(w * f)), 1)
        out.append((rh, rw, math.ceil(rh / stride) * stride, math.ceil(rw / stride) * stride))
    return out


def pyramid_sizes(cfg: InferenceConfig, model: ModelConfig, h: int, w: int):
    """``scale_sizes`` of the configured pyramid (``cfg.scale_search``)."""
    return scale_sizes(h, w, cfg.scale_search, model.boxsize, model.stride)
