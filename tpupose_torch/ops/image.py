"""Image ops: normalise, resize, pad, pyramid geometry, map upsample.

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


def preprocess_scale(img_norm: torch.Tensor, rh: int, rw: int, stride: int,
                     pad_norm: float) -> torch.Tensor:
    """Resize a normalised (H, W, 3) image to (rh, rw) and pad to stride
    multiples; returns (1, ph, pw, 3)."""
    x, _ = pad_right_down(resize_bilinear(img_norm, rh, rw), stride, pad_norm)
    return x[None]


def upsample_to(maps: torch.Tensor, rh: int, rw: int, out_h: int, out_w: int,
                stride: int = 8) -> torch.Tensor:
    """Stride-N network output (1, ph/stride, pw/stride, C) -> (out_h,
    out_w, C): bilinear x ``stride`` to the padded size, crop the pad back
    to (rh, rw), bilinear to the image size."""
    return upsample_to_batch(maps, rh, rw, out_h, out_w, stride)[0]


def upsample_to_batch(maps: torch.Tensor, rh: int, rw: int, out_h: int, out_w: int,
                      stride: int = 8) -> torch.Tensor:
    """``upsample_to`` over a kept batch axis: (B, ph/stride, pw/stride,
    C) -> (B, out_h, out_w, C)."""
    ph, pw = maps.shape[1], maps.shape[2]
    full = resize_bilinear(maps, ph * stride, pw * stride)
    return resize_bilinear(full[:, :rh, :rw, :], out_h, out_w)


def average_upsampled(maps, sizes, out_h: int, out_w: int, stride: int = 8) -> torch.Tensor:
    """Per-scale low-res maps (each (B, ph/stride, pw/stride, C), with its
    ``scale_sizes`` entry) -> their (B, out_h, out_w, C) f32 average at the
    image size: ``upsample_to_batch`` of each scale divided by the number
    of scales, summed in scale order. The divisor is a tensor, so the
    quotient is a true division on every device."""
    ns = torch.tensor(float(len(sizes)), device=maps[0].device)
    avg = None
    for m, (rh, rw, _, _) in zip(maps, sizes):
        up = upsample_to_batch(m.to(torch.float32), rh, rw, out_h, out_w, stride) / ns
        avg = up if avg is None else avg + up
    return avg


def pyramid_sizes(cfg: InferenceConfig, model: ModelConfig, h: int, w: int):
    """``scale_sizes`` of the configured pyramid (``cfg.scale_search``)."""
    return scale_sizes(h, w, cfg.scale_search, model.boxsize, model.stride)
