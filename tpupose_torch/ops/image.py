"""Image ops: normalise, resize, pad, pyramid geometry, map upsample.

Counterpart of ``tpupose/ops/image.py``. Tensors are NHWC (or HWC), as
in the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from tpupose_torch.config import InferenceConfig, ModelConfig
from tpupose_torch.decode.scalespace import census, holds, line_classes

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


_SUPPORTS: dict = {}


def resize_support(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) 0/1 f32 pattern of the non-zero weights of the
    reference's linear resize along one axis: ``jax.image.resize``'s
    weight matrix, whose taps are the inputs within one pixel of the
    sample position, computed in f32 as it computes it. Kept per device,
    so that no call copies it from the host."""
    key = (n_in, n_out, str(device))
    hit = _SUPPORTS.get(key)
    if hit is None:
        inv = np.float32(1.0 / (n_out / n_in))
        sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
        dist = np.abs(sample[:, None] - np.arange(n_in, dtype=np.float32)[None, :])
        hit = _SUPPORTS[key] = torch.from_numpy((dist < 1).astype(np.float32)).to(device)
    return hit


_WHOLE: dict = {}


def _whole(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out,) bool: the outputs of a resize whose footprint holds every
    input. Kept per device, as ``resize_support``."""
    key = (n_in, n_out, str(device))
    if key not in _WHOLE:
        _WHOLE[key] = resize_support(n_in, n_out, device).bool().all(dim=1)
    return _WHOLE[key]


def upsample_terms(maps: torch.Tensor, rh: int, rw: int, out_h: int, out_w: int,
                   stride: int = 8):
    """``upsample_to_batch`` in three parts: the upsample of ``maps`` with
    their non-finite entries read as 0 (B, out_h, out_w, C), and the rows'
    (B, out_h, 1, C) and columns' (B, 1, out_w, C) shares of the contract's
    classes (``decode.scalespace.line_classes``; -0.0 for a channel without
    a non-finite entry). Their sum is the upsample: on a finite map the
    interpolation's values, unchanged; elsewhere the classes that the
    reference's two dense resizes give, in turn, with the crop between them
    (an axis whose size a resize keeps is skipped, as the reference skips
    it, and its rows stand alone)."""
    ph, pw = maps.shape[1], maps.shape[2]
    dev = maps.device
    code, rows, cols = census(maps)
    # the x``stride`` resize: an output is the code where its footprint holds
    # every non-finite entry, NaN elsewhere (a clean channel's code, -0.0,
    # everywhere); then the crop
    r1 = line_classes(code, holds(resize_support(ph, ph * stride, dev), rows, -3))[:, :rh]
    c1 = line_classes(code, holds(resize_support(pw, pw * stride, dev), cols, -2))[:, :, :rw]
    # the resize to the image: a contracted axis meets every entry of the
    # crop, which is NaN where one share is, else the code (amax keeps both,
    # and a clean channel's -0.0), and an output keeps it where its
    # footprint holds the whole crop (a clean channel's -0.0 everywhere)
    r2, c2 = r1, c1
    if out_h != rh:
        crop = r1.amax(dim=1, keepdim=True)
        if out_w != rw:
            crop = crop + c1.amax(dim=2, keepdim=True)
        r2 = line_classes(crop, _whole(rh, out_h, dev)[None, :, None, None] | (crop == 0))
    if out_w != rw:
        crop = c1.amax(dim=2, keepdim=True)
        c2 = line_classes(crop, _whole(rw, out_w, dev)[None, None, :, None] | (crop == 0))
    src = torch.where(torch.isfinite(maps), maps, torch.zeros_like(maps))
    up = resize_bilinear(resize_bilinear(src, ph * stride, pw * stride)[:, :rh, :rw, :],
                         out_h, out_w)
    return up, r2.to(up.dtype), c2.to(up.dtype)


def upsample_to_batch(maps: torch.Tensor, rh: int, rw: int, out_h: int, out_w: int,
                      stride: int = 8) -> torch.Tensor:
    """``upsample_to`` over a kept batch axis: (B, ph/stride, pw/stride,
    C) -> (B, out_h, out_w, C). A non-finite value follows the contract of
    ``decode.scalespace`` through each of the two resizes in turn, as the
    reference's dense resizes carry it (``upsample_terms``)."""
    up, rows, cols = upsample_terms(maps, rh, rw, out_h, out_w, stride)
    return up.add_(rows).add_(cols)


def average_upsampled(maps, sizes, out_h: int, out_w: int, stride: int = 8) -> torch.Tensor:
    """Per-scale low-res maps (each (B, ph/stride, pw/stride, C), with its
    ``scale_sizes`` entry) -> their (B, out_h, out_w, C) f32 average at the
    image size: ``upsample_to_batch`` of each scale divided by the number
    of scales, summed in scale order. The divisor is a tensor, so the
    quotient is a true division on every device. The scales' class shares
    (``upsample_terms``) are added once, to the sum."""
    ns = torch.tensor(float(len(sizes)), device=maps[0].device)
    avg = rows = cols = None
    for m, (rh, rw, _, _) in zip(maps, sizes):
        up, r, c = upsample_terms(m.to(torch.float32), rh, rw, out_h, out_w, stride)
        up = up / ns
        avg = up if avg is None else avg + up
        # the scales' shares of the classes add as the classes do
        rows = r if rows is None else rows + r
        cols = c if cols is None else cols + c
    return avg.add_(rows).add_(cols)


def pyramid_sizes(cfg: InferenceConfig, model: ModelConfig, h: int, w: int):
    """``scale_sizes`` of the configured pyramid (``cfg.scale_search``)."""
    return scale_sizes(h, w, cfg.scale_search, model.boxsize, model.stride)
