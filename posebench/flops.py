"""Operations, bytes and peaks: the yardstick of the roofline and MFU metrics.

``forward_flops`` and ``pyramid_flops`` are a frozen copy of
``tpupose_torch/utils/flops.py``: multiply-add FLOPs (2 * H * W * Cin *
Cout * k^2 per SAME conv) of VGG19 to conv4_2, the CPM convs and the six
two-branch stages; element-wise, pool and resize work is not counted.
The bounds of the kernels count each input byte read once and each output
byte written once, at the shapes the cell runs.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W).
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

PAF_CHANNELS, HEAT_CHANNELS, PARTS = 38, 19, 18


def _conv(h: int, w: int, cin: int, cout: int, k: int) -> int:
    return 2 * h * w * cin * cout * k * k


def vgg_flops(in_h: int, in_w: int) -> int:
    """VGG19 conv1_1..conv4_2 at (in_h, in_w)."""
    h, w = in_h, in_w
    total = _conv(h, w, 3, 64, 3) + _conv(h, w, 64, 64, 3)
    h, w = h // 2, w // 2
    total += _conv(h, w, 64, 128, 3) + _conv(h, w, 128, 128, 3)
    h, w = h // 2, w // 2
    total += _conv(h, w, 128, 256, 3) + 3 * _conv(h, w, 256, 256, 3)
    h, w = h // 2, w // 2
    return total + _conv(h, w, 256, 512, 3) + _conv(h, w, 512, 512, 3)


def head_flops(in_h: int, in_w: int, num_stages: int = 6) -> int:
    """The CPM convs and every stage at (in_h, in_w) input."""
    h, w = in_h // 8, in_w // 8
    total = _conv(h, w, 512, 256, 3) + _conv(h, w, 256, 128, 3)
    for out_c in (PAF_CHANNELS, HEAT_CHANNELS):
        total += 3 * _conv(h, w, 128, 128, 3)
        total += _conv(h, w, 128, 512, 1) + _conv(h, w, 512, out_c, 1)
    concat_c = PAF_CHANNELS + HEAT_CHANNELS + 128
    for _ in range(num_stages - 1):
        for out_c in (PAF_CHANNELS, HEAT_CHANNELS):
            total += _conv(h, w, concat_c, 128, 7)
            total += 4 * _conv(h, w, 128, 128, 7)
            total += _conv(h, w, 128, 128, 1) + _conv(h, w, 128, out_c, 1)
    return total


def forward_flops(in_h: int, in_w: int, num_stages: int = 6) -> int:
    """FLOPs of one forward pass at (in_h, in_w)."""
    return vgg_flops(in_h, in_w) + head_flops(in_h, in_w, num_stages)


def scale_sizes(h: int, w: int, scales, boxsize: int, stride: int):
    """Per scale (resized h, resized w, padded h, padded w)."""
    out = []
    for s in scales:
        f = s * boxsize / h
        rh, rw = max(int(round(h * f)), 1), max(int(round(w * f)), 1)
        out.append((rh, rw, -(-rh // stride) * stride, -(-rw // stride) * stride))
    return out


def pyramid_flops(in_h: int, in_w: int, scales, boxsize: int = 368, stride: int = 8,
                  num_stages: int = 6) -> int:
    """FLOPs of one image through the pyramid, at the padded sizes."""
    return sum(forward_flops(ph, pw, num_stages)
               for _, _, ph, pw in scale_sizes(in_h, in_w, scales, boxsize, stride))


def train_flops(size: int, num_stages: int = 6, frozen_vgg: bool = True) -> int:
    """FLOPs one sample of a training step needs at ``size`` x ``size``:
    forward and backward (3x the forward) of the trained layers; the
    forward alone of a frozen VGG, whose gradients nothing needs."""
    vgg = vgg_flops(size, size)
    return (vgg if frozen_vgg else 3 * vgg) + 3 * head_flops(size, size, num_stages)


def block1_bound_s(n: int, ph: int, pw: int) -> float:
    """Least time of block 1 (conv1_1 + ReLU + conv1_2 + ReLU + 2x2 pool)
    of n padded (ph, pw) images: its operations at the bf16 peak, or its
    f32 input read once and bf16 pooled output written once."""
    ops = n * (_conv(ph, pw, 3, 64, 3) + _conv(ph, pw, 64, 64, 3))
    moved = n * ph * pw * 3 * 4 + n * (ph // 2) * (pw // 2) * 64 * 2
    return max(ops / PEAK_BF16_FLOPS, moved / PEAK_BYTES_PER_S)


def pyramid_peaks_bound_s(n: int, sizes, h: int, w: int, stride: int) -> float:
    """Least time of the scale-space peak scores of n images of (h, w):
    every scale's f32 low-res part maps read once, the f32 (n, 18, h * w)
    masked scores written once."""
    moved = sum(n * (ph // stride) * (pw // stride) * PARTS * 4 for _, _, ph, pw in sizes)
    moved += n * PARTS * h * w * 4
    return moved / PEAK_BYTES_PER_S
