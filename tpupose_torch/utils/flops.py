"""Model FLOP accounting for MFU reporting.

The port's copy of ``tpupose/utils/flops.py``. Counts multiply-add FLOPs
(2 * H * W * Cin * Cout * k^2 per SAME conv) of the VGG19+CPM front-end
and the 6-stage two-branch head exactly as built in
``tpupose_torch.models.openpose``. Elementwise/pool/resize work is
negligible against the convs and is not counted — MFU reported from these
numbers is slightly conservative. The peak is the card's, not the TPU's.
"""

from __future__ import annotations

from tpupose_torch import topology

# NVIDIA H100 SXM peak dense bf16 tensor-core throughput (data sheet, at 700 W).
PEAK_BF16_FLOPS = 989e12


def _conv(h: int, w: int, cin: int, cout: int, k: int) -> int:
    return 2 * h * w * cin * cout * k * k


def forward_flops(in_h: int, in_w: int, num_stages: int = 6) -> int:
    """FLOPs of one forward pass at (in_h, in_w) input resolution."""
    h, w = in_h, in_w
    total = _conv(h, w, 3, 64, 3) + _conv(h, w, 64, 64, 3)
    h, w = h // 2, w // 2
    total += _conv(h, w, 64, 128, 3) + _conv(h, w, 128, 128, 3)
    h, w = h // 2, w // 2
    total += _conv(h, w, 128, 256, 3) + 3 * _conv(h, w, 256, 256, 3)
    h, w = h // 2, w // 2
    total += _conv(h, w, 256, 512, 3) + _conv(h, w, 512, 512, 3)   # conv4_1/2
    total += _conv(h, w, 512, 256, 3) + _conv(h, w, 256, 128, 3)   # CPM

    paf_c = topology.NUM_PAF_CHANNELS
    heat_c = topology.NUM_HEAT_CHANNELS
    for out_c in (paf_c, heat_c):                                  # stage 1
        total += 3 * _conv(h, w, 128, 128, 3)
        total += _conv(h, w, 128, 512, 1) + _conv(h, w, 512, out_c, 1)
    concat_c = paf_c + heat_c + 128                                # 185
    for _ in range(num_stages - 1):                                # stages 2+
        for out_c in (paf_c, heat_c):
            total += _conv(h, w, concat_c, 128, 7)
            total += 4 * _conv(h, w, 128, 128, 7)
            total += _conv(h, w, 128, 128, 1) + _conv(h, w, 128, out_c, 1)
    return total


def pyramid_flops(
    in_h: int, in_w: int, scales, boxsize: int = 368, stride: int = 8,
    num_stages: int = 6,
) -> int:
    """FLOPs of one image through the multi-scale pyramid (padded sizes)."""
    from tpupose_torch.ops.image import scale_sizes

    return sum(
        forward_flops(ph, pw, num_stages)
        for _, _, ph, pw in scale_sizes(in_h, in_w, scales, boxsize, stride)
    )
