"""Fused VGG block 1: conv1_1 + ReLU -> conv1_2 + ReLU -> 2x2 max-pool.

Counterpart of ``tpupose/ops/pallas_block1.py``. ``block1`` launches the
CUDA kernel ``csrc/block1.cu`` for CUDA tensors and runs
``block1_plain`` — the XLA path the Pallas kernel replaced
(``block1_reference``: bf16 convs, bias added in bf16) — for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpupose_torch.ops._build import CudaKernel

_P = ctypes.c_void_p
KERNEL = CudaKernel(
    "block1", "tp_block1",
    [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
    replaces="tpupose/ops/pallas_block1.py:142",
)


def block1_plain(x, k1, b1, k2, b2, dtype=torch.bfloat16):
    """Two SAME 3x3 convs + bias + ReLU in ``dtype``, then the 2x2/2 max
    pool. x (N, H, W, 3) NHWC, k1/k2 HWIO. Returns (N, H/2, W/2, 64)."""
    y = x.to(dtype).permute(0, 3, 1, 2)
    for k, b in ((k1, b1), (k2, b2)):
        y = F.conv2d(y, k.to(dtype).permute(3, 2, 0, 1), padding=1)
        y = torch.relu(y + b.to(dtype)[:, None, None])
    return F.max_pool2d(y, 2).permute(0, 2, 3, 1)


def block1(x, k1, b1, k2, b2):
    """conv1_1+relu+conv1_2+relu+maxpool2x2 in bf16 with f32 accumulation.

    x: (N, H, W, 3) normalised image, H and W even. k1 (3, 3, 3, 64),
    k2 (3, 3, 64, 64) HWIO, biases (64,). Returns (N, H/2, W/2, 64)
    bfloat16 NHWC. CPU tensors take ``block1_plain``; CUDA tensors the
    kernel.
    """
    n, h, w, cin = x.shape
    if cin != 3 or h % 2 or w % 2:
        raise ValueError(f"block1 needs (N, even H, even W, 3), got {tuple(x.shape)}")
    if tuple(k1.shape) != (3, 3, 3, 64) or tuple(k2.shape) != (3, 3, 64, 64):
        raise ValueError(f"block1 kernels {tuple(k1.shape)}, {tuple(k2.shape)}")
    if x.device.type == "cpu":
        return block1_plain(x, k1, b1, k2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"block1: unsupported device {x.device}")
    xb = x.to(torch.bfloat16).contiguous()
    w1 = k1.to(torch.float32).contiguous()
    w2 = k2.to(torch.bfloat16).contiguous()
    bb1 = b1.to(torch.float32).contiguous()
    bb2 = b2.to(torch.float32).contiguous()
    for t in (w1, w2, bb1, bb2):
        if t.device != x.device:
            raise ValueError("block1: weights and input on different devices")
    out = torch.empty((n, h // 2, w // 2, 64), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    KERNEL.launch(
        xb.data_ptr(), w1.data_ptr(), bb1.data_ptr(), w2.data_ptr(),
        bb2.data_ptr(), out.data_ptr(), n, h, w,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return out
