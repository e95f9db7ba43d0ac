"""The BODY_25 conv epilogue: bias + PReLU into a slice of a concatenation.

``dense_epilogue`` launches ``csrc/dense_epilogue.cu`` for CUDA tensors and
runs ``dense_epilogue_plain`` (the same arithmetic in torch ops) for CPU
tensors. Both are the registered operator ``tpupose_torch::dense_epilogue``.
It replaces no TPU kernel: the JAX package has no BODY_25 network. Every
call adds one to the counter ``net.dense_epilogue``
(``utils/profiling.count``).

The arithmetic, per pixel p and channel c of a conv's output ``y`` (its
bias not added): ``v = f32(y[p, c]) + bias[c]`` in f32, ``v`` where it is
positive else ``slope[c] * v`` in f32, rounded once to ``y``'s type.
"""

from __future__ import annotations

import ctypes

import torch

from tpupose_torch.ops._build import CudaKernel
from tpupose_torch.utils.profiling import count

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel(
    "dense_epilogue", "tp_dense_epilogue",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    replaces="none (the BODY_25 network is not in the JAX package)",
)
_DTYPES = (torch.bfloat16, torch.float32)
_MAX_VECTORS = 256      # csrc/dense_epilogue.cu kThreads: 16-byte vectors a pixel


def dense_epilogue_plain(y: torch.Tensor, bias: torch.Tensor, slope: torch.Tensor) -> torch.Tensor:
    """bias + PReLU of ``y`` (..., C) in f32, rounded once to ``y``'s type."""
    v = y.to(torch.float32) + bias.to(torch.float32)
    return torch.where(v > 0, v, slope.to(torch.float32) * v).to(y.dtype)


@torch.library.custom_op("tpupose_torch::dense_epilogue", mutates_args=("y", "out"),
                         device_types="cpu")
def _epilogue_op(y: torch.Tensor, bias: torch.Tensor, slope: torch.Tensor, out: torch.Tensor,
                 off: int, keep: bool) -> None:
    z = dense_epilogue_plain(y, bias, slope)
    out[..., off:off + y.shape[-1]] = z
    if keep:
        y.copy_(z)


@_epilogue_op.register_kernel("cuda")
def _epilogue_cuda(y, bias, slope, out, off, keep):
    n, h, w, c = y.shape
    if y.numel() == 0:
        return
    b, s = (t.detach().to(torch.float32).contiguous() for t in (bias, slope))
    KERNEL.launch(y.device, y.data_ptr(), b.data_ptr(), s.data_ptr(), out.data_ptr(),
                  int(y.dtype == torch.bfloat16), n * h * w, c, out.shape[-1], off, int(keep))


@_epilogue_op.register_fake
def _epilogue_fake(y, bias, slope, out, off, keep):
    return None


def dense_epilogue(y: torch.Tensor, bias: torch.Tensor, slope: torch.Tensor, out: torch.Tensor,
                   off: int = 0, keep: bool = False) -> None:
    """Writes bias + PReLU of a conv's output into channels ``off`` ..
    ``off + C - 1`` of ``out``.

    y (N, H, W, C) NHWC, bf16 or f32, the conv without its bias; bias,
    slope (C,) f32; out (N, H, W, Cout) of ``y``'s type. With ``keep`` the
    result is written over ``y`` too (the next conv's dense input). CPU
    tensors take ``dense_epilogue_plain``; CUDA tensors the kernel, which
    needs ``y`` and ``out`` dense NHWC and 16-byte aligned with C, Cout and
    ``off`` multiples of 16 bytes.
    """
    if y.dim() != 4 or out.dim() != 4 or tuple(out.shape[:3]) != tuple(y.shape[:3]):
        raise ValueError(f"dense_epilogue: y {tuple(y.shape)}, out {tuple(out.shape)}")
    c = y.shape[-1]
    if tuple(bias.shape) != (c,) or tuple(slope.shape) != (c,) or not 0 <= off <= out.shape[-1] - c:
        raise ValueError(f"dense_epilogue: {c} channels at {off} of {out.shape[-1]}, bias "
                         f"{tuple(bias.shape)}, slope {tuple(slope.shape)}")
    if y.dtype not in _DTYPES or out.dtype != y.dtype:
        raise ValueError(f"dense_epilogue: y {y.dtype}, out {out.dtype}")
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dense_epilogue: unsupported device {y.device}")
    if y.device.type == "cuda":
        if any(t.device != y.device for t in (bias, slope, out)):
            raise ValueError("dense_epilogue: tensors on different devices")
        vec = 16 // y.element_size()
        if not (y.is_contiguous() and out.is_contiguous() and c % vec == 0
                and out.shape[-1] % vec == 0 and off % vec == 0 and c // vec <= _MAX_VECTORS
                and y.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0):
            raise ValueError(f"dense_epilogue: the kernel needs dense, 16-byte aligned NHWC "
                             f"tensors and 16-byte channel runs (y {tuple(y.shape)} "
                             f"{y.stride()}, out {tuple(out.shape)} {out.stride()}, off {off})")
    count("net.dense_epilogue")
    _epilogue_op(y, bias, slope, out, off, keep)
