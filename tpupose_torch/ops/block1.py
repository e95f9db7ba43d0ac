"""Fused VGG block 1: conv1_1 + ReLU -> conv1_2 + ReLU -> 2x2 max-pool.

Counterpart of ``tpupose/ops/pallas_block1.py``. ``block1`` launches the
CUDA kernel ``csrc/block1.cu`` for CUDA tensors and runs
``block1_plain`` — the XLA path the Pallas kernel replaced
(``block1_reference``: bf16 convs, bias added in bf16) — for CPU tensors.
Both are the registered operator ``tpupose_torch::block1`` (its CPU and
CUDA kernels), so that ``torch.export`` keeps the call as one node.
"""

from __future__ import annotations

import ctypes
import warnings

import torch
import torch.nn.functional as F

from tpupose_torch.ops._build import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
KERNEL = CudaKernel(
    "block1", "tp_block1",
    [_P, _I, _L, _L, _L, _L, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    replaces="tpupose/ops/pallas_block1.py:142",
)
# conv1_2's output channels are the M rows of its wgmma. A thread holds
# accumulator rows 16 w + g and 16 w + g + 8; with channel 16 w + 2 g + h in
# row 16 w + g + 8 h they are a neighbouring channel pair, one 4-byte store
_ROW_CHANNEL = [16 * (m // 16) + 2 * (m % 8) + m % 16 // 8 for m in range(64)]
_PACKED: dict = {}          # id of the parameters' state -> (sources, packed)
_PACKED_MAX = 8
_WARNED_INFERENCE = False


def block1_plain(x, k1, b1, k2, b2, dtype=torch.bfloat16):
    """Two SAME 3x3 convs + bias + ReLU in ``dtype``, then the 2x2/2 max
    pool. x (N, H, W, 3) NHWC, k1/k2 HWIO. Returns (N, H/2, W/2, 64)."""
    y = x.to(dtype).permute(0, 3, 1, 2)
    for k, b in ((k1, b1), (k2, b2)):
        y = F.conv2d(y, k.to(dtype).permute(3, 2, 0, 1), padding=1)
        y = torch.relu(y + b.to(dtype)[:, None, None])
    return F.max_pool2d(y, 2).permute(0, 2, 3, 1)


def pack_weights(k1, b1, k2, b2):
    """The kernel's operand layout: (w1, b1, w2, b2).

    w2 (9, 8, 64, 8) bf16 is ``[tap][ci // 8][row][ci % 8]``: per tap and
    16 input channels a K-major wgmma operand of 8 x 16-byte core matrices
    (conv1_2's A: channels are its M rows), with output channel
    ``_ROW_CHANNEL[row]`` in each row. w1 (4, 64, 8) bf16 is the same for
    conv1_1 (its B operand) as a K = 27 -> 32 product, ``k = (dy * 3 + dx)
    * 3 + ci``, channels in natural order. Biases are f32 in natural order.
    """
    cols = torch.as_tensor(_ROW_CHANNEL, device=k2.device)
    w2 = k2.detach().to(torch.bfloat16)[..., cols].reshape(9, 8, 8, 64)
    w1 = torch.zeros((32, 64), dtype=torch.bfloat16, device=k1.device)
    w1[:27] = k1.detach().to(torch.bfloat16).reshape(27, 64)
    return (w1.reshape(4, 8, 64).permute(0, 2, 1).contiguous(),
            b1.detach().to(torch.float32).contiguous(),
            w2.permute(0, 1, 3, 2).contiguous(),
            b2.detach().to(torch.float32).contiguous())


def packed_weights(k1, b1, k2, b2):
    """``pack_weights`` once per state of the parameters: the result is kept
    under the four tensors' storage, layout and version counter, so a call
    with unchanged parameters casts and copies nothing and an in-place
    update (an optimizer step, ``load_state_dict``) packs anew.

    An entry holds its four source tensors, so that their storage cannot be
    freed and handed to other values under the same key: the parameters of
    a released model stay allocated until a later model's take their place
    among the ``_PACKED_MAX`` entries. Inference tensors (parameters made
    under ``torch.inference_mode``) carry no version counter, an in-place
    change of theirs could not be seen, and so they are packed on every
    call, with a warning the first time: make the parameters outside
    inference mode to pack them once.
    """
    src = (k1, b1, k2, b2)
    if any(t.is_inference() for t in src):
        global _WARNED_INFERENCE
        if not _WARNED_INFERENCE:
            _WARNED_INFERENCE = True
            warnings.warn("block1: the parameters are inference tensors, which carry no version "
                          "counter; their weights are packed on every call. Build or load the "
                          "model outside torch.inference_mode() to pack them once.",
                          RuntimeWarning, stacklevel=3)
        return pack_weights(*src)
    key = tuple((t.data_ptr(), t._version, t.dtype, tuple(t.shape), tuple(t.stride()))
                for t in src)
    hit = _PACKED.get(key)
    if hit is None:
        for stale in [k for k in _PACKED if k[0][0] == key[0][0]]:
            del _PACKED[stale]
        while len(_PACKED) >= _PACKED_MAX:
            del _PACKED[next(iter(_PACKED))]
        hit = _PACKED[key] = (src, pack_weights(*src))
    return hit[1]


def refuse_grad(*tensors) -> None:
    """Raise if autograd would record a call on ``tensors``: the kernel has
    no backward, and its output would silently carry no gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "block1: the CUDA kernel is inference-only (no backward); call it under "
            "torch.no_grad()/inference_mode(), or build the model with "
            "pallas_block1=False to train through the convs")


@torch.library.custom_op("tpupose_torch::block1", mutates_args=(), device_types="cpu")
def _block1_op(x: torch.Tensor, k1: torch.Tensor, b1: torch.Tensor, k2: torch.Tensor,
               b2: torch.Tensor) -> torch.Tensor:
    return block1_plain(x, k1, b1, k2, b2).contiguous()


@_block1_op.register_kernel("cuda")
def _block1_cuda(x, k1, b1, k2, b2):
    n, h, w, _ = x.shape
    # the image is read in place through its strides (an NHWC view of NCHW
    # planes loads coalesced along W); only other types are converted
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    w1, bb1, w2, bb2 = packed_weights(k1, b1, k2, b2)
    out = torch.empty((n, h // 2, w // 2, 64), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    KERNEL.launch(
        x.device, x.data_ptr(), int(x.dtype == torch.bfloat16), *x.stride(),
        w1.data_ptr(), bb1.data_ptr(), w2.data_ptr(), bb2.data_ptr(), out.data_ptr(), n, h, w,
    )
    return out


@_block1_op.register_fake
def _block1_fake(x, k1, b1, k2, b2):
    n, h, w, _ = x.shape
    return x.new_empty((n, h // 2, w // 2, 64), dtype=torch.bfloat16)


def _block1_setup(ctx, inputs, output):
    if inputs[0].device.type == "cuda":
        refuse_grad(*inputs)
    ctx.save_for_backward(*inputs)


def _block1_backward(ctx, grad):
    """The plain version's gradient: the CPU route trains through the convs."""
    _, vjp = torch.func.vjp(block1_plain, *ctx.saved_tensors)
    return vjp(grad)


_block1_op.register_autograd(_block1_backward, setup_context=_block1_setup)


def block1(x, k1, b1, k2, b2):
    """conv1_1+relu+conv1_2+relu+maxpool2x2 in bf16 with f32 accumulation.

    x: (N, H, W, 3) normalised image, H and W even. k1 (3, 3, 3, 64),
    k2 (3, 3, 64, 64) HWIO, biases (64,). Returns (N, H/2, W/2, 64)
    bfloat16 NHWC. CPU tensors take ``block1_plain``; CUDA tensors the
    kernel.

    The kernel has no backward (nor has the kernel it replaces): on a
    CUDA tensor, a call that would need one — grad mode on and any of the
    five tensors requiring grad — raises instead of returning a result
    cut off from the graph. Training runs block 1 through the convs.
    """
    n, h, w, cin = x.shape
    if cin != 3 or h % 2 or w % 2:
        raise ValueError(f"block1 needs (N, even H, even W, 3), got {tuple(x.shape)}")
    if tuple(k1.shape) != (3, 3, 3, 64) or tuple(k2.shape) != (3, 3, 64, 64):
        raise ValueError(f"block1 kernels {tuple(k1.shape)}, {tuple(k2.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"block1: unsupported device {x.device}")
    if x.device.type == "cuda":
        refuse_grad(x, k1, b1, k2, b2)
        if any(t.device != x.device for t in (k1, b1, k2, b2)):
            raise ValueError("block1: weights and input on different devices")
    return _block1_op(x, k1, b1, k2, b2)


def wgmma_probe(pixels, w, shift: int, from_regs: bool = False):
    """One bare wgmma tile on the card, for bf16 pixels (P, 16) laid out as
    the activation tile's planes and w (64, 16) laid out as the weights,
    the pixel operand starting ``shift`` pixels in. As conv1_2 takes a tap:
    ``w @ pixels[shift:shift + 128].T`` (64, 128), both through
    descriptors; ``from_regs``, as conv1_1 takes its im2col:
    ``pixels[shift:shift + 64] @ w.T`` (64, 64), the pixels through
    registers. The kernel's descriptor layout, tested apart from the
    convolution."""
    n = pixels.shape[0]
    if pixels.device.type != "cuda" or pixels.shape[1] != 16 or tuple(w.shape) != (64, 16):
        raise ValueError(f"wgmma_probe: pixels {tuple(pixels.shape)} on {pixels.device}, "
                         f"w {tuple(w.shape)}")
    planes = pixels.to(torch.bfloat16).reshape(n, 2, 8).permute(1, 0, 2).contiguous()
    rows = w.to(torch.bfloat16).reshape(64, 2, 8).permute(1, 0, 2).contiguous()
    out = torch.empty((64, 64 if from_regs else 128), dtype=torch.float32, device=pixels.device)
    fn = KERNEL.entry("tp_block1_wgmma_probe", [_P, _P, _P, _I, _I, _I, _P])
    with torch.cuda.device(pixels.device):
        code = fn(planes.data_ptr(), rows.data_ptr(), out.data_ptr(), n, shift,
                  int(from_regs), torch.cuda.current_stream(pixels.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"wgmma probe launch failed ({code})")
    return out
