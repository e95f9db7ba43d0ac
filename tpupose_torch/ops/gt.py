"""Ground-truth rasterisation of a batch: Gaussian heatmaps + PAF bands.

Counterpart of ``tpupose/ops/pallas_gt.py``. ``create_labels`` launches
``csrc/gt.cu`` for CUDA tensors and runs ``create_labels_plain`` for CPU
tensors. The labels are training targets and carry no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from tpupose_torch import topology
from tpupose_torch.ops._build import CudaKernel

_EXP_CUTOFF = 4.6052  # skip where d^2 / (2 sigma^2) > ln(100)
_SMEM_LIMIT = 227 * 1024
_BYTES_PER_PERSON = (topology.NUM_PARTS * 3 + topology.NUM_LIMBS * 6) * 4


class _Params(ctypes.Structure):
    _fields_ = [
        ("batch", ctypes.c_int), ("persons", ctypes.c_int), ("label", ctypes.c_int),
        ("stride", ctypes.c_float), ("half_stride", ctypes.c_float),
        ("denom", ctypes.c_float), ("thre", ctypes.c_float),
        ("limb_a", ctypes.c_int * topology.NUM_LIMBS),
        ("limb_b", ctypes.c_int * topology.NUM_LIMBS),
        ("joints", ctypes.c_void_p), ("mask", ctypes.c_void_p),
        ("paf", ctypes.c_void_p), ("heat", ctypes.c_void_p),
    ]


_LIMB_A = (ctypes.c_int * topology.NUM_LIMBS)(*(a for a, _ in topology.LIMBS))
_LIMB_B = (ctypes.c_int * topology.NUM_LIMBS)(*(b for _, b in topology.LIMBS))

KERNEL = CudaKernel(
    "gt", "tp_gt", [ctypes.POINTER(_Params), ctypes.c_void_p],
    replaces="tpupose/ops/pallas_gt.py:125",
)


def create_labels_plain(joints, mask, label_size=46, stride=8, sigma=7.0, paf_thre=8.0):
    """``create_labels`` in plain PyTorch ops, persons folded in index
    order as the kernel folds them. Divisors are device tensors so every
    quotient is a true division on any device."""
    dev = joints.device
    joints = joints.to(torch.float32)
    mask = mask.to(torch.float32)
    n, persons = joints.shape[:2]
    l = label_size
    s = torch.tensor(float(stride), device=dev)
    denom = torch.tensor(2.0 * sigma * sigma, device=dev)
    thre = paf_thre / float(stride)
    idx = torch.arange(l, dtype=torch.float32, device=dev)
    col, row = idx[None, None, None, :], idx[None, None, :, None]     # (1, 1, L, L) axes
    gx = col * float(stride) + stride / 2.0 - 0.5                     # image-space grid
    gy = row * float(stride) + stride / 2.0 - 0.5
    limbs = torch.as_tensor(topology.LIMBS, device=dev)

    parts = torch.zeros((n, topology.NUM_PARTS, l, l), dtype=torch.float32, device=dev)
    vec_x = torch.zeros((n, topology.NUM_LIMBS, l, l), dtype=torch.float32, device=dev)
    vec_y = torch.zeros_like(vec_x)
    count = torch.zeros_like(vec_x)
    for q in range(persons):
        j = joints[:, q]                                              # (N, 18, 3)
        x, y = j[:, :, 0, None, None], j[:, :, 1, None, None]
        present = (j[:, :, 2] < 2.0)[:, :, None, None]
        expo = ((gx - x) ** 2 + (gy - y) ** 2) / denom
        val = torch.where((expo <= _EXP_CUTOFF) & present, torch.exp(-expo), 0.0)
        parts = torch.maximum(parts, val)

        ja, jb = j[:, limbs[:, 0]], j[:, limbs[:, 1]]                 # (N, 19, 3)
        ax = (ja[..., 0] + 0.5) / s - 0.5                             # label-grid coords
        ay = (ja[..., 1] + 0.5) / s - 0.5
        bx = (jb[..., 0] + 0.5) / s - 0.5
        by = (jb[..., 1] + 0.5) / s - 0.5
        dx, dy = bx - ax, by - ay
        norm = torch.sqrt(dx * dx + dy * dy)
        ok = (ja[..., 2] < 2.0) & (jb[..., 2] < 2.0) & (norm >= 1e-8)
        ns = torch.clamp(norm, min=1e-8)
        ux, uy = (dx / ns)[:, :, None, None], (dy / ns)[:, :, None, None]
        px = col - ax[:, :, None, None]
        py = row - ay[:, :, None, None]
        along = px * ux + py * uy
        perp = torch.abs(px * uy - py * ux)
        band = ((perp <= thre) & (along >= 0.0) & (along <= norm[:, :, None, None])
                & ok[:, :, None, None]).to(torch.float32)
        vec_x = vec_x + band * ux
        vec_y = vec_y + band * uy
        count = count + band

    m = mask[:, None]                                                 # (N, 1, L, L)
    parts = torch.clamp(parts, 0.0, 1.0)
    background = 1.0 - parts.max(dim=1, keepdim=True).values
    heat = torch.cat([parts, background], dim=1) * m
    inv = m / torch.clamp(count, min=1.0)
    paf = torch.stack([vec_x * inv, vec_y * inv], dim=2)              # (N, 19, 2, L, L)
    paf = paf.reshape(n, topology.NUM_PAF_CHANNELS, l, l)
    return paf.permute(0, 2, 3, 1).contiguous(), heat.permute(0, 2, 3, 1).contiguous()


def create_labels(joints: torch.Tensor, mask: torch.Tensor, label_size: int = 46,
                  stride: int = 8, sigma: float = 7.0, paf_thre: float = 8.0):
    """Batched labels: (N, L, L, 38) PAF GT and (N, L, L, 19) heat GT f32,
    each multiplied by the miss-mask.

    joints (N, P, 18, 3) = (x, y, v) in input-image pixels, v < 2 present
    (padding persons are v = 2 rows); mask (N, L, L) in [0, 1]. Heatmaps:
    exp(-d^2 / 2 sigma^2) on the stride grid with the exp(-4.6052)
    cut-off, max-combined over persons, background = 1 - max(parts).
    PAFs: per-limb unit vectors in a paf_thre-wide band along the bone,
    count-averaged where persons overlap. CPU tensors take
    ``create_labels_plain``; CUDA tensors the kernel.
    """
    if joints.dim() != 4 or tuple(joints.shape[2:]) != (topology.NUM_PARTS, 3):
        raise ValueError(f"create_labels: joints {tuple(joints.shape)}, want (N, P, 18, 3)")
    n, persons = joints.shape[:2]
    if tuple(mask.shape) != (n, label_size, label_size):
        raise ValueError(f"create_labels: mask {tuple(mask.shape)}, want "
                         f"{(n, label_size, label_size)}")
    dev = joints.device
    if mask.device != dev:
        raise ValueError("create_labels: joints and mask on different devices")
    if dev.type == "cpu":
        return create_labels_plain(joints, mask, label_size, stride, sigma, paf_thre)
    if dev.type != "cuda":
        raise ValueError(f"create_labels: unsupported device {dev}")
    if persons * _BYTES_PER_PERSON > _SMEM_LIMIT:
        raise ValueError(f"create_labels: {persons} persons exceed the kernel's shared memory")
    jc = joints.detach().to(torch.float32).contiguous()
    mc = mask.detach().to(torch.float32).contiguous()
    paf = torch.empty((n, label_size, label_size, topology.NUM_PAF_CHANNELS),
                      dtype=torch.float32, device=dev)
    heat = torch.empty((n, label_size, label_size, topology.NUM_HEAT_CHANNELS),
                       dtype=torch.float32, device=dev)
    if n == 0:
        return paf, heat
    p = _Params()
    p.batch, p.persons, p.label = n, persons, label_size
    p.stride = float(stride)
    p.half_stride = stride / 2.0
    p.denom = 2.0 * sigma * sigma
    p.thre = paf_thre / float(stride)
    p.limb_a, p.limb_b = _LIMB_A, _LIMB_B
    p.joints, p.mask, p.paf, p.heat = (jc.data_ptr(), mc.data_ptr(),
                                      paf.data_ptr(), heat.data_ptr())
    KERNEL.launch(ctypes.byref(p), torch.cuda.current_stream(dev).cuda_stream)
    return paf, heat
