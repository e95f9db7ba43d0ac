"""Ground-truth rasterisation of a batch: Gaussian heatmaps + PAF bands.

Counterpart of ``tpupose/ops/pallas_gt.py``. ``create_labels`` launches
``csrc/gt.cu`` for CUDA tensors and runs ``create_labels_plain`` for CPU
tensors. The labels are training targets and carry no gradient.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpupose_torch import topology
from tpupose_torch.ops._build import CudaKernel

_EXP_CUTOFF = 4.6052  # skip where d^2 / (2 sigma^2) > ln(100)
_SMEM_LIMIT = 227 * 1024
# csrc/gt.cu: per person the joints, the limb records and two list entries per
# channel; per pixel of a tile the mask and the 57 staged channels; the lists'
# channel starts (a card test holds smem_bytes to the kernel's own count)
_FLOATS_PER_PERSON = topology.NUM_PARTS * 3 + topology.NUM_LIMBS * 6 + topology.NUM_PARTS \
    + topology.NUM_LIMBS
_FLOATS_PER_PIXEL = 1 + topology.NUM_HEAT_CHANNELS + topology.NUM_PAF_CHANNELS
_TILE_PIXELS = 96     # label rows per block: as many whole rows as fit


def tile_rows(label_size: int) -> int:
    """Label rows a block of the kernel takes (2, 92 pixels, at 46 x 46)."""
    return max(1, min(label_size, _TILE_PIXELS // label_size))


def smem_bytes(persons: int, label_size: int) -> int:
    """Shared memory a block of the kernel asks for; raises ``ValueError``
    where that is more than a block of the H100 may hold."""
    need = 4 * (persons * _FLOATS_PER_PERSON + topology.NUM_PARTS + topology.NUM_LIMBS + 2
                + tile_rows(label_size) * label_size * _FLOATS_PER_PIXEL)
    if need > _SMEM_LIMIT:
        raise ValueError(f"create_labels: {persons} persons on a {label_size}-cell grid need "
                         f"{need} bytes of shared memory a block, more than {_SMEM_LIMIT}")
    return need


def reach_rows(joints: np.ndarray, stride: int = 8, sigma: float = 7.0,
               paf_thre: float = 8.0) -> dict[str, np.ndarray]:
    """The kernel's conservative row boxes, in f32 label rows, for (..., 18,
    3) joints: a present part's Gaussian reaches rows ``part_lo ..
    part_hi`` (its cut-off radius in image pixels and one more), a valid
    limb's band rows ``limb_lo .. limb_hi`` (the bone's rows, and thre + 1
    label rows beyond); absent parts and invalid limbs reach none (lo =
    +inf). A block lists a pair for its tile of rows r0 .. r1 when hi >= r0
    and lo <= r1."""
    f = np.float32
    j = np.asarray(joints, f)
    s, off = f(stride), f(stride / 2.0 - 0.5)
    rad = np.sqrt(f(_EXP_CUTOFF) * f(2.0 * sigma * sigma)) + f(1.0)
    present = j[..., 2] < 2.0
    with np.errstate(invalid="ignore", over="ignore"):
        part_lo = np.where(present, (j[..., 1] - rad - off) / s, np.inf).astype(f)
        part_hi = np.where(present, (j[..., 1] + rad - off) / s, -np.inf).astype(f)
        limbs = np.asarray(topology.LIMBS)
        ja, jb = j[..., limbs[:, 0], :], j[..., limbs[:, 1], :]
        ay, by = (ja[..., 1] + f(0.5)) / s - f(0.5), (jb[..., 1] + f(0.5)) / s - f(0.5)
        ax, bx = (ja[..., 0] + f(0.5)) / s - f(0.5), (jb[..., 0] + f(0.5)) / s - f(0.5)
        norm = np.sqrt((bx - ax) * (bx - ax) + (by - ay) * (by - ay))
        ok = (ja[..., 2] < 2.0) & (jb[..., 2] < 2.0) & (norm >= f(1e-8))
        thre = f(paf_thre / float(stride)) + f(1.0)
        limb_lo = np.where(ok, np.minimum(ay, by) - thre, np.inf).astype(f)
        limb_hi = np.where(ok, np.maximum(ay, by) + thre, -np.inf).astype(f)
    return {"part_lo": part_lo, "part_hi": part_hi, "limb_lo": limb_lo, "limb_hi": limb_hi}


class _Params(ctypes.Structure):
    _fields_ = [
        ("batch", ctypes.c_int), ("persons", ctypes.c_int), ("label", ctypes.c_int),
        ("tile_rows", ctypes.c_int),
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
    smem_bytes(persons, label_size)
    jc = joints.detach().to(torch.float32).contiguous()
    mc = mask.detach().to(torch.float32).contiguous()
    paf = torch.empty((n, label_size, label_size, topology.NUM_PAF_CHANNELS),
                      dtype=torch.float32, device=dev)
    heat = torch.empty((n, label_size, label_size, topology.NUM_HEAT_CHANNELS),
                       dtype=torch.float32, device=dev)
    if n == 0:
        return paf, heat
    if n > 65535:
        raise ValueError(f"create_labels: {n} samples exceed the kernel's grid")
    p = _Params()
    p.batch, p.persons, p.label, p.tile_rows = n, persons, label_size, tile_rows(label_size)
    p.stride = float(stride)
    p.half_stride = stride / 2.0
    p.denom = 2.0 * sigma * sigma
    p.thre = paf_thre / float(stride)
    p.limb_a, p.limb_b = _LIMB_A, _LIMB_B
    p.joints, p.mask, p.paf, p.heat = (jc.data_ptr(), mc.data_ptr(),
                                      paf.data_ptr(), heat.data_ptr())
    KERNEL.launch(dev, ctypes.byref(p))
    return paf, heat
