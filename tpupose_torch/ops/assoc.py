"""Association: greedy connection accept + limb-major skeleton assembly.

Counterpart of ``tpupose/ops/pallas_assoc.py``. ``assoc`` launches
``csrc/assoc.cu`` for CUDA tensors and runs ``assoc_plain`` for CPU
tensors. Both are bit-equal to the reference's ``paf._greedy_accept`` +
``assemble.assemble`` (same tie-breaks, same f32 addition order), and both
are the registered operator ``tpupose_torch::assoc``, which takes the
skeleton by name (the kernel is instantiated at 18 and 25 parts).
"""

from __future__ import annotations

import ctypes

import torch

from tpupose_torch.decode import assemble as _assemble
from tpupose_torch.decode import paf as _paf
from tpupose_torch.ops._build import CudaKernel
from tpupose_torch.skeletons import COCO18, SKELETONS, Skeleton

_MAX_SLOTS = 1024   # csrc/assoc.cu kMaxSlots: a K-bit set over a warp's 32 lanes
_SMEM_LIMIT = 227 * 1024


def smem_bytes(limbs: int, n_conn: int, max_people: int, k_slots: int, parts: int = 18) -> int:
    """Shared memory a block of the kernel asks for (the accepted
    connections, the people table, its index from peaks to rows); raises
    ``ValueError`` where that is more than a block of the H100 may hold."""
    p = max_people
    need = (5 * limbs * n_conn * 4 + limbs * 4 + parts * (p + 1) * 4 + 3 * p * 4
            + parts * k_slots * 4 + p)
    if need > _SMEM_LIMIT:
        raise ValueError(f"assoc: {n_conn} connections a limb, {p} people and {k_slots} peak "
                         f"slots need {need} bytes of shared memory a block, more than "
                         f"{_SMEM_LIMIT}")
    return need


_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel(
    "assoc", "tp_assoc",
    [_P, _P, _P, _P, _P, _P, _P, _I, ctypes.c_uint, _I, _I, _I, _I, _I, _I,
     _P, _P, _P, _P, _P, _P],
    replaces="tpupose/ops/pallas_assoc.py:251",
)

_PART_PAIRS: dict = {}  # (L, 2) int32 decode-order part pairs per skeleton and device


def _part_pairs(skeleton: Skeleton, device) -> torch.Tensor:
    key = (skeleton.name, str(device))
    if key not in _PART_PAIRS:
        pairs = skeleton.limb_tables()[0]
        _PART_PAIRS[key] = torch.as_tensor(pairs, dtype=torch.int32).to(device)
    return _PART_PAIRS[key]


def assoc_plain(ts, ta, tb, sa, sb, limits, k_slots: int, n_conn: int,
                max_people: int, skeleton: Skeleton = COCO18) -> dict[str, torch.Tensor]:
    """The two sequential stages in torch, vectorised over images:
    ``paf.greedy_accept`` then ``assemble.assemble`` (see ``assoc``)."""
    conns = _paf.greedy_accept(ts, ta, tb, sa, sb, limits, k_slots, n_conn, skeleton)
    return _assemble.assemble(conns, max_people, skeleton)


_KEYS = ("rows", "score", "cnt", "active", "stamp")


@torch.library.custom_op("tpupose_torch::assoc", mutates_args=(), device_types="cpu")
def _assoc_op(ts: torch.Tensor, ta: torch.Tensor, tb: torch.Tensor, sa: torch.Tensor,
              sb: torch.Tensor, limits: torch.Tensor, k_slots: int, n_conn: int,
              max_people: int, skeleton: str = "coco18"
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    out = assoc_plain(ts, ta, tb, sa, sb, limits, k_slots, n_conn, max_people,
                      SKELETONS[skeleton])
    return tuple(out[key].contiguous() for key in _KEYS)


@_assoc_op.register_kernel("cuda")
def _assoc_cuda(ts, ta, tb, sa, sb, limits, k_slots, n_conn, max_people, skeleton="coco18"):
    b, n_limbs, cap = ts.shape
    dev = ts.device
    skel = SKELETONS[skeleton]
    if k_slots > _MAX_SLOTS:
        raise ValueError(f"assoc: {k_slots} peak slots; the kernel's used-slot sets hold "
                         f"{_MAX_SLOTS}")
    smem_bytes(n_limbs, n_conn, max_people, k_slots, skel.num_parts)
    f32 = [t.to(torch.float32).contiguous() for t in (ts, sa, sb)]
    i32 = [t.to(torch.int32).contiguous() for t in (ta, tb, limits)]
    out = _assoc_fake(ts, ta, tb, sa, sb, limits, k_slots, n_conn, max_people, skeleton)
    if b:
        KERNEL.launch(
            dev, f32[0].data_ptr(), i32[0].data_ptr(), i32[1].data_ptr(),
            f32[1].data_ptr(), f32[2].data_ptr(), i32[2].data_ptr(),
            _part_pairs(skel, dev).data_ptr(), skel.num_parts, skel.seed_mask, b, n_limbs, cap,
            k_slots, n_conn, max_people, *(t.data_ptr() for t in out),
        )
    return out


@_assoc_op.register_fake
def _assoc_fake(ts, ta, tb, sa, sb, limits, k_slots, n_conn, max_people, skeleton="coco18"):
    b, p = ts.shape[0], max_people
    return (ts.new_empty((b, p, SKELETONS[skeleton].num_parts), dtype=torch.int32),
            ts.new_empty((b, p), dtype=torch.float32),
            ts.new_empty((b, p), dtype=torch.int32),
            ts.new_empty((b, p), dtype=torch.bool),
            ts.new_empty((b, p), dtype=torch.int32))


def assoc(ts, ta, tb, sa, sb, limits, k_slots: int, n_conn: int,
          max_people: int, skeleton: Skeleton = COCO18) -> dict[str, torch.Tensor]:
    """Greedy accept + assembly for a batch of images over ``skeleton``'s
    L decode limbs and its parts.

    ts (B, L, CAP) f32 score-sorted candidate priors (-inf = none), ta/tb
    (B, L, CAP) int A/B peak slots, sa/sb (B, L, CAP) f32 endpoint peak
    scores, limits (B, L) int = min(n_a, n_b). Returns the raw people
    table: rows (B, P, parts) int32 global peak ids (part * k_slots + slot,
    -1 = none), score (B, P) f32, cnt (B, P) int32, active (B, P) bool,
    stamp (B, P) int32 creation order — feed to
    ``assemble.cull_and_compact``. CPU tensors take ``assoc_plain``; CUDA
    tensors the kernel. Both are the operator ``tpupose_torch::assoc``.
    """
    b, n_limbs, cap = ts.shape
    if n_limbs != skeleton.num_limbs or SKELETONS.get(skeleton.name) != skeleton:
        raise ValueError(f"assoc: {n_limbs} limbs over the skeleton {skeleton.name!r}")
    for t in (ta, tb, sa, sb):
        if tuple(t.shape) != (b, n_limbs, cap):
            raise ValueError(f"assoc: candidate table {tuple(t.shape)}")
    if tuple(limits.shape) != (b, n_limbs):
        raise ValueError(f"assoc: limits {tuple(limits.shape)}")
    if not (1 <= max_people <= 1024 and 1 <= n_conn and 1 <= k_slots):
        raise ValueError("assoc: need 1 <= max_people <= 1024, n_conn, k_slots >= 1")
    dev = ts.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"assoc: unsupported device {dev}")
    if dev.type == "cuda" and any(t.device != dev for t in (ta, tb, sa, sb, limits)):
        raise ValueError("assoc: inputs on different devices")
    return dict(zip(_KEYS, _assoc_op(ts, ta, tb, sa, sb, limits, k_slots, n_conn, max_people,
                                     skeleton.name)))
