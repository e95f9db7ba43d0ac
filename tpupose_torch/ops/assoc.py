"""Association: greedy connection accept + limb-major skeleton assembly.

Counterpart of ``tpupose/ops/pallas_assoc.py``. ``assoc`` launches
``csrc/assoc.cu`` for CUDA tensors and runs ``assoc_plain`` for CPU
tensors. Both are bit-equal to the reference's ``paf._greedy_accept`` +
``assemble.assemble`` (same tie-breaks, same f32 addition order).
"""

from __future__ import annotations

import ctypes

import torch

from tpupose import topology
from tpupose_torch.decode import assemble as _assemble
from tpupose_torch.decode import paf as _paf
from tpupose_torch.ops._build import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel(
    "assoc", "tp_assoc",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    replaces="tpupose/ops/pallas_assoc.py:251",
)

_PART_PAIRS: dict = {}  # (L, 2) int32 decode-order part pairs per device


def _part_pairs(device) -> torch.Tensor:
    key = str(device)
    if key not in _PART_PAIRS:
        pairs = topology.decode_limb_tables()[0]
        _PART_PAIRS[key] = torch.as_tensor(pairs, dtype=torch.int32).to(device)
    return _PART_PAIRS[key]


def assoc_plain(ts, ta, tb, sa, sb, limits, k_slots: int, n_conn: int,
                max_people: int) -> dict[str, torch.Tensor]:
    """The two sequential stages in torch, vectorised over images:
    ``paf.greedy_accept`` then ``assemble.assemble`` (see ``assoc``)."""
    conns = _paf.greedy_accept(ts, ta, tb, sa, sb, limits, k_slots, n_conn)
    return _assemble.assemble(conns, max_people)


def assoc(ts, ta, tb, sa, sb, limits, k_slots: int, n_conn: int,
          max_people: int) -> dict[str, torch.Tensor]:
    """Greedy accept + assembly for a batch of images.

    ts (B, 19, CAP) f32 score-sorted candidate priors (-inf = none), ta/tb
    (B, 19, CAP) int A/B peak slots, sa/sb (B, 19, CAP) f32 endpoint peak
    scores, limits (B, 19) int = min(n_a, n_b). Returns the raw people
    table: rows (B, P, 18) int32 global peak ids (part * k_slots + slot,
    -1 = none), score (B, P) f32, cnt (B, P) int32, active (B, P) bool,
    stamp (B, P) int32 creation order — feed to
    ``assemble.cull_and_compact``. CPU tensors take ``assoc_plain``; CUDA
    tensors the kernel.
    """
    b, n_limbs, cap = ts.shape
    if n_limbs != topology.NUM_LIMBS:
        raise ValueError(f"assoc: {n_limbs} limbs")
    for t in (ta, tb, sa, sb):
        if tuple(t.shape) != (b, n_limbs, cap):
            raise ValueError(f"assoc: candidate table {tuple(t.shape)}")
    if tuple(limits.shape) != (b, n_limbs):
        raise ValueError(f"assoc: limits {tuple(limits.shape)}")
    if not (1 <= max_people <= 1024 and 1 <= n_conn and 1 <= k_slots):
        raise ValueError("assoc: need 1 <= max_people <= 1024, n_conn, k_slots >= 1")
    dev = ts.device
    if dev.type == "cpu":
        return assoc_plain(ts, ta, tb, sa, sb, limits, k_slots, n_conn, max_people)
    if dev.type != "cuda":
        raise ValueError(f"assoc: unsupported device {dev}")
    f32 = [t.to(torch.float32).contiguous() for t in (ts, sa, sb)]
    i32 = [t.to(torch.int32).contiguous() for t in (ta, tb, limits)]
    if any(t.device != dev for t in f32 + i32):
        raise ValueError("assoc: inputs on different devices")
    p = max_people
    out = {
        "rows": torch.empty((b, p, topology.NUM_PARTS), dtype=torch.int32, device=dev),
        "score": torch.empty((b, p), dtype=torch.float32, device=dev),
        "cnt": torch.empty((b, p), dtype=torch.int32, device=dev),
        "active": torch.empty((b, p), dtype=torch.bool, device=dev),
        "stamp": torch.empty((b, p), dtype=torch.int32, device=dev),
    }
    if b:
        KERNEL.launch(
            f32[0].data_ptr(), i32[0].data_ptr(), i32[1].data_ptr(),
            f32[1].data_ptr(), f32[2].data_ptr(), i32[2].data_ptr(),
            _part_pairs(dev).data_ptr(), b, n_limbs, cap, k_slots, n_conn, p,
            out["rows"].data_ptr(), out["score"].data_ptr(), out["cnt"].data_ptr(),
            out["active"].data_ptr(), out["stamp"].data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    return out
