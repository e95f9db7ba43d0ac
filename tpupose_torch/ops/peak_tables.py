"""The decode's sorted peak tables: the best K of each row of masked scores.

Replaces no TPU kernel: the JAX package takes these tables from the
library's ``lax.top_k`` (``tpupose/decode/peaks.py:354``). ``peak_tables``
launches ``csrc/peak_tables.cu`` for CUDA tensors, a selection that reads
each score once, and runs the plain version, ``decode.peaks.
sorted_tables_plain`` (a stable sort of an f64 key of every score), for
CPU tensors. The two agree bit for bit. Both are the registered operator
``tpupose_torch::peak_tables``.
"""

from __future__ import annotations

import ctypes

import torch

from tpupose_torch.decode import peaks as _peaks
from tpupose_torch.ops._build import CudaKernel

MAX_K = 256           # csrc/peak_tables.cu kMaxK
MIN_CHUNK = 8192      # the fewest scores a block of the first stage streams
_BLOCKS_PER_SM = 8    # 1-2 waves of the 6 blocks an SM holds

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel(
    "peak_tables", "tp_peak_tables",
    [_P, _I, ctypes.c_longlong, _I, _I, _I, _P, _P, _P, _P, _P],
    replaces="none (lax.top_k, tpupose/decode/peaks.py:354)",
)


def chunk_count(rows: int, n: int, sms: int) -> int:
    """Blocks the first stage splits a row of ``n`` scores over: about 8
    an SM over all ``rows``, each streaming at least ``MIN_CHUNK`` scores."""
    return max(1, min(-(-_BLOCKS_PER_SM * sms // rows), n // MIN_CHUNK))


@torch.library.custom_op("tpupose_torch::peak_tables", mutates_args=(), device_types="cpu")
def _tables_op(flat: torch.Tensor, w: int, max_peaks: int) -> tuple[
        torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    out = _peaks.sorted_tables_plain(flat, w, max_peaks)
    return tuple(out[key].contiguous() for key in _peaks.TABLE_KEYS)


@_tables_op.register_kernel("cuda")
def _tables_cuda(flat, w, max_peaks):
    return launch(flat, w, max_peaks)


@_tables_op.register_fake
def _tables_fake(flat, w, max_peaks):
    r, n = flat.shape
    k = min(n, max_peaks)
    return (flat.new_empty((r, k), dtype=torch.int32), flat.new_empty((r, k), dtype=torch.int32),
            flat.new_empty((r, k)), flat.new_empty((r, k), dtype=torch.bool))


def launch(flat: torch.Tensor, w: int, max_peaks: int, chunks: int | None = None):
    """The kernel on a CUDA tensor: (xs, ys, scores, valid). ``chunks``
    overrides ``chunk_count`` (tests reach the second stage's merges at
    small shapes with it)."""
    if flat.dtype != torch.float32:
        raise ValueError(f"peak_tables: the kernel takes float32 scores, not {flat.dtype}")
    if max_peaks > MAX_K:
        raise ValueError(f"peak_tables: {max_peaks} peaks a row; the kernel keeps at most {MAX_K}")
    rows, n = flat.shape
    if n > 2 ** 30:
        raise ValueError(f"peak_tables: {n} scores a row; the kernel takes at most 2^30")
    out = _tables_fake(flat, w, max_peaks)
    if out[0].numel() == 0:
        return out
    dev = flat.device
    if chunks is None:
        chunks = chunk_count(rows, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    if rows * chunks >= 2 ** 31 or chunks * max_peaks > 2 ** 30:
        raise ValueError(f"peak_tables: {rows} rows of {chunks} chunks exceed the kernel's grid")
    x = flat.detach().contiguous()
    lists = torch.empty((rows * chunks * max_peaks,), dtype=torch.int64, device=dev)
    KERNEL.launch(dev, x.data_ptr(), rows, n, w, max_peaks, chunks, lists.data_ptr(),
                  *(t.data_ptr() for t in out))
    return out


def peak_tables(flat: torch.Tensor, w: int, max_peaks: int) -> dict[str, torch.Tensor]:
    """(R, N) masked scores (-inf off-peak) -> (R, min(N, K)) tables in
    score-descending order: xs/ys int32 (index % w, index // w), scores
    (0 where not finite) and valid bool. Equal scores (+0.0 and -0.0 among
    them) rank lowest index first; -inf ranks below every finite score and
    NaN, of any bits, last. CPU tensors take ``decode.peaks.
    sorted_tables_plain``, CUDA tensors the kernel (float32 scores, K at
    most ``MAX_K``). Both are the operator ``tpupose_torch::peak_tables``."""
    if flat.dim() != 2:
        raise ValueError(f"peak_tables: scores {tuple(flat.shape)}, want (R, N)")
    if flat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"peak_tables: unsupported device {flat.device}")
    if max_peaks < 1 or w < 1:
        raise ValueError(f"peak_tables: {max_peaks} peaks a row, rows {w} wide")
    return dict(zip(_peaks.TABLE_KEYS, _tables_op(flat, int(w), int(max_peaks))))
