"""COCO RLE mask codec: ctypes bindings to the native library.

The port's copy of ``tpupose/data/rle.py``. pycocotools is not a
dependency; dataset preparation needs its ``mask`` codec (SURVEY.md C18:
miss-masks from crowd and unannotated person segmentations).
``tpupose_torch/native/rle.c`` reimplements the COCO column-major RLE
conventions; it is built on first use into ``tpupose_torch/_build/``
(``data/_native.py``), and a failed build raises. The pure-NumPy twins
(``decode_np``, ``encode_np``, ``from_string_np``, ``to_string_np``,
``area_np``) are the plain versions the tests hold the library to; no
call reaches them from the library's functions.
"""

from __future__ import annotations

import ctypes

import numpy as np

from tpupose_torch.data import _native

_U32P = ctypes.POINTER(ctypes.c_uint32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _native.load("rle", "rle.c", ["cc", "-O2", "-shared", "-fPIC"])
        lib.rle_decode.restype = ctypes.c_int
        lib.rle_decode.argtypes = [_U32P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P]
        lib.rle_encode.restype = ctypes.c_int
        lib.rle_encode.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, _U32P]
        lib.rle_from_string.restype = ctypes.c_int
        lib.rle_from_string.argtypes = [ctypes.c_char_p, ctypes.c_int, _U32P]
        lib.rle_to_string.restype = ctypes.c_int
        lib.rle_to_string.argtypes = [_U32P, ctypes.c_int, ctypes.c_char_p]
        lib.rle_area.restype = ctypes.c_long
        lib.rle_area.argtypes = [_U32P, ctypes.c_int]
        _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the library builds and loads (its first use builds it)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


# --- counts <-> mask ----------------------------------------------------------


def decode(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    """RLE counts -> (h, w) uint8 mask (COCO column-major semantics)."""
    counts = np.ascontiguousarray(counts, np.uint32)
    out = np.empty(h * w, np.uint8)
    rc = _load().rle_decode(counts.ctypes.data_as(_U32P), len(counts), h, w,
                            out.ctypes.data_as(_U8P))
    if rc != 0:
        raise ValueError("malformed RLE: counts do not cover h*w")
    return out.reshape(w, h).T


def decode_np(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    """NumPy twin of :func:`decode`."""
    counts = np.ascontiguousarray(counts, np.uint32)
    if counts.sum() != h * w:
        raise ValueError("malformed RLE: counts do not cover h*w")
    vals = np.arange(len(counts), dtype=np.uint8) % 2
    flat = np.repeat(vals, counts)
    return flat.reshape(w, h).T


def _column_major(mask: np.ndarray) -> tuple[np.ndarray, int, int]:
    mask = np.ascontiguousarray(np.asarray(mask, np.uint8) > 0).astype(np.uint8)
    h, w = mask.shape
    return np.asfortranarray(mask).T.reshape(-1), h, w


def encode(mask: np.ndarray) -> np.ndarray:
    """(h, w) binary mask -> RLE counts."""
    flat, h, w = _column_major(mask)
    out = np.empty(h * w + 1, np.uint32)
    m = _load().rle_encode(np.ascontiguousarray(flat).ctypes.data_as(_U8P), h, w,
                           out.ctypes.data_as(_U32P))
    return out[:m].copy()


def encode_np(mask: np.ndarray) -> np.ndarray:
    """NumPy twin of :func:`encode`."""
    flat, h, w = _column_major(mask)
    change = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], change, [h * w]])
    runs = np.diff(bounds).astype(np.uint32)
    if flat[0] == 1:  # counts start with a zero-run
        runs = np.concatenate([[np.uint32(0)], runs])
    return runs


# --- counts <-> COCO compressed string ---------------------------------------


def from_string(s: bytes | str) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode("ascii")
    out = np.empty(max(len(s), 1), np.uint32)
    m = _load().rle_from_string(s, len(s), out.ctypes.data_as(_U32P))
    if m < 0:
        raise ValueError("malformed compressed RLE string")
    return out[:m].copy()


def from_string_np(s: bytes | str) -> np.ndarray:
    """Python twin of :func:`from_string` (sequential LEB128 variant with
    delta coding)."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: list[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = 1
        while more:
            if i >= n:
                raise ValueError("malformed compressed RLE string")
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = c & 0x20
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, np.uint32)


def to_string(counts: np.ndarray) -> bytes:
    counts = np.ascontiguousarray(counts, np.uint32)
    buf = ctypes.create_string_buffer(len(counts) * 7 + 1)
    p = _load().rle_to_string(counts.ctypes.data_as(_U32P), len(counts), buf)
    return buf.raw[:p]


def to_string_np(counts: np.ndarray) -> bytes:
    """Python twin of :func:`to_string`."""
    counts = np.ascontiguousarray(counts, np.uint32)
    out = bytearray()
    m = len(counts)
    for i in range(m):
        x = int(counts[i])
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


# --- convenience ---------------------------------------------------------------


def decode_coco(rle_obj: dict) -> np.ndarray:
    """Decode a COCO segmentation dict {'size': [h, w], 'counts': ...}."""
    h, w = rle_obj["size"]
    counts = rle_obj["counts"]
    if isinstance(counts, (bytes, str)):
        counts = from_string(counts)
    return decode(np.asarray(counts, np.uint32), h, w)


def merge(masks: list[np.ndarray]) -> np.ndarray:
    """Union of binary masks."""
    out = np.zeros_like(masks[0], np.uint8)
    for m in masks:
        out |= np.asarray(m, np.uint8) > 0
    return out


def area(counts: np.ndarray) -> int:
    counts = np.ascontiguousarray(counts, np.uint32)
    return int(_load().rle_area(counts.ctypes.data_as(_U32P), len(counts)))


def area_np(counts: np.ndarray) -> int:
    """NumPy twin of :func:`area`."""
    return int(np.ascontiguousarray(counts, np.uint32)[1::2].sum())
