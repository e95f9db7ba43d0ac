"""`.tpr` packed-record dataset: writer + native threaded reader.

The port's copy of ``tpupose/data/tpr.py``. HDF5 inflates records behind
h5py's lock on ONE thread, and worker *processes* lose the win to IPC.
This module defines the framework's own record container and binds
``tpupose_torch/native/feed.cpp``, which mmaps the file and decompresses
a whole batch with C++ threads straight into pre-allocated batch arrays
(ctypes drops the GIL for the call).

Layout (little-endian; full spec in `native/feed.cpp`):
  header | record payloads | index table
Each record holds an image blob (H, W, 3 u8), a mask blob (H, W u8) and
a JSON meta blob (joints / center / scale_provided / areas — the same
sample contract as `data/hdf5.py`). Codecs: 0 raw, 1 zlib. Each entry's
`reserved` u64 carries crc32s of the raw image (low 32) and mask (high
32) payloads, verified on every read by both readers (0 = unchecked, so
pre-crc files stay compatible); corrupted bytes raise instead of feeding
plausible wrong pixels to training.

The native library is built on first use into ``tpupose_torch/_build/``
(``data/_native.py``); a failed build raises. ``_PyReader`` (mmap + the
``zlib`` module) is the plain version the tests hold the library to; no
reader falls back to it.

Pre-padded ("static") files — written by ``python -m
tpupose_torch.data.pack_tpr --pre-pad`` — store every record already at
the train geometry (pad_sample applied at pack time), so the feed skips
per-sample cv2 work entirely and `read_batch` IS the batch assembly.
"""

from __future__ import annotations

import ctypes
import json
import mmap
import os
import struct
import zlib
from typing import Iterator

import numpy as np

from tpupose_torch.data import _native

MAGIC = b"TPRECv01"
HEADER = struct.Struct("<8sIIQQ")          # magic, flags, pad, count, index_off
ENTRY = struct.Struct("<8Q4IQ")            # 88 bytes, matches TpfEntry
FLAG_STATIC = 1
CODEC_RAW = 0
CODEC_ZLIB = 1

_ERRORS = {
    -1: "io error",
    -2: "malformed .tpr file",
    -3: "index out of range / undersized buffer",
    -4: "unknown codec id",
    -5: "zlib inflate failure or raw-size mismatch",
    -6: "payload crc32 mismatch (corrupted data)",
}


def _payload_crc(data: bytes) -> int:
    """crc32 of a raw payload, 0 mapped to 1 (0 = 'unchecked' sentinel,
    so pre-crc v01 files keep reading; see native/feed.cpp)."""
    return zlib.crc32(data) or 1

_lib = None


def _load() -> ctypes.CDLL:
    """Build-on-first-use native library (same pattern as data/rle.py)."""
    global _lib
    if _lib is None:
        lib = _native.load("tpufeed", "feed.cpp",
                           ["c++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"],
                           libs=("-lz",))
        lib.tpf_open.restype = ctypes.c_void_p
        lib.tpf_open.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_int)]
        lib.tpf_close.argtypes = [ctypes.c_void_p]
        lib.tpf_count.restype = ctypes.c_uint64
        lib.tpf_count.argtypes = [ctypes.c_void_p]
        lib.tpf_flags.restype = ctypes.c_uint32
        lib.tpf_flags.argtypes = [ctypes.c_void_p]
        lib.tpf_dims.restype = ctypes.c_int
        lib.tpf_dims.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.tpf_meta.restype = ctypes.c_int
        lib.tpf_meta.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                 ctypes.c_char_p, ctypes.c_uint64]
        lib.tpf_read.restype = ctypes.c_int
        lib.tpf_read.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                 ctypes.c_void_p, ctypes.c_void_p]
        lib.tpf_read_batch.restype = ctypes.c_int
        lib.tpf_read_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
            ctypes.c_uint64, ctypes.c_int,
        ]
        _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the library builds and loads (its first use builds it)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _check(rc: int) -> None:
    if rc != 0:
        raise ValueError(f"tpr: {_ERRORS.get(rc, f'error {rc}')}")


class TprWriter:
    """Writes the packed format. Packing is offline, so the writer is
    plain Python (zlib level 1 ~ HDF5 gzip-1 ratio at far faster decode
    through the threaded reader)."""

    def __init__(self, path: str, compression: str | None = "zlib",
                 level: int = 1):
        if compression in (None, "none"):
            self._codec = CODEC_RAW
        elif compression == "zlib":
            self._codec = CODEC_ZLIB
        else:
            raise ValueError(f"unknown compression {compression!r}")
        self._level = level
        self._f = open(path, "wb")
        self._f.write(b"\0" * HEADER.size)      # placeholder header
        self._entries: list[tuple] = []
        self._dims: set[tuple[int, int]] = set()

    def _blob(self, data: bytes) -> tuple[int, int, int, int, int]:
        raw = len(data)
        crc = _payload_crc(data)        # over the RAW bytes
        if self._codec == CODEC_ZLIB:
            data = zlib.compress(data, self._level)
        off = self._f.tell()
        self._f.write(data)
        return off, len(data), raw, self._codec, crc

    def add(self, image: np.ndarray, mask: np.ndarray, meta: dict) -> None:
        image = np.ascontiguousarray(image, np.uint8)
        mask = np.ascontiguousarray(mask, np.uint8)
        h, w = image.shape[:2]
        if image.shape != (h, w, 3) or mask.shape != (h, w):
            raise ValueError(
                f"record shapes must be (H,W,3)/(H,W): {image.shape} "
                f"{mask.shape}"
            )
        io, ic, ir, icod, icrc = self._blob(image.tobytes())
        mo, mc, mr, mcod, mcrc = self._blob(mask.tobytes())
        mb = json.dumps(meta).encode()
        meta_off = self._f.tell()
        self._f.write(mb)
        # reserved u64 = mask crc (high 32) | image crc (low 32)
        reserved = (mcrc << 32) | icrc
        self._entries.append(
            (io, ic, ir, mo, mc, mr, meta_off, len(mb), h, w, icod, mcod,
             reserved)
        )
        self._dims.add((h, w))

    def close(self) -> None:
        index_off = self._f.tell()
        for e in self._entries:
            self._f.write(ENTRY.pack(*e))
        flags = FLAG_STATIC if len(self._dims) <= 1 else 0
        self._f.seek(0)
        self._f.write(
            HEADER.pack(MAGIC, flags, 0, len(self._entries), index_off)
        )
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _PyReader:
    """Pure-Python twin of native/feed.cpp (mmap + zlib module): the
    plain version the tests hold ``TprReader`` to."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        if len(self._mm) < HEADER.size:
            raise ValueError("tpr: malformed .tpr file")
        magic, self.flags, _, self.count, index_off = HEADER.unpack_from(
            self._mm, 0
        )
        if (magic != MAGIC or index_off > len(self._mm)
                or self.count > (len(self._mm) - index_off) // ENTRY.size):
            raise ValueError("tpr: malformed .tpr file")
        self._entries = [
            ENTRY.unpack_from(self._mm, index_off + i * ENTRY.size)
            for i in range(self.count)
        ]

    def _blob(self, off, csize, raw, codec, expect_crc=0):
        data = self._mm[off:off + csize]
        if len(data) != csize:
            raise ValueError("tpr: malformed .tpr file")
        if codec == CODEC_RAW:
            if csize != raw:
                raise ValueError("tpr: malformed .tpr file")
            out = data
        elif codec == CODEC_ZLIB:
            try:
                out = zlib.decompress(data)
            except zlib.error as e:  # match the native reader's ValueError
                raise ValueError(f"tpr: zlib inflate failure ({e})") from e
            if len(out) != raw:
                raise ValueError("tpr: zlib inflate failure")
        else:
            raise ValueError("tpr: unknown codec id")
        if expect_crc != 0 and _payload_crc(out) != expect_crc:
            raise ValueError("tpr: payload crc32 mismatch (corrupted data)")
        return out

    def dims(self, i):
        e = self._entries[i]
        return e[8], e[9]

    def meta_bytes(self, i):
        e = self._entries[i]
        return bytes(self._mm[e[6]:e[6] + e[7]])

    def read_into(self, i, img_out, mask_out):
        e = self._entries[i]
        # format invariant (mirrors native/feed.cpp tpf_read): raw sizes
        # must equal the pixel geometry or the entry is corrupt
        if e[2] != 3 * e[8] * e[9] or e[5] != e[8] * e[9]:
            raise ValueError("tpr: malformed .tpr file")
        if img_out is not None:
            img_out.reshape(-1)[:e[2]] = np.frombuffer(
                self._blob(e[0], e[1], e[2], e[10], e[12] & 0xFFFFFFFF),
                np.uint8,
            )
        if mask_out is not None:
            mask_out.reshape(-1)[:e[5]] = np.frombuffer(
                self._blob(e[3], e[4], e[5], e[11], e[12] >> 32), np.uint8
            )

    def close(self):
        self._mm.close()
        self._f.close()


class TprReader:
    """Random-access reader over the native library.

    `read_batch_into` is the hot path: decompresses `indices` into rows
    of pre-allocated (N, H, W, 3)/(N, H, W) arrays with `threads` C++
    threads (static-geometry files)."""

    def __init__(self, path: str):
        self._path = path
        self._h = None
        self._lib = _load()
        err = ctypes.c_int(0)
        h = self._lib.tpf_open(path.encode(), ctypes.byref(err))
        if not h:
            raise ValueError(
                f"tpr: cannot open {path!r}: "
                f"{_ERRORS.get(err.value, 'io error')}"
            )
        self._h = ctypes.c_void_p(h)
        self.count = int(self._lib.tpf_count(self._h))
        self.flags = int(self._lib.tpf_flags(self._h))

    @property
    def static_shapes(self) -> bool:
        return bool(self.flags & FLAG_STATIC)

    def _check_open(self) -> None:
        # a None handle must never reach the C library (NULL deref)
        if self._h is None:
            raise ValueError("tpr: reader is closed")

    def dims(self, i: int) -> tuple[int, int]:
        self._check_open()
        h = ctypes.c_uint32(0)
        w = ctypes.c_uint32(0)
        ms = ctypes.c_uint64(0)
        _check(self._lib.tpf_dims(self._h, i, ctypes.byref(h),
                                  ctypes.byref(w), ctypes.byref(ms)))
        return h.value, w.value

    def meta(self, i: int) -> dict:
        self._check_open()
        h = ctypes.c_uint32(0)
        w = ctypes.c_uint32(0)
        ms = ctypes.c_uint64(0)
        _check(self._lib.tpf_dims(self._h, i, ctypes.byref(h),
                                  ctypes.byref(w), ctypes.byref(ms)))
        buf = ctypes.create_string_buffer(ms.value)
        _check(self._lib.tpf_meta(self._h, i, buf, ms.value))
        return json.loads(buf.raw[: ms.value])

    def read(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Record i -> (image (H, W, 3) u8, mask (H, W) u8)."""
        h, w = self.dims(i)
        img = np.empty((h, w, 3), np.uint8)
        mask = np.empty((h, w), np.uint8)
        _check(self._lib.tpf_read(
            self._h, i,
            img.ctypes.data_as(ctypes.c_void_p),
            mask.ctypes.data_as(ctypes.c_void_p),
        ))
        return img, mask

    def read_batch_into(
        self,
        indices,
        img_out: np.ndarray | None,
        mask_out: np.ndarray | None,
        threads: int = 8,
    ) -> None:
        """Decompress records `indices[k]` into `img_out[k]`/`mask_out[k]`.

        Out arrays must be C-contiguous uint8 with leading axis
        >= len(indices) and per-row bytes >= each record's raw size
        (exactly equal for static-geometry files)."""
        self._check_open()
        idx = np.ascontiguousarray(indices, np.uint64)
        n = len(idx)
        for name, arr in (("img_out", img_out), ("mask_out", mask_out)):
            if arr is not None:
                if arr.dtype != np.uint8 or not arr.flags.c_contiguous:
                    raise ValueError(f"{name} must be C-contiguous uint8")
                if arr.shape[0] < n:
                    raise ValueError(f"{name} leading axis < batch")
        istride = 0 if img_out is None else img_out[0].nbytes
        mstride = 0 if mask_out is None else mask_out[0].nbytes
        _check(self._lib.tpf_read_batch(
            self._h,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            n,
            None if img_out is None else
            img_out.ctypes.data_as(ctypes.c_void_p),
            istride,
            None if mask_out is None else
            mask_out.ctypes.data_as(ctypes.c_void_p),
            mstride,
            threads,
        ))

    def close(self) -> None:
        if self._h is not None:
            self._lib.tpf_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _meta_from_sample(sample: dict) -> dict:
    meta = {
        "center": np.asarray(sample["center"], np.float64).tolist(),
        "scale_provided": float(sample["scale_provided"]),
        "joints": np.asarray(sample["joints"], np.float64).tolist(),
        "areas": np.asarray(sample["areas"], np.float64).tolist(),
    }
    # eval-side metadata (see hdf5.SampleWriter.add): the original COCO
    # image id and COCOeval ignore regions ride the JSON blob unchanged
    if sample.get("image_id") is not None:
        meta["image_id"] = int(sample["image_id"])
    if sample.get("ignore_regions"):
        meta["ignore_regions"] = [
            [float(v) for v in r] for r in sample["ignore_regions"]
        ]
    return meta


def _sample_from_parts(img: np.ndarray, mask: np.ndarray,
                       meta: dict) -> dict:
    from tpupose_torch.data import hdf5 as hdf5_io

    joints = np.asarray(meta["joints"], np.float32)
    if joints.size == 0:
        joints = joints.reshape(0, 18, 3)
    if "areas" in meta:
        areas = np.asarray(meta["areas"], np.float32)
    else:
        areas = hdf5_io.estimate_areas(joints)
    out = {
        "image": img,
        "mask": mask,
        "joints": joints,
        "center": np.asarray(meta["center"], np.float32),
        "scale_provided": np.float32(meta["scale_provided"]),
        "areas": areas,
    }
    if "image_id" in meta:
        out["image_id"] = int(meta["image_id"])
    if "ignore_regions" in meta:
        out["ignore_regions"] = [list(map(float, r))
                                 for r in meta["ignore_regions"]]
    return out


def write_samples(path: str, samples, compression: str | None = "zlib",
                  level: int = 1) -> int:
    """Pack an iterable of raw-sample dicts (the `data/hdf5.py` reader
    contract) into a .tpr file. Returns the record count."""
    n = 0
    with TprWriter(path, compression=compression, level=level) as w:
        for s in samples:
            mask = np.asarray(s["mask"])
            if mask.dtype != np.uint8:
                mask = np.round(np.asarray(mask, np.float32)
                                * (255.0 if mask.max() <= 1.0 else 1.0)
                                ).astype(np.uint8)
            w.add(np.asarray(s["image"], np.uint8), mask,
                  _meta_from_sample(s))
            n += 1
    return n


def read_samples(path: str, shuffle_seed: int | None = None) -> Iterator[dict]:
    """Streaming reader yielding the same raw-sample dicts as
    `hdf5.read_samples` — .tpr files drop into every existing pipeline."""
    with TprReader(path) as r:
        order = np.arange(r.count)
        if shuffle_seed is not None:
            order = np.random.default_rng(shuffle_seed).permutation(order)
        for i in order:
            img, mask = r.read(int(i))
            yield _sample_from_parts(img, mask, r.meta(int(i)))


def num_samples(path: str) -> int:
    with TprReader(path) as r:
        return r.count
