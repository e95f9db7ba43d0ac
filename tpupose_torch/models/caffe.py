"""Minimal Caffe ``.caffemodel`` reader (protobuf wire format, no deps).

The port's own copy of ``tpupose/models/caffe.py`` (numpy only; it imports
nothing of the reference, and ``tests/test_torch_imports.py`` holds it to the
original on the same files). The original pretrained weights of this model
family are the CMU Caffe release, and the Keras lineage kept the Caffe layer
names verbatim, so a parsed caffemodel feeds the same name map as a Keras
``.h5``. This module hand-decodes the protobuf wire format (neither the
protobuf runtime nor caffe is required), extracting
``{layer_name: [blobs...]}`` where each blob is a float32 ndarray with its
declared shape.

Messages handled (caffe.proto):
  NetParameter:     layer = 100 (LayerParameter), layers = 2 (V1Layer)
  LayerParameter:   name = 1 (string), blobs = 7 (BlobProto)
  V1LayerParameter: name = 4 (string), blobs = 6 (BlobProto)
  BlobProto:        data = 5 (packed/unpacked float), shape = 7
                    (BlobShape.dim = 1, varint), legacy num/channels/
                    height/width = 1..4 (varint)

Caffe conv kernels are (out, in, kh, kw); the flax-layout tree that
``models.weights`` overlays wants (kh, kw, in, out): ``blob_to_kernel``
transposes.
"""

from __future__ import annotations

import struct
from typing import Iterator

import numpy as np


def _read_varint(buf: memoryview, i: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _fields(buf: memoryview) -> Iterator[tuple[int, int, memoryview | int]]:
    """Yields (field_number, wire_type, payload) over one message."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:                     # varint
            val, i = _read_varint(buf, i)
            yield field, wire, val
        elif wire == 1:                   # 64-bit
            yield field, wire, buf[i:i + 8]
            i += 8
        elif wire == 2:                   # length-delimited
            ln, i = _read_varint(buf, i)
            yield field, wire, buf[i:i + ln]
            i += ln
        elif wire == 5:                   # 32-bit
            yield field, wire, buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _parse_blob(buf: memoryview) -> np.ndarray:
    data_chunks: list[np.ndarray] = []
    scalars: list[float] = []
    shape: list[int] = []
    legacy = {}
    for field, wire, val in _fields(buf):
        if field == 5:                    # data
            if wire == 2:                 # packed floats
                data_chunks.append(
                    np.frombuffer(bytes(val), dtype="<f4")
                )
            elif wire == 5:               # unpacked float
                scalars.append(struct.unpack("<f", bytes(val))[0])
        elif field == 7 and wire == 2:    # BlobShape
            for f2, w2, v2 in _fields(val):
                if f2 == 1:
                    if w2 == 0:
                        shape.append(int(v2))
                    elif w2 == 2:         # packed dims
                        j = 0
                        while j < len(v2):
                            d, j = _read_varint(v2, j)
                            shape.append(d)
        elif field in (1, 2, 3, 4) and wire == 0:   # legacy n/c/h/w
            legacy[field] = int(val)
    if data_chunks:
        data = np.concatenate(data_chunks) if len(data_chunks) > 1 else data_chunks[0]
    else:
        data = np.asarray(scalars, np.float32)
    if not shape and legacy:
        shape = [legacy.get(k, 1) for k in (1, 2, 3, 4)]
    if shape:
        data = data.reshape(shape)
    return np.asarray(data, np.float32)


def _parse_layer(buf: memoryview, name_field: int, blobs_field: int):
    name = None
    blobs: list[np.ndarray] = []
    for field, wire, val in _fields(buf):
        if field == name_field and wire == 2:
            name = bytes(val).decode("utf-8")
        elif field == blobs_field and wire == 2:
            blobs.append(_parse_blob(val))
    return name, blobs


def parse_caffemodel(path: str) -> dict[str, list[np.ndarray]]:
    """{layer_name: [blob, ...]} for every layer that carries weights."""
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    out: dict[str, list[np.ndarray]] = {}
    for field, wire, val in _fields(buf):
        if wire != 2:
            continue
        if field == 100:                  # LayerParameter
            name, blobs = _parse_layer(val, name_field=1, blobs_field=7)
        elif field == 2:                  # V1LayerParameter
            name, blobs = _parse_layer(val, name_field=4, blobs_field=6)
        else:
            continue
        if name and blobs:
            out[name] = blobs
    return out


def blob_to_kernel(blob: np.ndarray) -> np.ndarray:
    """Caffe conv kernel (out, in, kh, kw) -> flax/Keras (kh, kw, in, out).

    Legacy 4-D blobs for biases come through as (1, 1, 1, n) and are
    flattened by the caller; this helper is for 4-D weight blobs."""
    if blob.ndim != 4:
        raise ValueError(f"expected 4-D conv blob, got shape {blob.shape}")
    return np.transpose(blob, (2, 3, 1, 0))


def caffemodel_layers(path: str) -> dict[str, dict[str, np.ndarray]]:
    """caffemodel -> {layer: {kernel, bias}} in flax layout — the same
    structure ``weights._h5_layer_weights`` produces from a Keras file,
    so both formats share one overlay path."""
    out: dict[str, dict[str, np.ndarray]] = {}
    for name, blobs in parse_caffemodel(path).items():
        entry: dict[str, np.ndarray] = {}
        if blobs and blobs[0].ndim == 4:
            entry["kernel"] = blob_to_kernel(blobs[0])
        elif blobs:
            entry["kernel"] = blobs[0]
        if len(blobs) > 1:
            entry["bias"] = blobs[1].reshape(-1)
        out[name] = entry
    return out
