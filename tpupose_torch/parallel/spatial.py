"""Spatially tiled CNN inference: image rows split over a mesh, with halos.

The port's counterpart of ``tpupose/parallel/spatial.py``. The JAX
package annotates the activations' height as sharded and lets XLA's
partitioner insert the halo exchanges; here they are written out. The
image height is split into tiles, one per mesh entry, each a run of whole
rows of the stride-8 output grid (as even as the rows allow: 1104 rows
give 138 over 8 tiles as 17 or 18 each), so that every tile boundary is
even at every 2x2 pool. Each layer runs tile by tile on the tile's entry,
with one replica of the network per entry, and before every layer that
reads neighbouring rows the tile takes them from its neighbours (a halo:
1 row for a 3x3 conv, 3 for a 7x7; zeros beyond the image, the convs'
own padding). A tile with fewer rows than the halo takes them from
further tiles.

Block 1 in bf16 goes through ``ops.block1`` (the ``block1`` kernel on a
CUDA tile): its input is the tile plus a 2-row halo on each inner side,
the kernel zero-pads that input's edges as the convs pad the image's, and
the one pooled row on each inner side that the padding spoiled is cropped.

The decode is the scale-space decode of the per-scale outputs, as in the
reference (``tpupose/parallel/spatial.py:96-102``): ``pyramid_peaks`` and
``sample`` on the card.

Use: images whose activations exceed one device's memory, or single-image
latency spread over several devices. On a 1-entry mesh this is the
serial program.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from tpupose_torch.decode.api import decode_impl_batch, to_people
from tpupose_torch.decode.scalespace import ScaleSpace
from tpupose_torch.ops import image as image_ops
from tpupose_torch.parallel.sharding import Mesh, local_devices, make_mesh, replicate_module

STRIDE = 8          # the network's output stride: three 2x2 pools


def spatial_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (default
    ``local_devices()``), axis 'spatial'."""
    devs = list(devices) if devices is not None else local_devices()
    return make_mesh(n_devices or len(devs), "spatial", devs)


def tile_bounds(rows: int, n_tiles: int) -> list[int]:
    """Boundaries of ``min(n_tiles, rows)`` non-empty runs of ``rows``,
    as even as they allow: [0, ..., rows]."""
    n = max(1, min(n_tiles, rows))
    return [rows * t // n for t in range(n + 1)]


class _Tiles:
    """An NCHW activation split by rows: ``parts[t]`` holds rows
    [bounds[t], bounds[t + 1]) on ``devices[t]``."""

    def __init__(self, parts, bounds, devices):
        self.parts, self.bounds, self.devices = list(parts), list(bounds), list(devices)

    def rows(self, a: int, b: int, t: int) -> torch.Tensor:
        """Rows [a, b) of the whole activation on tile t's device, zero rows
        where they lie outside it."""
        height = self.bounds[-1]
        pieces = []
        for u, part in enumerate(self.parts):
            lo, hi = max(a, self.bounds[u]), min(b, self.bounds[u + 1])
            if lo < hi:
                pieces.append(part[:, :, lo - self.bounds[u]:hi - self.bounds[u]]
                              .to(self.devices[t]))
        x = torch.cat(pieces, dim=2)
        return F.pad(x, (0, 0, max(0, -a), max(0, b - height)))

    def halo(self, t: int, h: int) -> torch.Tensor:
        return self.rows(self.bounds[t] - h, self.bounds[t + 1] + h, t)

    def map(self, fn) -> "_Tiles":
        return _Tiles([fn(p) for p in self.parts], self.bounds, self.devices)

    def gather(self) -> torch.Tensor:
        home = self.devices[0]
        return torch.cat([p.to(home) for p in self.parts], dim=2)


def _conv(tiles: _Tiles, convs, name: str, dtype, relu: bool = True) -> _Tiles:
    """A SAME conv over every tile (``convs[t]``: the tile's replica's
    module ``name``), each tile reading its halo."""
    out = []
    for t in range(len(tiles.parts)):
        conv = convs[t].get_submodule(name)
        h = conv.weight.shape[-1] // 2
        y = conv(tiles.halo(t, h) if h else tiles.parts[t], dtype, pad_rows=False)
        out.append(torch.relu(y) if relu else y)
    return _Tiles(out, tiles.bounds, tiles.devices)


def _pool(tiles: _Tiles) -> _Tiles:
    pooled = tiles.map(lambda p: F.max_pool2d(p, 2))
    pooled.bounds = [b // 2 for b in tiles.bounds]
    return pooled


def _block1(tiles: _Tiles, models) -> _Tiles:
    """Block 1 through ``ops.block1``: each tile with a 2-row input halo
    on its inner sides, the pooled row the kernel's edge padding spoiled
    cropped on each of them."""
    out, last = [], len(tiles.parts) - 1
    for t, model in enumerate(models):
        top, bottom = 2 * (t > 0), 2 * (t < last)
        x = tiles.rows(tiles.bounds[t] - top, tiles.bounds[t + 1] + bottom, t)
        y = model.vgg.block1(x)
        out.append(y[:, :, top // 2:y.shape[2] - bottom // 2])
    return _Tiles(out, [b // 2 for b in tiles.bounds], tiles.devices)


def tiled_forward(models, devices, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The last stage's (paf, heat) of normalised NHWC images ``x`` (H and
    W multiples of 8), the rows split over ``models`` (one replica per
    device, in order; fewer tiles where the output grid has fewer rows);
    NHWC outputs on ``devices[0]``."""
    net = models[0]
    if x.shape[1] % STRIDE or x.shape[2] % STRIDE:
        raise ValueError(f"tiled_forward: {tuple(x.shape)} is not a multiple of {STRIDE}")
    bounds = [b * STRIDE for b in tile_bounds(x.shape[1] // STRIDE, len(models))]
    n = len(bounds) - 1
    models, devices = models[:n], devices[:n]
    nchw = x.permute(0, 3, 1, 2)
    tiles = _Tiles([nchw[:, :, bounds[t]:bounds[t + 1]].to(devices[t]) for t in range(n)],
                   bounds, devices)
    dtype = net.dtype
    if net.vgg.fuses_block1(x.shape[1], x.shape[2]):
        tiles = _block1(tiles, models)
    else:
        tiles = _pool(_conv(_conv(tiles, models, "vgg.conv1_1", dtype), models, "vgg.conv1_2",
                            dtype))
    for names in (("conv2_1", "conv2_2"), ("conv3_1", "conv3_2", "conv3_3", "conv3_4")):
        for name in names:
            tiles = _conv(tiles, models, f"vgg.{name}", dtype)
        tiles = _pool(tiles)
    for name in ("vgg.conv4_1", "vgg.conv4_2", "cpm.conv4_3_CPM", "cpm.conv4_4_CPM"):
        tiles = _conv(tiles, models, name, dtype)
    feat = tiles

    def branch(inputs: _Tiles, name: str, n_convs: int) -> _Tiles:
        for i in range(n_convs):
            inputs = _conv(inputs, models, f"{name}.conv{i + 1}", dtype)
        return _conv(inputs, models, f"{name}.out", net.stage1_L1.head_dtype, relu=False)

    paf, heat = branch(feat, "stage1_L1", 4), branch(feat, "stage1_L2", 4)
    for t in range(2, net.num_stages + 1):
        x_t = _Tiles([torch.cat([p.to(dtype), h.to(dtype), f], dim=1) for p, h, f in
                      zip(paf.parts, heat.parts, feat.parts)], feat.bounds, feat.devices)
        paf, heat = branch(x_t, f"stage{t}_L1", 6), branch(x_t, f"stage{t}_L2", 6)
    return paf.gather().permute(0, 2, 3, 1), heat.gather().permute(0, 2, 3, 1)


def build_spatial_forward(model: Any, mesh: Mesh):
    """fn(x_norm (N, H, W, 3)) -> final-stage (paf, heat), NHWC on the
    mesh's first device, with every activation split along H over the
    'spatial' mesh axis. The network is replicated once per entry here
    (the port's network holds its weights, so fn takes no ``params``)."""
    models, devices = replicate_module(model, mesh), list(mesh.devices.flat)

    @torch.inference_mode()
    def run(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return tiled_forward(models, devices, x)

    return run


class SpatialPoseEstimator:
    """Single-image multi-scale inference with spatially tiled forwards.

    Mirrors ``PoseEstimator.process`` but runs each pyramid scale's
    network tiled over the mesh; the decode runs on the first entry's
    device on the per-scale outputs (the scale-space decode). On a
    1-entry mesh it is the serial program.
    """

    def __init__(self, estimator, mesh: Mesh | None = None):
        self.est = estimator
        self.mesh = mesh or spatial_mesh(devices=local_devices(estimator.device))
        self._fwd = build_spatial_forward(self.est.model, self.mesh)

    @torch.inference_mode()
    def process(self, image: np.ndarray) -> dict:
        mcfg = self.est.cfg.model
        h, w = image.shape[:2]
        sizes = image_ops.pyramid_sizes(self.est.cfg.inference, mcfg, h, w)
        home = self.mesh.devices.flat[0]
        x0 = image_ops.normalize(torch.as_tensor(np.asarray(image, np.uint8)).to(home),
                                 mcfg.channel_order)
        heats, pafs = [], []
        for rh, rw, _, _ in sizes:
            x = image_ops.resize_bilinear(x0, rh, rw)
            x, _ = image_ops.pad_right_down(x, mcfg.stride, image_ops.PAD_NORM)
            paf, heat = self._fwd(x[None])
            heats.append(heat)
            pafs.append(paf)
        geoms = [s[:2] for s in sizes]
        tables = decode_impl_batch(ScaleSpace(heats, geoms, (h, w)),
                                   ScaleSpace(pafs, geoms, (h, w)), self.est.cfg.inference)
        return {"people": to_people({k: v[0].cpu().numpy() for k, v in tables.items()})}
