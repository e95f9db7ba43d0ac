"""Scale-sharded multi-scale inference: the pyramid's scales over a mesh.

The port's counterpart of ``tpupose/parallel/pyramid.py``. The scales of
the pyramid are independent, so every scale's image is padded with the
gray ``PAD_NORM`` to the largest scale's canvas, the canvases (for a batch,
all B x S of them) are split over the mesh's entries in mesh order and run
through one replica of the network per entry, and the last stage's maps
come back to the first entry's device, where they are upsampled to the
image size, averaged over the scales (``ops.image.average_upsampled``)
and decoded by the dense full-res decode (``decode_impl[_batch]`` on
materialised maps: the ``peaks`` kernel on the card, never
``pyramid_peaks``).

This program's numbers are its own, as in the reference: the network sees
gray canvas beyond each scale's image where the serial pyramid sees the
per-layer zero padding of a smaller input, so the averaged maps differ
from the serial pyramid's near the image border (the reference measures
the drift in ``tpupose/parallel/pyramid.py:13-28`` and
``tests/test_pyramid_drift.py``). The port matches the reference's
scale-sharded program, not the serial one.

The port's network holds its weights, so the built functions take the
images only (the reference's take ``params`` first), and it compiles
nothing per shape, so the builders take no batch size or image size (the
reference's fix them for its traced program); the replicas are
made once, when a function is built (for ``sharded_process[_batch]``, once
per mesh layout, kept on the estimator: ``sharding.kept_replicas``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from tpupose_torch.config import PoseConfig
from tpupose_torch.decode.api import decode_impl_batch, to_people
from tpupose_torch.ops import image as image_ops
from tpupose_torch.parallel.sharding import (
    Mesh, data_mesh_for_batch, kept_replicas, local_devices, replicate_module,
)


def _canvases(x0: torch.Tensor, sizes) -> torch.Tensor:
    """(B, H, W, 3) normalised images -> (B, S, maxH, maxW, 3): each scale
    resized and padded with the gray value to the largest scale's canvas."""
    max_ph = max(s[2] for s in sizes)
    max_pw = max(s[3] for s in sizes)
    out = []
    for rh, rw, _, _ in sizes:
        x = image_ops.resize_bilinear(x0, rh, rw)
        out.append(F.pad(x, (0, 0, 0, max_pw - rw, 0, max_ph - rh), value=image_ops.PAD_NORM))
    return torch.stack(out, dim=1)


def _program(replicas, devices, cfg: PoseConfig, imgs_u8) -> dict[str, torch.Tensor]:
    """The batched sharded pyramid: (B, H, W, 3) uint8 -> people tables on
    the first entry's device."""
    heat, paf = sharded_maps(replicas, devices, cfg, imgs_u8)
    return decode_impl_batch(heat, paf, cfg.inference)


@torch.inference_mode()
def sharded_maps(replicas, devices, cfg: PoseConfig, imgs_u8) -> tuple[torch.Tensor, torch.Tensor]:
    """The scale-averaged full-res (heat (B, H, W, 19), paf (B, H, W, 38))
    of (B, H, W, 3) uint8 images, the B x S canvases split over
    ``replicas`` (one per entry of ``devices``), on ``devices[0]``: what
    the sharded pyramid decodes."""
    home = devices[0]
    x0 = image_ops.normalize(torch.as_tensor(np.asarray(imgs_u8, np.uint8)).to(home),
                             cfg.model.channel_order)
    b, in_h, in_w = x0.shape[:3]
    sizes = image_ops.pyramid_sizes(cfg.inference, cfg.model, in_h, in_w)
    if (b * len(sizes)) % len(replicas):
        raise ValueError(f"{b * len(sizes)} canvases do not split over "
                         f"{len(replicas)} mesh entries")
    grid = _canvases(x0, sizes)
    flat = grid.reshape(b * len(sizes), *grid.shape[2:])
    pafs, heats = [], []
    for model, dev, chunk in zip(replicas, devices, flat.chunk(len(replicas))):
        paf, heat = model(chunk.to(dev))[-1]
        pafs.append(paf.to(home))
        heats.append(heat.to(home))

    def averaged(maps):
        maps = torch.cat(maps).reshape(b, len(sizes), *maps[0].shape[1:])
        return image_ops.average_upsampled([maps[:, i] for i in range(len(sizes))], sizes,
                                           in_h, in_w, cfg.model.stride)

    return averaged(heats), averaged(pafs)


def build_sharded_pyramid_fn(model: Any, cfg: PoseConfig, mesh: Mesh):
    """Returns fn(img_u8 (H, W, 3)) -> people tables, with the
    pyramid's scales split over the mesh's entries."""
    replicas, devices = replicate_module(model, mesh), list(mesh.devices.flat)

    @torch.inference_mode()
    def run(img_u8) -> dict[str, torch.Tensor]:
        tables = _program(replicas, devices, cfg, np.asarray(img_u8)[None])
        return {k: v[0] for k, v in tables.items()}

    return run


def scale_mesh(n_scales: int, devices=None) -> Mesh:
    """Largest mesh whose size divides the scale count (so the scale
    batch splits evenly)."""
    return data_mesh_for_batch(n_scales, devices=devices)


def data_scale_mesh(n_scale_shards: int, devices=None) -> Mesh:
    """2-D ('data', 'scale') mesh: scales split ``n_scale_shards`` ways,
    the remaining device factor carries the image batch. Over 8 entries
    with 4 scales this is a (2, 4) mesh."""
    devs = list(devices) if devices is not None else local_devices()
    n = len(devs)
    if n % n_scale_shards:
        raise ValueError(
            f"{n} devices do not split into 'scale' shards of "
            f"{n_scale_shards}"
        )
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(n // n_scale_shards, n_scale_shards), ("data", "scale"))


def default_data_scale_mesh(n_scales: int, devices=None) -> Mesh:
    """Largest even ('data', 'scale') factorisation of the devices: the
    scale axis is the biggest divisor of the device count that also
    divides the scale count (8 devices with 3 scales give an (8, 1) mesh)."""
    devs = list(devices) if devices is not None else local_devices()
    s = 1
    for d in range(1, min(n_scales, len(devs)) + 1):
        if n_scales % d == 0 and len(devs) % d == 0:
            s = d
    return data_scale_mesh(s, devs)


def build_sharded_pyramid_batch_fn(model: Any, cfg: PoseConfig, mesh: Mesh):
    """Batched pyramid over a 2-D ('data', 'scale') mesh: returns
    fn(imgs_u8 (B, H, W, 3)) -> batched people tables. The
    B x S canvases (image-major) are split over all entries of the mesh in
    mesh order, so that the data-parallel and the scale-parallel split
    compose in one call; canvas semantics as in
    ``build_sharded_pyramid_fn``. The decode runs once over the whole
    batch, so the peak-overflow switch is batch-wide."""
    replicas, devices = replicate_module(model, mesh), list(mesh.devices.flat)

    @torch.inference_mode()
    def run(imgs_u8) -> dict[str, torch.Tensor]:
        return _program(replicas, devices, cfg, imgs_u8)

    return run


def sharded_process_batch(estimator, images: np.ndarray, mesh: Mesh | None = None) -> list[dict]:
    """Batched multi-scale ``process`` on a 2-D ('data', 'scale') mesh.

    Images beyond a data-axis multiple are padded with blank rows
    (decoded, then dropped), as in ``parallel.inference``."""
    mesh = mesh or default_data_scale_mesh(len(estimator.cfg.inference.scale_search))
    n, h, w = images.shape[:3]
    n_data = mesh.shape["data"]
    n_pad = (n_data - n % n_data) % n_data
    if n_pad:
        blanks = np.zeros((n_pad, h, w, images.shape[3]), images.dtype)
        images = np.concatenate([images, blanks])
    # replicas made outside inference mode, so that block1 packs their weights once
    replicas = kept_replicas(estimator, mesh)
    with torch.inference_mode():
        tables = _program(replicas, list(mesh.devices.flat), estimator.cfg, images)
    host = {k: v.cpu().numpy() for k, v in tables.items()}
    return [{"people": to_people({k: v[i] for k, v in host.items()})} for i in range(n)]


def sharded_process(estimator, image: np.ndarray, mesh: Mesh | None = None) -> dict:
    """Multi-scale ``process`` with the scales spread over the mesh's entries."""
    mesh = mesh or scale_mesh(len(estimator.cfg.inference.scale_search))
    replicas = kept_replicas(estimator, mesh)
    with torch.inference_mode():
        tables = _program(replicas, list(mesh.devices.flat), estimator.cfg,
                          np.asarray(image)[None])
    return {"people": to_people({k: v[0].cpu().numpy() for k, v in tables.items()})}
