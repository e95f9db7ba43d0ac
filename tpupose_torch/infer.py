"""Public inference API: images -> people keypoint JSON.

Counterpart of ``tpupose/infer.py``: normalise -> per pyramid scale
resize + pad + the network's last stage -> decode -> ``to_people``.
``cfg.inference.paf_readout`` selects what the decode reads:

  ``"scalespace"`` (the default): the per-scale low-res outputs stay a
      ``ScaleSpace`` and are never upsampled;
  ``"fullres"`` (the reference's literal pipeline): every scale's output
      is upsampled to the image size (``ops.image.upsample_to_batch``)
      and averaged in f32, and the decode reads the materialised maps.
      ``maps_batch`` returns those averaged maps, ``maps`` for one image.

Images cross to the device as uint8; only the people and peak tables
come back.

The estimator runs where ``device`` says and never silently elsewhere:
``device="cuda"`` without a CUDA device raises. On CUDA the kernels of
``tpupose_torch/csrc`` carry block 1 of every forward, the peak scores
(``pyramid_peaks`` or, on full-res maps, ``peaks``), the scale-space PAF
point readout and the association; on the CPU their plain PyTorch
versions do. Constructing an estimator turns TF32 off for cuDNN
convolutions and CUDA matmuls process-wide: the f32 heads and the
decode's f32 products are f32, as in the reference.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator

import numpy as np
import torch

from tpupose_torch.config import DEFAULT, PoseConfig
from tpupose_torch.decode.api import decode_impl_batch, to_people
from tpupose_torch.decode.scalespace import ScaleSpace
from tpupose_torch.models import OpenPose, weights as weights_lib
from tpupose_torch.models.openpose import DTYPES
from tpupose_torch.ops import image as image_ops


READOUTS = ("scalespace", "fullres")


class PoseEstimator:
    """Builds the network once; ``process_batch`` is the product path.

    ``params``: a flax-layout parameter tree (nested dict of numpy
    arrays, e.g. the reference estimator's ``params``); None builds the
    flax-default random init from ``seed`` and overlays ``weights_path``
    (a reference ``.h5``, ``.caffemodel`` or torch ``.pth``/``.pt``, see
    ``models.weights.maybe_load_pretrained``) where that file exists.
    ``pretrained`` says whether the weights came from ``params`` or a file.
    """

    def __init__(self, cfg: PoseConfig = DEFAULT, params: Any | None = None,
                 weights_path: str | None = None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PoseEstimator(device='cuda'): no CUDA device is available")
        if cfg.inference.paf_readout not in READOUTS:
            raise ValueError(f"unknown paf_readout {cfg.inference.paf_readout!r}: "
                             f"one of {READOUTS}")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.model = OpenPose(num_stages=cfg.model.num_stages,
                              dtype=DTYPES[cfg.model.compute_dtype],
                              pallas_block1=True)
        if params is None:
            self.model.reset_parameters(torch.Generator().manual_seed(seed))
            self.pretrained = False
            if weights_path:
                params, self.pretrained = weights_lib.maybe_load_pretrained(
                    weights_lib.to_flax(self.model.state_dict()), weights_path)
                if self.pretrained:
                    self.model.load_state_dict(weights_lib.from_flax(params))
        else:
            self.model.load_state_dict(weights_lib.from_flax(params))
            self.pretrained = True
        self.model.to(self.device, memory_format=torch.channels_last).eval()

    # --- the batched program ---------------------------------------------------

    def _low_res(self, images: np.ndarray, scales):
        """The network's last stage at every pyramid scale: (sizes, heats,
        pafs), per scale (N, ph/8, pw/8, 19) and (N, ph/8, pw/8, 38)."""
        h, w = images.shape[1:3]
        mcfg = self.cfg.model
        scales = tuple(scales) if scales else self.cfg.inference.scale_search
        sizes = image_ops.scale_sizes(h, w, scales, mcfg.boxsize, mcfg.stride)
        host = torch.from_numpy(np.ascontiguousarray(images, dtype=np.uint8))
        if self.device.type == "cuda":
            host = host.pin_memory()
        x0 = image_ops.normalize(host.to(self.device, non_blocking=True), mcfg.channel_order)
        heats, pafs = [], []
        for rh, rw, _, _ in sizes:
            x = image_ops.resize_bilinear(x0, rh, rw)
            x, _ = image_ops.pad_right_down(x, mcfg.stride, image_ops.PAD_NORM)
            paf, heat = self.model(x)[-1]
            heats.append(heat)
            pafs.append(paf)
        return sizes, heats, pafs

    @torch.inference_mode()
    def _run(self, images: np.ndarray, scales, valid_hw) -> dict[str, torch.Tensor]:
        if self.cfg.inference.paf_readout == "fullres":
            heat_in, paf_in = self.maps_batch(images, scales)
        else:
            h, w = images.shape[1:3]
            sizes, heats, pafs = self._low_res(images, scales)
            geoms = [s[:2] for s in sizes]
            heat_in = ScaleSpace(heats, geoms, (h, w))
            paf_in = ScaleSpace(pafs, geoms, (h, w))
        return decode_impl_batch(heat_in, paf_in, self.cfg.inference, valid_hw)

    # --- public API --------------------------------------------------------------

    def process_batch(self, images: np.ndarray, scales: tuple[float, ...] | None = None,
                      valid_hw: np.ndarray | None = None) -> list[list[dict]]:
        """(N, H, W, 3) uint8 -> people per image. Runs the configured
        pyramid unless ``scales`` narrows it; ``valid_hw`` ((N, 2) int)
        marks each image's top-left valid rectangle in a padded canvas."""
        n, tables = self.process_batch_async(images, scales, valid_hw)
        return self._finish(n, tables)

    def process_batch_async(self, images: np.ndarray, scales: tuple[float, ...] | None = None,
                            valid_hw: np.ndarray | None = None):
        """Enqueue the batched program; returns (n, device tables).
        Resolve with ``PoseEstimator._finish(n, tables)``."""
        return images.shape[0], self._run(images, scales, valid_hw)

    def stream(self, batches: Iterable[np.ndarray], depth: int = 2,
               scales: tuple[float, ...] | None = None) -> Iterator[list[list[dict]]]:
        """Pipelined batched inference: keeps ``depth`` batches in flight."""
        pending: list[Any] = []
        for images in batches:
            pending.append(self.process_batch_async(images, scales))
            if len(pending) > depth:
                yield self._finish(*pending.pop(0))
        while pending:
            yield self._finish(*pending.pop(0))

    @staticmethod
    def _finish(n: int, tables: dict[str, torch.Tensor]) -> list[list[dict]]:
        host = {k: v.cpu().numpy() for k, v in tables.items()}
        return [to_people({k: v[i] for k, v in host.items()}) for i in range(n)]

    @torch.inference_mode()
    def maps_batch(self, images: np.ndarray, scales: tuple[float, ...] | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Multi-scale averaged (heatmaps (N, H, W, 19), pafs (N, H, W, 38))
        of (N, H, W, 3) images at their own resolution, on the estimator's
        device, whatever ``paf_readout`` says: what the full-res readout
        hands to the decode (``ops.image.average_upsampled`` of every
        scale's output, in f32)."""
        h, w = images.shape[1:3]
        sizes, heats, pafs = self._low_res(images, scales)
        stride = self.cfg.model.stride
        return (image_ops.average_upsampled(heats, sizes, h, w, stride),
                image_ops.average_upsampled(pafs, sizes, h, w, stride))

    def maps(self, image: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """``maps_batch`` of one (H, W, 3) image over the configured pyramid:
        (heatmap (H, W, 19), paf (H, W, 38))."""
        heat, paf = self.maps_batch(np.asarray(image, np.uint8)[None])
        return heat[0], paf[0]

    def process_async(self, image: np.ndarray) -> dict[str, torch.Tensor]:
        """Enqueue one (H, W, 3) image over the configured pyramid; returns
        its device tables (no batch axis, no sync)."""
        tables = self._run(np.asarray(image, np.uint8)[None], None, None)
        return {k: v[0] for k, v in tables.items()}

    def process(self, image: np.ndarray, draw: bool = False) -> dict:
        """One (H, W, 3) image -> {"people": [...]} (+ "canvas" overlay)."""
        people = to_people({k: v.cpu().numpy() for k, v in self.process_async(image).items()})
        out = {"people": people}
        if draw:
            from tpupose_torch.utils.drawing import draw_people

            out["canvas"] = draw_people(np.asarray(image, np.uint8), people)
        return out
