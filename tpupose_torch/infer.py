"""Public inference API: images -> people keypoint JSON.

Counterpart of ``tpupose/infer.py`` on the product path: normalise ->
per pyramid scale resize + pad + the network's last stage -> the
per-scale low-res outputs stay a ``ScaleSpace`` (never upsampled) ->
``decode_impl_batch`` -> ``to_people``. Images cross to the device as
uint8; only the people and peak tables come back.

The estimator runs where ``device`` says and never silently elsewhere:
``device="cuda"`` without a CUDA device raises. On CUDA the kernels of
``tpupose_torch/csrc`` carry block 1 of every forward, the peak scores,
the PAF point readout and the association; on the CPU their plain
PyTorch versions do. Constructing an estimator turns TF32 off for cuDNN
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


class PoseEstimator:
    """Builds the network once; ``process_batch`` is the product path.

    ``params``: a flax-layout parameter tree (nested dict of numpy
    arrays, e.g. the reference estimator's ``params``); None builds the
    flax-default random init from ``seed``.
    """

    def __init__(self, cfg: PoseConfig = DEFAULT, params: Any | None = None,
                 seed: int = 0, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PoseEstimator(device='cuda'): no CUDA device is available")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.model = OpenPose(num_stages=cfg.model.num_stages,
                              dtype=DTYPES[cfg.model.compute_dtype],
                              pallas_block1=True)
        if params is None:
            self.model.reset_parameters(torch.Generator().manual_seed(seed))
            self.pretrained = False
        else:
            self.model.load_state_dict(weights_lib.from_flax(params))
            self.pretrained = True
        self.model.to(self.device, memory_format=torch.channels_last).eval()

    # --- the batched program ---------------------------------------------------

    @torch.inference_mode()
    def _run(self, images: np.ndarray, scales, valid_hw) -> dict[str, torch.Tensor]:
        n, h, w = images.shape[:3]
        mcfg, icfg = self.cfg.model, self.cfg.inference
        scales = tuple(scales) if scales else icfg.scale_search
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
            heats.append(heat)          # (N, ph/8, pw/8, 19)
            pafs.append(paf)            # (N, ph/8, pw/8, 38)
        geoms = [s[:2] for s in sizes]
        return decode_impl_batch(ScaleSpace(heats, geoms, (h, w)),
                                 ScaleSpace(pafs, geoms, (h, w)), icfg, valid_hw)

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

    def process(self, image: np.ndarray, draw: bool = False) -> dict:
        """One (H, W, 3) image -> {"people": [...]} (+ "canvas" overlay)."""
        people = self.process_batch(np.asarray(image, np.uint8)[None])[0]
        out = {"people": people}
        if draw:
            from tpupose_torch.utils.drawing import draw_people

            out["canvas"] = draw_people(np.asarray(image, np.uint8), people)
        return out
