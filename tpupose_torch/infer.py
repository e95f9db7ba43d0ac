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

import itertools
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from tpupose_torch.config import DEFAULT, PoseConfig
from tpupose_torch.decode.api import decode_scores_batch, peak_scores_batch, to_people
from tpupose_torch.decode.scalespace import ScaleSpace
from tpupose_torch.models import OpenPose, weights as weights_lib
from tpupose_torch.models.body25 import OpenPoseBody25
from tpupose_torch.models.openpose import DTYPES
from tpupose_torch.ops import image as image_ops
from tpupose_torch.skeletons import BODY25, COCO18, Skeleton
from tpupose_torch.utils.profiling import annotate


READOUTS = ("scalespace", "fullres")
# the networks ``PoseEstimator(arch=...)`` builds, and the skeleton each decodes
ARCHS = {"coco18": COCO18, "body25": BODY25}


class Tables(dict):
    """One batch's device tables, with its sequence number ``seq`` on its
    estimator (the ``args`` of the batch's ``infer.enqueue`` and
    ``infer.finish`` spans, which joins them) and the skeleton that names
    its parts."""

    def __init__(self, tables: dict[str, torch.Tensor], seq: int, skeleton: Skeleton = COCO18):
        super().__init__(tables)
        self.seq = seq
        self.skeleton = skeleton


class PoseEstimator:
    """Builds the network once; ``process_batch`` is the product path.

    ``params``: a flax-layout parameter tree (nested dict of numpy
    arrays, e.g. the reference estimator's ``params``); None builds the
    flax-default random init from ``seed`` and overlays ``weights_path``
    (a reference ``.h5``, ``.caffemodel`` or torch ``.pth``/``.pt``, see
    ``models.weights.maybe_load_pretrained``) where that file exists.
    ``pretrained`` says whether the weights came from ``params`` or a file.

    ``arch`` chooses the network and the skeleton the decode runs over:
    ``"coco18"`` (``models.OpenPose``, ``cfg.model.num_stages`` stages,
    18 parts) or ``"body25"`` (``models.body25.OpenPoseBody25``, 4 PAF and
    2 heat stages, 25 parts; its ``params`` tree holds the PReLU slopes as
    ``{"slope"}`` leaves under the prototxt's layer names, and no weight
    file loads into it yet). The rest of the path is the same code.
    """

    def __init__(self, cfg: PoseConfig = DEFAULT, params: Any | None = None,
                 weights_path: str | None = None, seed: int = 0,
                 device: str | torch.device = "cuda", arch: str = "coco18"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PoseEstimator(device='cuda'): no CUDA device is available")
        if cfg.inference.paf_readout not in READOUTS:
            raise ValueError(f"unknown paf_readout {cfg.inference.paf_readout!r}: "
                             f"one of {READOUTS}")
        if arch not in ARCHS:
            raise ValueError(f"unknown arch {arch!r}: one of {tuple(ARCHS)}")
        if arch == "body25" and weights_path:
            raise ValueError("PoseEstimator(arch='body25'): weights come from params only")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.skeleton = ARCHS[arch]
        dtype = DTYPES[cfg.model.compute_dtype]
        if arch == "body25":
            self.model = OpenPoseBody25(dtype=dtype, pallas_block1=True)
        else:
            self.model = OpenPose(num_stages=cfg.model.num_stages, dtype=dtype,
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
        self._batches = itertools.count()

    # --- the batched program ---------------------------------------------------

    def _net(self, params):
        """The network's last stage, x -> (paf, heat): with the model's own
        weights, or with ``params`` (state-dict names -> tensors) in their
        place (``torch.func.functional_call``: every tensor replaced)."""
        if params is None:
            return lambda x: self.model(x)[-1]
        return lambda x: torch.func.functional_call(self.model, params, (x,), strict=True)[-1]

    def _upload(self, images: np.ndarray, valid_hw):
        """(N, H, W, 3) uint8 and the optional (N, 2) ``valid_hw`` -> device
        tensors (uint8, int32), through pinned memory on CUDA."""
        host = [torch.from_numpy(np.ascontiguousarray(images, dtype=np.uint8))]
        if valid_hw is not None:
            host.append(torch.from_numpy(np.ascontiguousarray(valid_hw, dtype=np.int32)))
        if self.device.type == "cuda":
            host = [t.pin_memory() for t in host]
        dev = [t.to(self.device, non_blocking=True) for t in host]
        return dev[0], (dev[1] if valid_hw is not None else None)

    def _low_res(self, net, images: torch.Tensor, scales):
        """The network's last stage at every pyramid scale of (N, H, W, 3)
        uint8 device images: (sizes, heats, pafs), per scale (N, ph/8,
        pw/8, 19) and (N, ph/8, pw/8, 38)."""
        h, w = images.shape[1:3]
        mcfg = self.cfg.model
        scales = tuple(scales) if scales else self.cfg.inference.scale_search
        sizes = image_ops.scale_sizes(h, w, scales, mcfg.boxsize, mcfg.stride)
        x0 = image_ops.normalize(images, mcfg.channel_order)
        heats, pafs = [], []
        for rh, rw, _, _ in sizes:
            x = image_ops.resize_bilinear(x0, rh, rw)
            x, _ = image_ops.pad_right_down(x, mcfg.stride, image_ops.PAD_NORM)
            paf, heat = net(x)
            heats.append(heat)
            pafs.append(paf)
        return sizes, heats, pafs

    def _averaged_maps(self, net, images: torch.Tensor, scales):
        """``maps_batch`` of device images (see there)."""
        h, w = images.shape[1:3]
        sizes, heats, pafs = self._low_res(net, images, scales)
        stride = self.cfg.model.stride
        return (image_ops.average_upsampled(heats, sizes, h, w, stride),
                image_ops.average_upsampled(pafs, sizes, h, w, stride))

    def _device_scores(self, params, images: torch.Tensor, scales, valid_hw):
        """The batched program up to the peak scores, enqueued without a
        host sync: (masked scores (N, 18, H*W), map width, the PAF input of
        the readout)."""
        net = self._net(params)
        if self.cfg.inference.paf_readout == "fullres":
            heat_in, paf_in = self._averaged_maps(net, images, scales)
        else:
            h, w = images.shape[1:3]
            sizes, heats, pafs = self._low_res(net, images, scales)
            geoms = [s[:2] for s in sizes]
            heat_in = ScaleSpace(heats, geoms, (h, w))
            paf_in = ScaleSpace(pafs, geoms, (h, w))
        flats, width = peak_scores_batch(heat_in, self.cfg.inference, valid_hw, self.skeleton)
        return flats, width, paf_in

    def program(self, params, images: torch.Tensor, valid_hw: torch.Tensor | None,
                scales: tuple[float, ...] | None = None) -> dict[str, torch.Tensor]:
        """The batched program on device tensors: ``params`` (None: the
        model's own weights; else state-dict names -> tensors), images
        uint8 (N, H, W, 3), ``valid_hw`` int32 (N, 2) or None -> the people
        tables. No upload, no pinned memory, no host read but the decode's
        peak-overflow switch, which ``torch.export`` keeps on the device
        (``decode.peaks.peak_tables``). The live path runs it under
        ``torch.inference_mode``, ``deploy.export_program`` under
        ``torch.no_grad``."""
        flats, width, paf_in = self._device_scores(params, images, scales, valid_hw)
        return decode_scores_batch(flats, width, paf_in, self.cfg.inference,
                                   skeleton=self.skeleton)

    @torch.inference_mode()
    def _scores(self, images: np.ndarray, scales, valid_hw):
        """``program`` up to the peak scores, from host images (the upload
        included). ``_tables`` finishes it."""
        x, vhw = self._upload(images, valid_hw)
        return self._device_scores(None, x, scales, vhw)

    @torch.inference_mode()
    def _tables(self, scored, overflow: bool | None = None) -> dict[str, torch.Tensor]:
        """The people tables of ``_scores``' output; ``overflow`` is the
        peak-overflow decision of a larger batch (None: of this one)."""
        flats, width, paf_in = scored
        return decode_scores_batch(flats, width, paf_in, self.cfg.inference, overflow,
                                   self.skeleton)

    @torch.inference_mode()
    def _run(self, images: np.ndarray, scales, valid_hw) -> dict[str, torch.Tensor]:
        x, vhw = self._upload(images, valid_hw)
        return self.program(None, x, vhw, scales)

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
        """Enqueue the batched program; returns (n, device ``Tables``).
        Resolve with ``PoseEstimator._finish(n, tables)``."""
        seq = next(self._batches)
        with annotate("infer.enqueue", seq):
            tables = self._run(images, scales, valid_hw)
        return images.shape[0], Tables(tables, seq, self.skeleton)

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
        """The people of ``process_batch_async``'s tables (a ``Tables``
        names its skeleton; plain tables are COCO-18's)."""
        skeleton = getattr(tables, "skeleton", COCO18)
        with annotate("infer.finish", getattr(tables, "seq", None)):
            host = {k: v.cpu().numpy() for k, v in tables.items()}
            return [to_people({k: v[i] for k, v in host.items()}, skeleton) for i in range(n)]

    @torch.inference_mode()
    def maps_batch(self, images: np.ndarray, scales: tuple[float, ...] | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Multi-scale averaged (heatmaps (N, H, W, 19), pafs (N, H, W, 38);
        BODY_25: 26 and 52)
        of (N, H, W, 3) images at their own resolution, on the estimator's
        device, whatever ``paf_readout`` says: what the full-res readout
        hands to the decode (``ops.image.average_upsampled`` of every
        scale's output, in f32)."""
        x, _ = self._upload(images, None)
        return self._averaged_maps(self._net(None), x, scales)

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
        people = to_people({k: v.cpu().numpy() for k, v in self.process_async(image).items()},
                           self.skeleton)
        out = {"people": people}
        if draw:
            from tpupose_torch.utils.drawing import draw_people

            out["canvas"] = draw_people(np.asarray(image, np.uint8), people)
        return out
