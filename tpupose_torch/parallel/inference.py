"""Data-parallel batched inference: the image batch split over a mesh.

The port's counterpart of ``tpupose/parallel/inference.py``, the third
leg of the inference scaling story beside ``parallel.pyramid`` (scales
over devices) and ``parallel.spatial`` (image tiles over devices).

``DataParallelEstimator`` keeps one replica of the estimator's weights per
mesh entry, splits every device batch over the entries in mesh order and
enqueues each chunk's program (network and peak scores) on its entry's
device before the one host sync of the decode: the peak-overflow switch
(``decode.peaks.peak_tables``), which the reference's one program decides
over the whole batch, is decided here as the MAX over the chunks and
handed to every chunk's tables. Across processes
(``multihost_process_batch``) the MAX is an all-reduce over the process
group. Padded rows (a batch not divisible by the mesh) decode to nothing
and are dropped.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpupose_torch.decode.peaks import overflowed
from tpupose_torch.parallel.sharding import Mesh, kept_replicas, local_devices, make_mesh
from tpupose_torch.utils.profiling import annotate


def _replica(est: Any, model: torch.nn.Module, device: torch.device):
    """``est`` with its own copy of the weights on ``device``."""
    rep = copy.copy(est)
    rep.model = model
    rep.device = device
    return rep


def _replicas(est: Any, mesh: Mesh) -> list:
    """One estimator replica per mesh entry, its weights kept on ``est``."""
    return [_replica(est, model, dev)
            for model, dev in zip(kept_replicas(est, mesh), mesh.devices.flat)]


def run_chunks(replicas: Sequence[Any], images: np.ndarray, scales, valid_hw,
               decide: Callable[[torch.Tensor], bool] | None = None) -> dict[str, torch.Tensor]:
    """``images`` split into one chunk per replica (in order), each chunk's
    network and peak scores enqueued on its replica's device, the
    peak-overflow switch decided over all chunks (``decide`` widens it
    further: it takes the chunks' 0-d flag on the first replica's device
    and returns the decision), then each chunk's tables; the tables
    concatenated on the first replica's device."""
    chunks = np.split(np.asarray(images), len(replicas))
    vhws = (np.split(np.asarray(valid_hw, np.int32), len(replicas)) if valid_hw is not None
            else [None] * len(replicas))
    scored = [rep._scores(chunk, scales, vhw) for rep, chunk, vhw in zip(replicas, chunks, vhws)]
    home = replicas[0].device
    k = replicas[0].cfg.inference.max_peaks
    with torch.inference_mode():
        flag = torch.stack([overflowed(flats.reshape(-1, flats.shape[-1]), k).to(home)
                            for flats, _, _ in scored]).any()
    with annotate("decode.overflow_switch"):
        overflow = decide(flag) if decide is not None else bool(flag)
    tables = [rep._tables(s, overflow) for rep, s in zip(replicas, scored)]
    return {key: torch.cat([t[key].to(home) for t in tables]) for key in tables[0]}


class DataParallelEstimator:
    """``PoseEstimator`` facade splitting every device batch over ``mesh``'s
    entries: a drop-in for anything that duck-types the
    ``process_batch(images, scales=, valid_hw=)`` /
    ``process_batch_async`` + ``_finish`` contract (``serve.MicroBatcher``,
    ``buckets.BucketedRunner``), so serving and bucketed eval run over
    several devices without code changes.

    The weights are copied once per mesh entry and mesh layout, and kept on
    the estimator (an entry that repeats a device holds a copy of its own).
    Images beyond a mesh-size multiple are padded with blank rows (decoded,
    then dropped); a padded ``valid_hw`` row is (1, 1). Single-image ``process``, ``_finish`` and
    attribute access (``cfg``, ``model``, ``pretrained`` ...) delegate to
    the wrapped estimator.
    """

    def __init__(self, est: Any, mesh: Mesh):
        self._est = est
        self._mesh = mesh
        self._replicas = _replicas(est, mesh)

    def __getattr__(self, name):  # cfg / model / pretrained / process / _finish ...
        return getattr(self._est, name)

    def process_batch_async(
        self,
        images: np.ndarray,
        scales: tuple[float, ...] | None = None,
        valid_hw: np.ndarray | None = None,
    ):
        """Every chunk enqueued, one host sync (the batch-wide overflow
        switch); resolve with ``_finish(n, tables)`` (the wrapped
        estimator's)."""
        n, h, w = images.shape[:3]
        n_dev = self._mesh.size
        n_pad = (n_dev - n % n_dev) % n_dev
        if n_pad:
            blanks = np.zeros((n_pad, h, w, images.shape[3]), images.dtype)
            images = np.concatenate([images, blanks])
            if valid_hw is not None:
                valid_hw = np.concatenate([
                    np.asarray(valid_hw, np.int32),
                    np.ones((n_pad, 2), np.int32),
                ])
        return n + n_pad, run_chunks(self._replicas, images, scales, valid_hw)

    def process_batch(
        self,
        images: np.ndarray,
        scales: tuple[float, ...] | None = None,
        valid_hw: np.ndarray | None = None,
    ) -> list[list[dict]]:
        n = images.shape[0]
        nb, tables = self.process_batch_async(images, scales, valid_hw)
        return self._est._finish(nb, tables)[:n]


def resolve_dp(spec: str, devices=None) -> int:
    """Validate a ``--dp`` spec ('N' or 'auto') against the visible CUDA
    devices (or ``devices``) and return N. Raises ValueError when N exceeds
    them — callers check this BEFORE paying for the model build."""
    devs = devices if devices is not None else local_devices("cuda")
    if spec == "auto":
        n = len(devs)
    else:
        try:
            n = int(spec)
        except ValueError:
            raise ValueError(f"--dp must be a device count or 'auto', "
                             f"got {spec!r}") from None
    if n < 1:
        raise ValueError(f"--dp must be >= 1, got {n}")
    if n > len(devs):
        raise ValueError(
            f"--dp {n} exceeds the {len(devs)} visible device(s)"
        )
    return n


def wrap_dp(est: Any, spec: str, devices=None):
    """CLI-facing constructor: ``'N'`` or ``'auto'`` -> the estimator
    wrapped over the first N visible CUDA devices (or of ``devices``),
    shared by ``serve --dp`` and ``cli eval --dp``. Returns
    ``(estimator, n)``; unchanged when N == 1. Raises ValueError when N
    exceeds the visible device count."""
    devs = list(devices) if devices is not None else local_devices("cuda")
    n = resolve_dp(spec, devs)
    if n <= 1:
        return est, n
    return DataParallelEstimator(est, make_mesh(n, devices=devs)), n


def dp_process_batch(
    est: Any,
    images: np.ndarray,
    mesh: Mesh,
    scales: tuple[float, ...] | None = None,
) -> list[list[dict]]:
    """``PoseEstimator.process_batch`` with the batch split over ``mesh``
    (functional form of :class:`DataParallelEstimator`)."""
    return DataParallelEstimator(est, mesh).process_batch(images, scales)


def multihost_process_batch(
    est: Any,
    local_images: np.ndarray,
    scales: tuple[float, ...] | None = None,
    valid_hw: np.ndarray | None = None,
    mesh: Mesh | None = None,
) -> list[list[dict]]:
    """Data-parallel inference over a process group: every process calls
    this with ITS rows of one global batch (the same ``local_images.shape``
    everywhere) and gets the people of its own rows back.

    Each process runs its rows on its estimator (split further over
    ``mesh``, its own devices, when given); the peak-overflow switch is
    decided over the whole global batch, an all-reduce MAX over the group,
    so that every row decodes as in one program over the global batch. The
    global batch must divide by the group's device count (world size x
    mesh size). Without a process group this is ``process_batch`` of the
    local rows."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n_local = local_images.shape[0]
    n_dev = world * (mesh.size if mesh is not None else 1)
    n_global = n_local * world
    if n_global % n_dev:
        raise ValueError(
            f"global batch {n_global} not divisible by the mesh's "
            f"{n_dev} devices; pad per host first"
        )
    replicas = [est] if mesh is None else _replicas(est, mesh)

    def decide(flag: torch.Tensor) -> bool:
        if not dist.is_initialized():
            return bool(flag)
        # gloo carries CPU and CUDA tensors, NCCL CUDA tensors: reduce on
        # the estimator's device
        t = flag.to(torch.int32).reshape(1)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t)

    tables = run_chunks(replicas, local_images, scales, valid_hw, decide)
    return est._finish(n_local, tables)
