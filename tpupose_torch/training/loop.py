"""The training loop: steps, LR schedule, checkpoints, CSV/TB logging.

Counterpart of ``tpupose/training/loop.py``: restore-latest,
iterate generator batches, log per-head losses, checkpoint periodically
(``checkpoint.AsyncSaver``: the step loop never waits on the disk).
Works identically for from-scratch training and frozen-VGG domain
adaptation — the optimizer encodes the difference. A checkpointable feed
(``data/pipeline.is_checkpointable``, e.g. ``TprBatches``) has its
position saved in every checkpoint and rewound on restore, so a resumed
run takes the batches the uninterrupted one would have taken.

Each step's augmentation draws come from a generator seeded from
(``seed``, the step's index), so a run resumed from a checkpoint repeats
the uninterrupted run exactly.

Data parallelism (``use_mesh=True``, the default, under an initialised
``torch.distributed`` process group of W ranks, one per device, as
``torchrun`` launches them; see ``parallel.distributed``): every rank is
fed the same global batch of ``cfg.train.batch_size``, pads it to a
multiple of W (``parallel.sharding.pad_batch``: padded rows carry weight
0), draws the augmentation of the whole padded batch from the same
step generator and keeps its own rows of both. The loss divisor stays
the global batch size; one all-reduce sums gradients and losses, and
every rank applies the same update. Only rank 0 writes checkpoints, the
loss CSVs and TensorBoard. Without a group, or with ``use_mesh=False``,
the step is the single-device one.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch
import torch.distributed as dist

from tpupose_torch.config import PoseConfig
from tpupose_torch.data.pipeline import is_checkpointable
from tpupose_torch.gt import augment as gt_augment
from tpupose_torch.models import OpenPose
from tpupose_torch.models.openpose import DTYPES
from tpupose_torch.parallel.distributed import is_primary
from tpupose_torch.parallel.sharding import pad_batch
from tpupose_torch.training import checkpoint as ckpt_lib
from tpupose_torch.training.train import create_state, make_eval_step, make_train_step
from tpupose_torch.utils.profiling import annotate


class CSVLogger:
    """Per-step loss CSV."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._path = path
        self._file = None
        self._writer = None

    def log(self, step: int, losses: dict[str, float]) -> None:
        if self._writer is None:
            self._file = open(self._path, "a", newline="")
            self._writer = csv.DictWriter(self._file, fieldnames=["step", *sorted(losses)])
            if self._file.tell() == 0:
                self._writer.writeheader()
        self._writer.writerow({"step": step, **{k: f"{v:.6g}" for k, v in losses.items()}})
        self._file.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()


class TBLogger:
    """TensorBoard scalars via ``torch.utils.tensorboard.SummaryWriter``
    (reference artifact parity with its TensorBoard callback); no-op
    where it cannot be imported (it needs the ``tensorboard`` package)."""

    def __init__(self, logdir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(logdir)
        except ImportError:
            self._writer = None

    def log(self, step: int, losses: dict[str, float]) -> None:
        if self._writer is not None:
            for k, v in losses.items():
                self._writer.add_scalar(f"loss/{k}", v, step)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.flush()
            self._writer.close()


def step_generator(seed: int, step_idx: int) -> torch.Generator:
    """The augmentation generator of step ``step_idx`` of a run."""
    mixed = ((seed + 1) * 0x9E3779B97F4A7C15 + step_idx * 0xBF58476D1CE4E5B9) & ((1 << 63) - 1)
    return torch.Generator().manual_seed(mixed)


def _host(losses: Mapping[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(v) for k, v in losses.items()}


def _rank_rows(batch: Mapping[str, Any], rank: int, world: int) -> dict[str, Any]:
    """This rank's rows of a batch padded to a multiple of ``world``."""
    n = next(iter(batch.values())).shape[0] // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


class _NoLog:
    """The loggers of a rank other than 0."""

    def log(self, step: int, losses: dict[str, float]) -> None:
        pass

    def close(self) -> None:
        pass


def train(
    cfg: PoseConfig,
    batches: Iterable[dict[str, np.ndarray]],
    params: Mapping[str, torch.Tensor] | None = None,
    workdir: str = "runs/train",
    max_steps: int | None = None,
    seed: int = 0,
    use_mesh: bool = True,
    on_step: Callable[[int, dict[str, float]], None] | None = None,
    val_batches: Callable[[], Iterable[dict[str, np.ndarray]]] | None = None,
    val_every: int | None = None,
    device: str | torch.device = "cuda",
) -> dict[str, Any]:
    """Run the training loop on ``device``; returns the final state tree
    and run statistics. ``params``: a state dict to start from
    (``models.weights.from_flax`` converts a flax tree); None builds the
    seeded default init. The latest checkpoint under ``workdir``, if any,
    takes precedence. ``use_mesh``: data-parallel over the initialised
    process group, if there is one (module docstring)."""
    model = OpenPose(num_stages=cfg.model.num_stages, dtype=DTYPES[cfg.model.compute_dtype])
    if params is None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
        params = model.state_dict()

    state, tx = create_state(cfg, params, device)
    tree = state.tree()

    ckpt_dir = os.path.join(workdir, cfg.train.checkpoint_dir)
    # a checkpointable feed has its position saved with the model state and
    # rewound here: exact mid-epoch resume
    ckpt_feed = batches if is_checkpointable(batches) else None
    restored = ckpt_lib.restore(ckpt_dir, tree, data_iter=ckpt_feed)
    if restored is not None:
        tree = restored

    # the process group's ranks, each one entry of the data axis
    group = use_mesh and dist.is_available() and dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if group else (1, 0)
    all_reduce = dist.all_reduce if group else None
    primary = is_primary()

    step_fn = make_train_step(cfg, model, tx, loss_denom=cfg.train.batch_size,
                              all_reduce=all_reduce)
    logger = CSVLogger(os.path.join(workdir, "training.csv")) if primary else _NoLog()
    tb = TBLogger(os.path.join(workdir, "tb")) if primary else _NoLog()
    saver = ckpt_lib.AsyncSaver(ckpt_dir)

    val_logger = None
    eval_fns: dict[int, Any] = {}
    if val_batches is not None:
        val_every = val_every or cfg.train.checkpoint_every
        val_logger = (CSVLogger(os.path.join(workdir, "validation.csv")) if primary
                      else _NoLog())

    def run_validation(step_idx: int) -> None:
        if val_batches is None:
            return
        totals: dict[str, float] = {}
        n_total = 0
        for vb in val_batches():
            # the eucl-loss divisor is each val batch's own sample count
            n_real = next(iter(vb.values())).shape[0]
            if n_real not in eval_fns:
                eval_fns[n_real] = make_eval_step(cfg, model, loss_denom=n_real,
                                                  all_reduce=all_reduce)
            if group:
                vb = _rank_rows(pad_batch(vb, world)[0], rank, world)
            # per-sample weighting (evaluate_generator semantics)
            for k, v in _host(eval_fns[n_real](tree["params"], vb)).items():
                totals[k] = totals.get(k, 0.0) + v * n_real
            n_total += n_real
        if n_total:
            means = {k: v / n_total for k, v in totals.items()}
            val_logger.log(step_idx, means)
            tb.log(step_idx, {f"val_{k}": v for k, v in means.items()})

    limit = max_steps if max_steps is not None else cfg.train.max_steps
    # The step counter lives host-side; losses are read from the device
    # only when they are logged, so dispatch runs ahead of the device.
    start = int(tree["step"])
    step_idx = start
    t0 = time.time()
    losses = None  # device handle of the most recent step's losses

    # check the limit BEFORE pulling a batch: a checkpointable feed's
    # saved position must not advance past a batch no step consumed
    feed = iter(batches)
    while step_idx < limit:
        try:
            batch = next(feed)
        except StopIteration:
            break
        n_fed = next(iter(batch.values())).shape[0]
        if n_fed != cfg.train.batch_size:
            raise ValueError(
                f"batch of {n_fed} fed to a loop configured for "
                f"batch_size={cfg.train.batch_size} (the loss divisor is "
                "pinned to the configured size)"
            )
        rng = step_generator(seed, step_idx)
        if group:
            # the draws of the whole padded batch, sample i's depending only
            # on (seed, step, i): this rank keeps its rows of both
            batch, _ = pad_batch(batch, world)
            rng = gt_augment.batch_params(rng, cfg.augment, next(iter(batch.values())).shape[0])
            batch, rng = _rank_rows(batch, rank, world), _rank_rows(rng, rank, world)
        with annotate("train.step"):
            tree, losses = step_fn(tree, rng, batch)

        step_idx += 1
        if step_idx % cfg.train.log_every == 0 or step_idx == start + 1:
            logged = _host(losses)
            logger.log(step_idx, logged)
            tb.log(step_idx, logged)
            if on_step is not None:
                on_step(step_idx, logged)
        if primary and step_idx % cfg.train.checkpoint_every == 0:
            saver.save(tree, step=step_idx, data_iter=ckpt_feed)
        if val_batches is not None and step_idx % val_every == 0:
            run_validation(step_idx)

    # the FINAL step's losses, whatever the logging cadence was
    last_losses = _host(losses) if losses is not None else {}
    if primary and saver.last_saved != tree["step"]:
        saver.save(tree, step=tree["step"], data_iter=ckpt_feed)
    saver.close()  # block until every pending write is durable
    if val_batches is not None:
        run_validation(tree["step"])
        val_logger.close()
    logger.close()
    tb.close()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.time() - t0
    steps_done = tree["step"] - start
    return {
        "state": tree,
        "steps": steps_done,
        "seconds": elapsed,
        "steps_per_sec": steps_done / elapsed if elapsed > 0 else 0.0,
        "last_losses": last_losses,
    }
