"""Training step: on-device GT generation + stage-wise masked L2.

Counterpart of ``tpupose/training/train.py``. One step covers
augmentation (rot/scale/flip/crop), putGaussianMaps/putVecMaps GT
rasterisation (``ops.gt``: the CUDA kernel on the card), the 6-stage
forward and backward, the 12 masked L2 heads and the MultiSGD update.
Domain-adaptation fine-tuning is the same step with the VGG base frozen
(``TrainConfig.frozen_vgg()``).

Raw-batch contract (numpy arrays or tensors, all fixed shapes):
  images  (N, H, W, 3) uint8-valued, configured channel order
  masks   (N, H, W)    float miss-mask (1 = keep) or uint8 (255 = keep)
  joints  (N, P, 18, 3) float32, v=2 rows are padding
  centers (N, 2), scales (N,)  main-person crop geometry
  weight  (N,) optional: 0 for padded rows

The state is a plain tree ``{"params", "opt_state", "step"}``: ``params``
maps state-dict names to f32 tensors on the training device (4-D kernels
in channels_last), ``step`` is a host int. A step updates the tree in
place and returns it. The model runs with ``pallas_block1`` off, as the
reference trainer's does: block 1 has no backward kernel, so its two
convs run through cuDNN.

Data parallelism (``all_reduce``): each process of a group steps on its
rows of the global batch with the loss divisor of the global batch, and
``all_reduce`` sums the gradients and the losses of every process in one
call, so that each applies the same update as one process would on the
whole batch (``training.loop.train(use_mesh=True)``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch
from torch.func import functional_call

from tpupose_torch.config import PoseConfig
from tpupose_torch.gt import augment as gt_augment
from tpupose_torch.gt import rasterize as gt_rasterize
from tpupose_torch.models import OpenPose
from tpupose_torch.ops import image as image_ops
from tpupose_torch.training import loss as loss_lib
from tpupose_torch.training import optimizer as opt_lib
from tpupose_torch.utils.profiling import annotate


@dataclasses.dataclass
class TrainState:
    params: dict[str, torch.Tensor]
    opt_state: dict
    step: int

    def tree(self) -> dict[str, Any]:
        return {"params": self.params, "opt_state": self.opt_state, "step": self.step}


def create_state(cfg: PoseConfig, params: Mapping[str, torch.Tensor],
                 device: str | torch.device = "cuda") -> tuple[TrainState, opt_lib.MultiSGD]:
    """Copies ``params`` (a state dict) to ``device`` and builds the
    optimizer and its zero state. ``device="cuda"`` without a CUDA device
    raises; nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("create_state(device='cuda'): no CUDA device is available")
    own = {}
    for name, value in params.items():
        v = value.detach().to(device, torch.float32, copy=True)
        own[name] = v.contiguous(memory_format=torch.channels_last) if v.dim() == 4 else v
    tx = opt_lib.make_optimizer(cfg.train, own)
    return TrainState(own, tx.init(own), 0), tx


def _to_device(batch: Mapping[str, Any], device: torch.device) -> dict[str, torch.Tensor]:
    out = {}
    for key, value in batch.items():
        t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(value))
        out[key] = t.to(device, non_blocking=True)
    return out


def _norm_masks(masks: torch.Tensor) -> torch.Tensor:
    # the host pipeline ships uint8 (0..255) to quarter the transfer size
    if masks.dtype == torch.uint8:
        return masks.to(torch.float32) / 255.0
    return masks.to(torch.float32)


def _targets(cfg: PoseConfig, rng, batch: dict[str, torch.Tensor], training: bool):
    """Augment the raw batch and rasterise its labels:
    (images_norm, paf_gt, heat_gt, label_mask)."""
    images_a, label_mask, joints_a = gt_augment.augment_batch(
        rng, batch["images"].to(torch.float32), _norm_masks(batch["masks"]),
        batch["joints"].to(torch.float32), batch["centers"].to(torch.float32),
        batch["scales"].to(torch.float32), cfg.model, cfg.augment, training=training)
    if "weight" in batch:  # padded batches: zero out padded rows
        label_mask = label_mask * batch["weight"].to(torch.float32)[:, None, None]
    paf_gt, heat_gt = gt_rasterize.labels_for_config(joints_a, label_mask, cfg.model, cfg.augment)
    return image_ops.normalize(images_a, cfg.model.channel_order), paf_gt, heat_gt, label_mask


def _device_of(params: Mapping[str, torch.Tensor]) -> torch.device:
    return next(iter(params.values())).device


def _no_tf32() -> None:
    # f32 heads and an f32 model are f32, as in the reference
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _summed(all_reduce, grads: list[torch.Tensor], losses: dict[str, torch.Tensor]):
    """Gradients and losses summed over the group by one ``all_reduce`` of
    one flat f32 buffer."""
    keys = list(losses)
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [torch.stack([losses[k] for k in keys]).to(torch.float32)])
    all_reduce(flat)
    out, off = [], 0
    for g in grads:
        out.append(flat[off:off + g.numel()].view(g.shape))
        off += g.numel()
    return out, dict(zip(keys, flat[off:]))


def _descend(model: OpenPose, tx: opt_lib.MultiSGD, tree: dict, inputs, denom,
             all_reduce=None) -> dict:
    """Forward, backward and update on prepared inputs; the losses."""
    images_norm, paf_gt, heat_gt, label_mask = inputs
    params = tree["params"]
    leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
    outputs = functional_call(model, leaves, (images_norm,))
    losses = loss_lib.stagewise_losses(outputs, paf_gt, heat_gt, label_mask, denom)
    names = list(leaves)
    grads = torch.autograd.grad(losses["total"], [leaves[n] for n in names])
    losses = {k: v.detach() for k, v in losses.items()}
    if all_reduce is not None:
        grads, losses = _summed(all_reduce, grads, losses)
    with annotate("train.update"):
        tx.update(dict(zip(names, grads)), tree["opt_state"], params)
    tree["step"] += 1
    return losses


def make_train_step(cfg: PoseConfig, model: OpenPose, tx: opt_lib.MultiSGD,
                    loss_denom: int | None = None, all_reduce=None):
    """Returns step(state_tree, rng, batch) -> (state_tree, losses).

    ``rng`` is a ``torch.Generator`` for the step's augmentation draws, or
    the draws themselves (see ``gt.augment.augment_batch``). ``losses``
    are 0-d tensors on the training device; reading them is the only
    host synchronisation. ``loss_denom`` fixes the eucl-loss batch divisor
    to the *real* sample count when batches are padded. ``all_reduce``
    (e.g. ``torch.distributed.all_reduce``, in place, SUM) sums gradients
    and losses over a process group before the update. The step's spans
    (``utils.profiling.annotate``): ``train.upload``, ``train.targets``
    (augment and labels) and ``train.update`` (MultiSGD).
    """
    _no_tf32()

    def step(state_tree, rng, batch):
        with annotate("train.upload"):
            batch = _to_device(batch, _device_of(state_tree["params"]))
        with torch.no_grad(), annotate("train.targets"):
            inputs = _targets(cfg, rng, batch, training=True)
        return state_tree, _descend(model, tx, state_tree, inputs, loss_denom, all_reduce)

    return step


def make_eval_step(cfg: PoseConfig, model: OpenPose, loss_denom: int | None = None,
                   all_reduce=None):
    """step(params, batch) -> losses: forward-only loss on a raw batch with
    deterministic (identity) augmentation — the validation path.
    ``all_reduce`` sums the losses over a process group."""
    _no_tf32()

    @torch.no_grad()
    def step(params, batch):
        batch = _to_device(batch, _device_of(params))
        images_norm, paf_gt, heat_gt, label_mask = _targets(cfg, None, batch, training=False)
        outputs = functional_call(model, dict(params), (images_norm,))
        losses = loss_lib.stagewise_losses(outputs, paf_gt, heat_gt, label_mask, loss_denom)
        if all_reduce is not None:
            keys = list(losses)
            flat = torch.stack([losses[k] for k in keys]).to(torch.float32)
            all_reduce(flat)
            losses = dict(zip(keys, flat))
        return losses

    return step


def make_preprocessed_step(cfg: PoseConfig, model: OpenPose, tx: opt_lib.MultiSGD):
    """step(state_tree, batch) for pre-rasterised batches (images_norm,
    paf_gt, heat_gt, label_mask) — the generator-fed mode."""
    _no_tf32()

    def step(state_tree, batch):
        b = _to_device(batch, _device_of(state_tree["params"]))
        inputs = (b["images_norm"], b["paf_gt"], b["heat_gt"], b["label_mask"])
        return state_tree, _descend(model, tx, state_tree, inputs, None)

    return step
