"""MultiSGD: SGD with momentum and per-layer learning-rate multipliers.

Counterpart of ``tpupose/training/optimizer.py`` (an optax chain there):
vgg x1 (or x0, frozen, for domain adaptation), CPM convs x1(w)/x2(b),
stage-1 branches x1(w)/x2(b), refinement stages x4(w)/x8(b), plus an L2
kernel regulariser (``weight_decay``, kernels only).

Parameters are labelled {group}_{w|b} from their names. One update is,
in this order: optional clipping of ALL gradients by their global norm
(unchanged below ``clip_norm``, else ``g / norm * clip_norm``); per label
``g + 2 wd w`` on kernels, ``trace = g + momentum * trace``,
``p -= lr(count) * mult * trace`` with ``count`` the number of updates
applied so far, from 0. A multiplier of exactly 0 leaves its parameters
bit-identical and keeps no momentum for them. ``accum_steps = k > 1``
averages k micro-batch gradients and applies one update on the k-th.

State is a plain dict (``init``) and ``update`` changes parameters and
state in place.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping

import torch

from tpupose_torch.config import TrainConfig
from tpupose_torch.models.openpose import param_group


def step_decay_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """lr = base_lr * gamma^floor(step / lr_step)."""

    def schedule(step: int) -> float:
        return cfg.base_lr * math.pow(cfg.lr_gamma, math.floor(step / cfg.lr_step))

    return schedule


def param_labels(params: Mapping[str, torch.Tensor]) -> dict[str, str]:
    """{name: {vgg|cpm|stage1|stageT}_{w|b}} for state-dict names
    (``scope.layer.weight|bias``)."""
    return {name: f"{param_group(name)}_{'w' if name.endswith('.weight') else 'b'}"
            for name in params}


def multipliers(cfg: TrainConfig) -> dict[str, float]:
    return {
        "vgg_w": cfg.vgg_lr_mult,
        "vgg_b": cfg.vgg_lr_mult * (2.0 if cfg.vgg_lr_mult > 0 else 0.0),
        "cpm_w": cfg.cpm_w_mult,
        "cpm_b": cfg.cpm_b_mult,
        "stage1_w": cfg.stage1_w_mult,
        "stage1_b": cfg.stage1_b_mult,
        "stageT_w": cfg.stageT_w_mult,
        "stageT_b": cfg.stageT_b_mult,
    }


class MultiSGD:
    """The optimizer of ``make_optimizer``; see the module docstring."""

    def __init__(self, cfg: TrainConfig, params: Mapping[str, torch.Tensor]):
        self.cfg = cfg
        self.schedule = step_decay_schedule(cfg)
        mults = multipliers(cfg)
        self.groups: dict[str, list[str]] = {}
        for name, label in param_labels(params).items():
            if mults[label] != 0.0:
                self.groups.setdefault(label, []).append(name)
        self.mults = {label: mults[label] for label in self.groups}

    def trained(self) -> list[str]:
        """Names of the parameters that an update changes."""
        return [name for names in self.groups.values() for name in names]

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        state = {"count": 0, "mini_step": 0,
                 "trace": {n: torch.zeros_like(params[n]) for n in self.trained()}}
        if self.cfg.accum_steps > 1:
            state["acc_grads"] = {n: torch.zeros_like(p) for n, p in params.items()}
        return state

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: dict,
               params: Mapping[str, torch.Tensor]) -> None:
        """One (micro-)step: ``grads`` covers every parameter."""
        cfg = self.cfg
        if cfg.accum_steps > 1:
            acc = state["acc_grads"]
            for n, g in grads.items():
                acc[n].add_((g - acc[n]) / (state["mini_step"] + 1))
            state["mini_step"] = (state["mini_step"] + 1) % cfg.accum_steps
            if state["mini_step"] != 0:
                return
            grads = {n: a.clone() for n, a in acc.items()}
            for a in acc.values():
                a.zero_()
        if cfg.clip_norm is not None:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(list(grads.values()))))
            scale = torch.where(norm < cfg.clip_norm, torch.ones_like(norm),
                                cfg.clip_norm / norm)
            grads = {n: g * scale for n, g in grads.items()}
        lr = self.schedule(state["count"])
        for label, names in self.groups.items():
            ps = [params[n] for n in names]
            gs = [grads[n] for n in names]
            if label.endswith("_w") and cfg.weight_decay > 0:
                # an l2(wd) regulariser adds wd*sum(w^2) to the loss -> 2*wd*w
                gs = torch._foreach_add(gs, ps, alpha=2.0 * cfg.weight_decay)
            traces = [state["trace"][n] for n in names]
            torch._foreach_mul_(traces, cfg.momentum)
            torch._foreach_add_(traces, gs)
            torch._foreach_add_(ps, traces, alpha=-lr * self.mults[label])
        state["count"] += 1


def make_optimizer(cfg: TrainConfig, params: Mapping[str, torch.Tensor]) -> MultiSGD:
    return MultiSGD(cfg, params)
