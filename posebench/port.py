"""The program under test, as the benchmark builds it from a configuration.

The only module of the harness that imports ``tpupose_torch``. It turns a
configuration file into the program's ``PoseConfig`` and hands the
benchmark's own weights to the program's public entries.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def pose_config(config: dict):
    """``tpupose_torch.config.PoseConfig`` with every field the
    configuration file names replaced."""
    from tpupose_torch.config import DEFAULT

    sections = {}
    for section in ("model", "inference", "augment", "train"):
        base = getattr(DEFAULT, section)
        fields = {f.name for f in dataclasses.fields(base)}
        given = {k: (tuple(v) if isinstance(v, list) else v)
                 for k, v in config.get(section, {}).items() if k in fields}
        sections[section] = dataclasses.replace(base, **given)
    return dataclasses.replace(DEFAULT, **sections)


def to_flax(params: dict[str, torch.Tensor]) -> dict:
    """State-dict-named (O, I, kh, kw) tensors -> the nested flax-layout
    tree of numpy arrays that ``PoseEstimator(params=...)`` takes."""
    tree: dict = {}
    for key, value in params.items():
        scope, layer, leaf = key.split(".")
        arr = value.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            tree.setdefault(scope, {}).setdefault(layer, {})["kernel"] = (
                np.ascontiguousarray(arr.transpose(2, 3, 1, 0)))
        else:
            tree.setdefault(scope, {}).setdefault(layer, {})["bias"] = arr.copy()
    return tree


def estimator(config: dict, params: dict[str, torch.Tensor], device):
    from tpupose_torch.infer import PoseEstimator

    return PoseEstimator(pose_config(config), params=to_flax(params), device=device)


def write_tpr(path: str, records: list[dict], max_persons: int) -> int:
    """Writes ``records`` (image, mask, joints, center, scale_provided,
    areas) as a pre-padded ``.tpr``, the file ``tpr_batches`` reads on its
    fast path."""
    from tpupose_torch.data import tpr

    with tpr.TprWriter(path, compression="zlib", level=1) as w:
        for r in records:
            meta = {"center": [float(v) for v in r["center"]],
                    "scale_provided": float(r["scale_provided"]),
                    "joints": np.asarray(r["joints"], np.float64).tolist(),
                    "areas": [float(a) for a in r["areas"]],
                    "prepadded": {"max_persons": max_persons}}
            w.add(r["image"], r["mask"], meta)
    return len(records)


def tpr_feed(path: str, cfg, shuffle_seed: int, threads: int):
    """``data.pipeline.tpr_batches``: the checkpointable ``TprBatches``."""
    from tpupose_torch.data import pipeline

    size = cfg.model.boxsize
    return pipeline.tpr_batches(path, cfg, target_h=size, target_w=size,
                                shuffle_seed=shuffle_seed, threads=threads)


def train(cfg, batches, params: dict[str, torch.Tensor], workdir: str, max_steps: int,
          seed: int, device, on_step=None) -> dict:
    """``training.loop.train`` on one device, without a process group."""
    from tpupose_torch.training import loop

    return loop.train(cfg, batches, params=params, workdir=workdir, max_steps=max_steps,
                      seed=seed, use_mesh=False, on_step=on_step, device=device)


def empty_every_other_image() -> None:
    """Plants a fault in the program for the readings that set a limit:
    ``PoseEstimator`` answers every other image of a batch with nobody,
    where the answers are produced (half of the batch left out)."""
    from tpupose_torch.infer import PoseEstimator

    finish = PoseEstimator._finish

    def half(n, tables):
        return [p if i % 2 == 0 else [] for i, p in enumerate(finish(n, tables))]

    PoseEstimator._finish = staticmethod(half)
