"""Checkpoint / resume.

Counterpart of ``tpupose/training/checkpoint.py`` (Orbax there).
(params, momentum, step) are saved together, atomically, with a
retention policy, and restored together: a resumed run continues exactly
where the saved one stood.

One checkpoint is one file ``<directory>/step_<step>.npz`` of numpy
arrays, written to a temporary file and renamed. Parameters and momentum
are stored in the reference's flax layout (``params/<scope>/<layer>/
kernel|bias`` with HWIO kernels, via ``models.weights``), so either
package can read the other's trees from it.
"""

from __future__ import annotations

import os
import re
from typing import Any

import numpy as np
import torch

from tpupose_torch.models import weights as weights_lib

_NAME = re.compile(r"^step_(\d+)\.npz$")
_TREES = ("params", "trace", "acc_grads")
_COUNTERS = ("count", "mini_step")


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:09d}.npz")


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m)


def _flatten(prefix: str, flat: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    out = {}
    for scope, layers in weights_lib.to_flax(flat).items():
        for layer, leaves in layers.items():
            for leaf, arr in leaves.items():
                out[f"{prefix}/{scope}/{layer}/{leaf}"] = arr
    return out


def _nested(arrays, prefix: str) -> dict[str, dict[str, dict[str, np.ndarray]]]:
    tree: dict = {}
    for key in arrays.files:
        if key.startswith(prefix + "/"):
            _, scope, layer, leaf = key.split("/")
            tree.setdefault(scope, {}).setdefault(layer, {})[leaf] = arrays[key]
    return tree


def save(directory: str, state_tree: dict[str, Any], max_to_keep: int = 5) -> int:
    """Write the tree as checkpoint ``state_tree["step"]``; drop all but
    the newest ``max_to_keep``. Returns the step."""
    step = int(state_tree["step"])
    opt = state_tree["opt_state"]
    arrays = {"step": np.asarray(step, np.int64)}
    arrays.update({k: np.asarray(opt[k], np.int64) for k in _COUNTERS})
    arrays.update(_flatten("params", state_tree["params"]))
    for name in _TREES[1:]:
        if name in opt:
            arrays.update(_flatten(name, opt[name]))
    os.makedirs(directory, exist_ok=True)
    final = _path(directory, step)
    tmp = f"{final}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    for old in _steps(directory)[:-max_to_keep]:
        os.remove(_path(directory, old))
    return step


def latest_step(directory: str) -> int | None:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_params(directory: str) -> Any | None:
    """Params-only restore of the latest checkpoint: the flax-layout tree
    of numpy arrays (what ``PoseEstimator(params=...)`` takes). None if
    the directory holds no checkpoint."""
    step = latest_step(directory)
    if step is None:
        return None
    with np.load(_path(directory, step)) as arrays:
        return _nested(arrays, "params")


def restore(directory: str, template_tree: dict[str, Any]) -> dict[str, Any] | None:
    """Restore the latest checkpoint onto a template tree (a fresh
    ``create_state(...)[0].tree()``): same names, devices and memory
    formats, the saved values. None if there is no checkpoint."""
    step = latest_step(directory)
    if step is None:
        return None

    def onto(template: dict[str, torch.Tensor], saved) -> dict[str, torch.Tensor]:
        flat = weights_lib.from_flax(saved)
        if set(flat) != set(template):
            raise ValueError("checkpoint and template hold different tensors: "
                             f"{sorted(set(flat) ^ set(template))[:4]} ...")
        out = {}
        for name, like in template.items():
            out[name] = torch.empty_like(like).copy_(flat[name])
        return out

    opt_template = template_tree["opt_state"]
    with np.load(_path(directory, step)) as arrays:
        opt = {k: int(arrays[k]) for k in _COUNTERS}
        for name in _TREES[1:]:
            if name in opt_template:
                opt[name] = onto(opt_template[name], _nested(arrays, name))
        return {"params": onto(template_tree["params"], _nested(arrays, "params")),
                "opt_state": opt, "step": int(arrays["step"])}
