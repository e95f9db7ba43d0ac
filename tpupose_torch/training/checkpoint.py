"""Checkpoint / resume.

Counterpart of ``tpupose/training/checkpoint.py`` (Orbax there).
(params, momentum, step) are saved together, atomically, with a
retention policy, and restored together: a resumed run continues exactly
where the saved one stood.

One checkpoint is one file ``<directory>/step_<step>.npz`` of numpy
arrays, written to a temporary file and renamed. Parameters and momentum
are stored in the reference's flax layout (``params/<scope>/<layer>/
kernel|bias`` with HWIO kernels, via ``models.weights``), so either
package can read the other's trees from it. A checkpointable feed's
position (``data_iter.get_state()``, ``data/pipeline.is_checkpointable``)
rides the same file as the ``uint8`` array ``data_state``, so the model
state and the data position are written atomically together (the part
the Orbax composite plays in the reference).

Two save paths, as in the reference:
  * ``save`` — one synchronous write (tools, tests).
  * ``AsyncSaver`` — ``save`` returns once the tensors are copied to the
    host; the file is written on a thread, so the step loop never waits
    on serialisation or the disk. ``restore`` and ``latest_step`` first
    wait for a pending write of this process to the same directory.
"""

from __future__ import annotations

import os
import re
import threading
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


# directory -> the thread writing its newest checkpoint (AsyncSaver)
_pending: dict[str, threading.Thread] = {}
_pending_lock = threading.Lock()


def _wait_pending(directory: str) -> None:
    with _pending_lock:
        thread = _pending.get(os.path.abspath(directory))
    if thread is not None:
        thread.join()


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


def _host_copy(state_tree: dict[str, Any], data_iter: Any | None) -> dict[str, Any]:
    """What a checkpoint holds, copied to the host now: later in-place
    updates of the live tensors cannot reach it."""
    opt = state_tree["opt_state"]
    snap: dict[str, Any] = {"step": int(state_tree["step"])}
    snap.update({k: int(opt[k]) for k in _COUNTERS})
    for name in _TREES:
        tree = state_tree["params"] if name == "params" else opt.get(name)
        if tree is not None:
            snap[name] = {k: v.detach().to("cpu", non_blocking=False, copy=True)
                          for k, v in tree.items()}
    if data_iter is not None:
        snap["data_state"] = np.frombuffer(data_iter.get_state(), np.uint8).copy()
    return snap


def _write(directory: str, snap: dict[str, Any], max_to_keep: int) -> None:
    arrays = {"step": np.asarray(snap["step"], np.int64)}
    arrays.update({k: np.asarray(snap[k], np.int64) for k in _COUNTERS})
    for name in _TREES:
        if name in snap:
            arrays.update(_flatten(name, snap[name]))
    if "data_state" in snap:
        arrays["data_state"] = snap["data_state"]
    os.makedirs(directory, exist_ok=True)
    final = _path(directory, snap["step"])
    tmp = f"{final}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    for old in _steps(directory)[:-max_to_keep]:
        os.remove(_path(directory, old))


def save(directory: str, state_tree: dict[str, Any], max_to_keep: int = 5,
         data_iter: Any | None = None) -> int:
    """Write the tree as checkpoint ``state_tree["step"]``, with
    ``data_iter``'s position when given; drop all but the newest
    ``max_to_keep``. Returns the step."""
    _wait_pending(directory)
    snap = _host_copy(state_tree, data_iter)
    _write(directory, snap, max_to_keep)
    return snap["step"]


class AsyncSaver:
    """Non-blocking checkpointing for the training loop.

    ``save(tree, step, data_iter)`` returns once the tensors are on the
    host (and the feed's position is taken); the file is written on a
    thread. One write is in flight at a time: a second ``save`` waits for
    the first. ``wait()`` blocks until the pending write is durable and
    raises its error, if any; ``close()`` does the same at shutdown.
    """

    def __init__(self, directory: str, max_to_keep: int = 5):
        self._dir = directory
        self._max_to_keep = max_to_keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.last_saved: int | None = None

    def save(self, state_tree: dict[str, Any], step: int | None = None,
             data_iter: Any | None = None) -> int:
        """``step``: the loop's host-side counter (default: the tree's)."""
        self.wait()
        snap = _host_copy(state_tree, data_iter)
        if step is not None:
            snap["step"] = int(step)
        self._thread = threading.Thread(target=self._run, args=(snap,),
                                        name="checkpoint-writer", daemon=True)
        with _pending_lock:
            _pending[os.path.abspath(self._dir)] = self._thread
        self._thread.start()
        self.last_saved = snap["step"]
        return snap["step"]

    def _run(self, snap: dict[str, Any]) -> None:
        try:
            _write(self._dir, snap, self._max_to_keep)
        except BaseException as e:  # raised to the caller by wait()
            self._error = e

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()


def latest_step(directory: str) -> int | None:
    _wait_pending(directory)
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


def restore(directory: str, template_tree: dict[str, Any],
            data_iter: Any | None = None) -> dict[str, Any] | None:
    """Restore the latest checkpoint onto a template tree (a fresh
    ``create_state(...)[0].tree()``): same names, devices and memory
    formats, the saved values. None if there is no checkpoint.

    ``data_iter``: a checkpointable feed to rewind to the saved data
    position (no-op, with the model state still restored, when the
    checkpoint holds no position)."""
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
        if data_iter is not None and "data_state" in arrays.files:
            data_iter.set_state(arrays["data_state"].tobytes())
        return {"params": onto(template_tree["params"], _nested(arrays, "params")),
                "opt_state": opt, "step": int(arrays["step"])}
