"""Device mesh and sharding: the port's one device-placement story.

The port's counterpart of ``tpupose/parallel/sharding.py``. The JAX
package expresses both of its scaling axes through one ``Mesh`` of
devices and lets XLA place every array:

  * **data parallelism**: the batch split over the ``data`` axis, the
    parameters replicated, the gradients summed;
  * **scale parallelism** (inference): the pyramid's scales ride the same
    axis as batch entries.

Here a ``Mesh`` is a grid of ``torch.device``s with axis names, and the
programs place their pieces themselves: ``shard_batch`` splits leading
axes in mesh order, ``replicate_tree`` / ``replicate_module`` copy once per
entry, and each entry's work is enqueued on its device. An entry may
repeat a device (the CPU has one; the card machine one GPU): the program
is the same, run as several replicas side by side. Across processes the
data axis is the ``torch.distributed`` process group
(``parallel.distributed``), one process per device.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Sequence

import numpy as np
import torch


def local_devices(device: str | torch.device | None = None) -> list[torch.device]:
    """The devices a mesh of this process can hold: every visible CUDA
    device for ``"cuda"``, the CPU for ``"cpu"``; None picks CUDA where it
    is available."""
    kind = torch.device(device).type if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu")
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


def _grid(devices) -> np.ndarray:
    flat = list(devices.flat) if isinstance(devices, np.ndarray) else list(devices)
    shape = devices.shape if isinstance(devices, np.ndarray) else (len(flat),)
    grid = np.empty(len(flat), dtype=object)
    for i, d in enumerate(flat):
        grid[i] = torch.device(d)
    return grid.reshape(shape)


class Mesh:
    """A grid of devices with one name per axis (``jax.sharding.Mesh``):
    ``devices`` an object array of ``torch.device``, ``shape`` the axis
    sizes by name, ``size`` the entry count."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = _grid(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-D device grid with axes {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor lies on a mesh (``NamedSharding`` of ``P(axis)`` or
    ``P()``): its leading axis split over the mesh axis ``axis`` and
    replicated over the others; no axis: replicated everywhere."""

    mesh: Mesh
    axis: str | None = None

    def place(self, x) -> np.ndarray:
        """One piece of ``x`` per mesh entry, on that entry's device, as an
        object array of the mesh's shape."""
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        devices = self.mesh.devices
        out = np.empty(devices.shape, dtype=object)
        if self.axis is None:
            for idx in np.ndindex(*out.shape):
                out[idx] = t.to(devices[idx], copy=True)
            return out
        count = self.mesh.shape[self.axis]
        if t.shape[0] % count:
            raise ValueError(f"leading axis {t.shape[0]} does not split into {count} shards")
        rows, i = t.shape[0] // count, self.mesh.axis_names.index(self.axis)
        for idx in np.ndindex(*out.shape):
            out[idx] = t[idx[i] * rows:(idx[i] + 1) * rows].to(devices[idx], copy=True)
        return out


def make_mesh(num_devices: int | None = None, axis: str = "data",
              devices: Sequence[torch.device] | None = None) -> Mesh:
    """1-D mesh over the first ``num_devices`` of ``devices`` (default:
    ``local_devices()``)."""
    devs = list(devices) if devices is not None else local_devices()
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(devs, (axis,))


def batch_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """Leading-axis sharding for batched tensors."""
    return Sharding(mesh, axis)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh)


def shard_batch(mesh: Mesh, batch: dict[str, Any], axis: str = "data") -> dict[str, np.ndarray]:
    """Every leaf split along its leading axis over the mesh: per key, the
    mesh-shaped array of its pieces."""
    sh = batch_sharding(mesh, axis)
    return {k: sh.place(v) for k, v in batch.items()}


def replicate_tree(mesh: Mesh, tree: dict[str, Any]) -> dict[str, np.ndarray]:
    sh = replicated(mesh)
    return {k: sh.place(v) for k, v in tree.items()}


def replicate_module(module: torch.nn.Module, mesh: Mesh) -> list[torch.nn.Module]:
    """One copy of ``module`` per mesh entry (in ``mesh.devices.flat``
    order) on that entry's device, 4-D weights channels_last: the weights
    are copied once, here."""
    return [copy.deepcopy(module).to(dev, memory_format=torch.channels_last)
            for dev in mesh.devices.flat]


def kept_replicas(estimator, mesh: Mesh) -> list[torch.nn.Module]:
    """``replicate_module`` of ``estimator.model`` over ``mesh``, made once
    per mesh layout and kept on the estimator."""
    kept = vars(estimator).setdefault("_mesh_replicas", {})
    key = (tuple(str(d) for d in mesh.devices.flat), tuple(mesh.shape.items()))
    if key not in kept:
        kept[key] = replicate_module(estimator.model, mesh)
    return kept[key]


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


# Pad values per batch key: padded samples must be inert — a zero
# miss-mask kills their loss contribution, absent joints (v=2) keep the
# GT rasteriser away, scale 1 keeps the augmentation affine well-posed.
_PAD_VALUES = {"masks": 0, "joints": 2.0, "scales": 1.0}


def pad_batch(
    batch: dict[str, Any], multiple: int
) -> tuple[dict[str, Any], int]:
    """Pad every leaf's leading axis to a multiple of ``multiple`` (numpy).

    Returns (padded_batch, real_count); a padded batch gets a ``weight``
    row (1 for real samples, 0 for padding) that the train step multiplies
    into the label mask, and the loss divisor stays the real count."""
    n = next(iter(batch.values())).shape[0]
    target = pad_to_multiple(n, multiple)
    if target == n:
        return batch, n
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        widths = [(0, target - n)] + [(0, 0)] * (v.ndim - 1)
        out[k] = np.pad(v, widths, constant_values=_PAD_VALUES.get(k, 0))
    # explicit per-sample weight: a zero miss-mask alone is NOT enough,
    # because the augmentation's label-grid mask sampler reads 1.0 (keep)
    # outside the source image — the train step multiplies this into the
    # label mask after augmentation
    weight = np.zeros((target,), np.float32)
    weight[:n] = batch.get("weight", np.ones((n,), np.float32))
    out["weight"] = weight
    return out, n


def data_mesh_for_batch(batch_size: int, axis: str = "data",
                        devices: Sequence[torch.device] | None = None) -> Mesh:
    """Largest mesh over ``devices`` (default ``local_devices()``) whose
    size divides the batch, so that batches split evenly."""
    devs = list(devices) if devices is not None else local_devices()
    size = 1
    for d in range(1, min(batch_size, len(devs)) + 1):
        if batch_size % d == 0:
            size = d
    return make_mesh(size, axis, devs)
