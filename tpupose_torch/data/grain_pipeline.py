"""The checkpointable training feed: deterministic, seeded, sharded.

The port's counterpart of ``tpupose/data/grain_pipeline.py``, built on
PyTorch instead of Grain: a map-style ``torch.utils.data.Dataset`` over a
random-access record source (``Hdf5Source``, or any sequence of raw
records, such as a list in memory) and a seeded sampler, ``EpochSampler``,
whose whole state is bytes. What the feed adds over the thread feed of
``data/pipeline.py`` is operational, as in the reference:

  * a **checkpointable iterator**: ``GrainBatches.get_state()`` /
    ``set_state()`` give exact mid-epoch resume after preemption, and
    ``training.loop.train`` stores the state in every checkpoint
    (``data/pipeline.is_checkpointable``);
  * a seeded shuffle, drawn anew every epoch;
  * **shards** for multi-process feeds, with Grain's semantics: shard
    ``(index, count)`` reads the index-th of ``count`` disjoint, equal runs
    of ``num_records // count`` consecutive records (the remainder is
    dropped), so every shard yields the same number of batches;
  * optional record preparation in ``worker_count`` processes, started
    with ``spawn``; ``Hdf5Source`` opens its h5py handle lazily in each.

The order within an epoch is the port's own: a numpy permutation seeded
from (``shuffle_seed``, epoch). Grain's ``index_shuffle`` is not
reproduced, so the two feeds visit the same records of a shard in
different orders. As in Grain, the record stream runs on across epoch
boundaries (a batch may hold the end of one epoch and the start of the
next), and the last partial batch of a finite feed is dropped.

Batches are the ``make_train_step`` contract (``pipeline.batch_samples``):
images and masks uint8, joints, centers and scales f32.
"""

from __future__ import annotations

import json
import math
import os
from typing import Iterator, Sequence

import numpy as np
import torch.utils.data

from tpupose_torch.config import PoseConfig
from tpupose_torch.data import hdf5 as hdf5_io
from tpupose_torch.data.pipeline import process_shard


class Hdf5Source:
    """Random-access data source over the packed-HDF5 dataset.

    Picklable (ships to spawned worker processes holding only the path);
    the h5py handle and the sorted key table are opened lazily per
    process — h5py handles must not cross a fork/spawn boundary.
    """

    def __init__(self, path: str):
        self._path = os.path.abspath(path)
        self._pid: int | None = None
        self._file = None
        self._keys: list[str] | None = None

    def _ensure_open(self):
        if self._file is None or self._pid != os.getpid():
            import h5py

            self._file = h5py.File(self._path, "r")
            self._keys = sorted(self._file["datum"].keys())
            self._pid = os.getpid()

    def __len__(self) -> int:
        self._ensure_open()
        return len(self._keys)

    def __getitem__(self, index: int) -> dict:
        self._ensure_open()
        return hdf5_io.parse_record(self._file["datum"][self._keys[index]])

    # a stable repr (no memory address), as the reference keeps it for
    # Grain's serialized state
    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Hdf5Source({self._path!r})"

    def __getstate__(self):
        return {"path": self._path}

    def __setstate__(self, state):
        self._path = state["path"]
        self._pid = None
        self._file = None
        self._keys = None


class PadForBatch:
    """Per-sample pad/cast to the static batch contract (plural keys, so
    that the batch is a stack of these dicts). A module-level class, so it
    pickles to spawned worker processes."""

    def __init__(self, target_h: int, target_w: int, max_persons: int):
        self._h = target_h
        self._w = target_w
        self._p = max_persons

    def map(self, sample: dict) -> dict[str, np.ndarray]:
        p = hdf5_io.pad_sample(sample, self._h, self._w, self._p)
        return {
            "images": np.asarray(p["image"], np.uint8),
            "masks": np.round(p["mask"] * 255.0).astype(np.uint8),
            "joints": np.asarray(p["joints"], np.float32),
            "centers": np.asarray(p["center"], np.float32),
            "scales": np.float32(p["scale_provided"]),
        }


class EpochSampler:
    """Batches of record indices: the shard's records in a seeded order per
    epoch, ``batch_size`` at a time, over ``epochs`` epochs (None: forever).

    Its whole state is (seed, shard, epoch, position in the epoch): bytes
    from ``get_state``. Iterating starts at the current position and leaves
    the sampler where it was; ``advance`` moves it by one batch.
    """

    def __init__(self, num_records: int, batch_size: int,
                 shard: tuple[int, int] | None = None, shuffle_seed: int | None = 0,
                 epochs: int | None = None):
        s_idx, s_cnt = shard if shard is not None else (0, 1)
        if not 0 <= s_idx < s_cnt:
            raise ValueError(f"bad shard {shard!r}")
        self._per_shard = num_records // s_cnt
        self._first = s_idx * self._per_shard
        self._shard = (s_idx, s_cnt)
        self._batch = batch_size
        self._seed = shuffle_seed
        self._epochs = epochs
        self._epoch = 0
        self._pos = 0
        self._cached: tuple[int, np.ndarray] | None = None

    def _order(self, epoch: int) -> np.ndarray:
        if self._cached is None or self._cached[0] != epoch:
            keys = np.arange(self._first, self._first + self._per_shard)
            if self._seed is not None:
                keys = keys[np.random.default_rng([self._seed, epoch]).permutation(len(keys))]
            self._cached = (epoch, keys)
        return self._cached[1]

    def _take(self, epoch: int, pos: int) -> tuple[list[int] | None, int, int]:
        """The batch at (epoch, pos) and the position after it; None when
        the feed ends before the batch is full."""
        out: list[int] = []
        while len(out) < self._batch:
            if (self._epochs is not None and epoch >= self._epochs) or self._per_shard == 0:
                return None, epoch, pos
            take = min(self._batch - len(out), self._per_shard - pos)
            out.extend(int(i) for i in self._order(epoch)[pos:pos + take])
            pos += take
            if pos == self._per_shard:
                epoch, pos = epoch + 1, 0
        return out, epoch, pos

    def __iter__(self) -> Iterator[list[int]]:
        epoch, pos = self._epoch, self._pos
        while True:
            batch, epoch, pos = self._take(epoch, pos)
            if batch is None:
                return
            yield batch

    def advance(self) -> None:
        batch, self._epoch, self._pos = self._take(self._epoch, self._pos)
        if batch is None:
            raise RuntimeError("EpochSampler.advance past the end of the feed")

    def get_state(self) -> bytes:
        return json.dumps({"seed": self._seed, "shard": list(self._shard),
                           "epoch": self._epoch, "position": self._pos,
                           "version": 1}).encode()

    def set_state(self, state: bytes) -> None:
        s = json.loads(state.decode())
        if s["seed"] != self._seed or tuple(s["shard"]) != self._shard:
            raise ValueError(f"feed state of seed {s['seed']}, shard {s['shard']} given to a "
                             f"feed of seed {self._seed}, shard {list(self._shard)}")
        self._epoch, self._pos = int(s["epoch"]), int(s["position"])

    def copy(self) -> "EpochSampler":
        other = EpochSampler.__new__(EpochSampler)
        other.__dict__.update(self.__dict__)
        return other


class _Records(torch.utils.data.Dataset):
    """Map-style dataset: record i of ``source`` through ``PadForBatch``."""

    def __init__(self, source: Sequence[dict], pad: PadForBatch):
        self.source = source
        self.pad = pad

    def __len__(self) -> int:
        return len(self.source)

    def __getitem__(self, index: int) -> dict[str, np.ndarray]:
        return self.pad.map(self.source[index])


def _stack(items: list[dict]) -> dict[str, np.ndarray]:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


class BatchLoader:
    """A ``DataLoader`` factory: the dataset, the sampler and the workers.
    ``iterate(sampler)`` reads the batches ``sampler`` lists, from its
    position on, ``worker_count`` spawned processes preparing them with up
    to ``read_buffer`` batches in flight (none ahead without workers)."""

    def __init__(self, dataset: _Records, sampler: EpochSampler, worker_count: int,
                 read_buffer: int):
        self.dataset = dataset
        self.sampler = sampler
        self.worker_count = worker_count
        self.read_buffer = read_buffer

    def iterate(self, sampler: EpochSampler) -> Iterator[dict[str, np.ndarray]]:
        workers = {}
        if self.worker_count > 0:
            workers = {"multiprocessing_context": "spawn",
                       "prefetch_factor": max(1, math.ceil(self.read_buffer / self.worker_count))}
        return iter(torch.utils.data.DataLoader(
            self.dataset, batch_sampler=sampler, num_workers=self.worker_count,
            collate_fn=_stack, **workers))


class GrainBatches:
    """Iterable over batches + the checkpointable position.

    ``training.loop.train`` duck-types on ``get_state``/``set_state`` to
    persist the data position in every checkpoint. The state is the
    position after the last batch this object *yielded*, whatever the
    workers have read ahead; ``set_state`` drops the read-ahead and the
    next batch is read from the restored position.
    """

    def __init__(self, loader: BatchLoader):
        self._loader = loader
        self._pos = loader.sampler.copy()
        self._it: Iterator | None = None

    @property
    def iterator(self) -> Iterator[dict[str, np.ndarray]]:
        if self._it is None:
            self._it = self._loader.iterate(self._pos.copy())
        return self._it

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        batch = next(self.iterator)
        self._pos.advance()
        return batch

    def get_state(self) -> bytes:
        return self._pos.get_state()

    def set_state(self, state: bytes) -> None:
        self._pos.set_state(state)
        self.close()

    def close(self) -> None:
        """Stop the workers (dropping the reference ends a loader's
        iterator and its processes); the next batch starts them again."""
        self._it = None


def source_batches(
    source: Sequence[dict],
    cfg: PoseConfig,
    target_h: int = 368,
    target_w: int = 368,
    epochs: int | None = None,
    shuffle_seed: int | None = 0,
    shard: tuple[int, int] | str | None = None,
    worker_count: int = 0,
    read_buffer: int = 8,
) -> GrainBatches:
    """``hdf5_grain_batches`` over any random-access record source (a
    picklable sequence of raw records as ``hdf5.parse_record`` gives them,
    such as a list of the records of a ``.tpr`` file)."""
    n = len(source)
    if shard == "auto":
        shard = process_shard()
        if n < shard[1]:
            raise ValueError(f"dataset has fewer records ({n}) than processes")
    if shard is not None:
        s_idx, s_cnt = shard
        if not 0 <= s_idx < s_cnt:
            raise ValueError(f"bad shard {shard!r}")
        if n < s_cnt:
            raise ValueError(f"dataset has fewer records ({n}) than shards ({s_cnt})")
    sampler = EpochSampler(n, cfg.train.batch_size, shard=shard, shuffle_seed=shuffle_seed,
                           epochs=epochs)
    dataset = _Records(source, PadForBatch(target_h, target_w, cfg.augment.max_persons))
    return GrainBatches(BatchLoader(dataset, sampler, worker_count, read_buffer))


def hdf5_grain_batches(
    path: str,
    cfg: PoseConfig,
    target_h: int = 368,
    target_w: int = 368,
    epochs: int | None = None,
    shuffle_seed: int | None = 0,
    shard: tuple[int, int] | str | None = None,
    worker_count: int = 0,
    read_buffer: int = 8,
) -> GrainBatches:
    """The checkpointable training feed: packed HDF5 -> batches.

    Mirrors ``pipeline.hdf5_batches``'s contract (same batch dict;
    ``epochs=None`` runs forever) with Grain's shard semantics
    (``shard="auto"`` reads ``pipeline.process_shard()``), and supports
    exact mid-epoch resume via ``GrainBatches.get_state``.
    ``worker_count=0`` prepares records on the consumer's thread;
    ``worker_count>0`` spawns that many processes, with ``read_buffer``
    batches in flight."""
    return source_batches(Hdf5Source(path), cfg, target_h, target_w, epochs, shuffle_seed,
                          shard, worker_count, read_buffer)
