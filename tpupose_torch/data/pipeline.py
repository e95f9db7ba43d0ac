"""Host data pipeline: packed HDF5 / `.tpr` / synthetic -> prefetched batches.

Counterpart of ``tpupose/data/pipeline.py``. Augmentation and label
rasterisation run on the device inside the train step
(``training/train.py``; the gt kernel on the card), so the host pipeline
only reads, pads to static shapes, batches, and prefetches — a python
thread is ample for that.

Batch contract (what make_train_step consumes):
  images (N, H, W, 3) uint8, masks (N, H, W) uint8 (0..255),
  joints (N, P, 18, 3) f32, centers (N, 2) f32, scales (N,) f32
  (the step casts/normalises on device; f32 batches are also accepted).
"""

from __future__ import annotations

import collections
import itertools
import json
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator

import numpy as np

from tpupose_torch import topology
from tpupose_torch.config import PoseConfig
from tpupose_torch.data import hdf5 as hdf5_io


def process_shard() -> tuple[int, int]:
    """``(rank, world size)`` of this process for ``shard="auto"``: the
    initialised ``torch.distributed`` process group's, else ``(0, 1)``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_checkpointable(batches) -> bool:
    """Whether a feed supports exact-position checkpoint/resume: the duck
    type ``get_state() -> bytes`` / ``set_state(bytes)`` (``TprBatches``).
    The port's copy of ``tpupose/data/grain_pipeline.is_checkpointable``."""
    return hasattr(batches, "get_state") and hasattr(batches, "set_state")


def batch_samples(
    samples: Iterable[dict],
    batch_size: int,
    target_h: int,
    target_w: int,
    max_persons: int,
    drop_remainder: bool = True,
    num_workers: int = 4,
) -> Iterator[dict[str, np.ndarray]]:
    """Pad each sample to static shape and stack into batches.

    Per-sample padding (cv2 resize + copies) runs on a thread pool —
    cv2/numpy release the GIL, so prep overlaps across samples.
    """
    def pad(s):
        return hdf5_io.pad_sample(s, target_h, target_w, max_persons)

    # bounded futures window: Executor.map would consume an infinite
    # sample iterator eagerly
    window = max(num_workers, 1) * 2
    buf: list[dict] = []
    with ThreadPoolExecutor(max_workers=max(num_workers, 1)) as pool:
        futures: collections.deque = collections.deque()
        it = iter(samples)

        def drain_one():
            nonlocal buf
            buf.append(futures.popleft().result())
            if len(buf) == batch_size:
                out = _stack(buf)
                buf = []
                return out
            return None

        for s in it:
            futures.append(pool.submit(pad, s))
            if len(futures) >= window:
                out = drain_one()
                if out is not None:
                    yield out
        while futures:
            out = drain_one()
            if out is not None:
                yield out
    if buf and not drop_remainder:
        while len(buf) < batch_size:  # repeat-pad the tail batch
            buf.append(buf[-1])
        yield _stack(buf)


def _stack(buf: list[dict]) -> dict[str, np.ndarray]:
    # uint8 images/masks: 4x less host->device transfer; the train step
    # casts on device (augmentation gathers in f32 regardless)
    masks = np.stack([b["mask"] for b in buf])
    return {
        "images": np.stack([b["image"] for b in buf]).astype(np.uint8),
        "masks": np.round(masks * 255.0).astype(np.uint8),
        "joints": np.stack([b["joints"] for b in buf]),
        "centers": np.stack([b["center"] for b in buf]),
        "scales": np.stack([b["scale_provided"] for b in buf]),
    }


def prefetch(
    it: Iterable, depth: int = 2
) -> Iterator:
    """Thread-backed prefetch so host IO overlaps device steps."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = object()
    err: list[BaseException] = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            if err:
                raise err[0]
            return
        yield item


def hdf5_batches(
    path: str,
    cfg: PoseConfig,
    target_h: int = 368,
    target_w: int = 368,
    epochs: int | None = None,
    shuffle_seed: int | None = 0,
    prefetch_depth: int = 2,
    num_workers: int = 4,
    shard: tuple[int, int] | str | None = None,
) -> Iterator[dict[str, np.ndarray]]:
    """The standard training feed: packed HDF5 -> padded, prefetched batches.

    ``num_workers`` sizes the sample-prep thread pool (1 = serial, for
    deterministic debugging).

    ``shard=(index, count)`` makes this process read every count-th
    record starting at index — the multi-host data-parallel contract
    (each host feeds its own disjoint slice; the shuffled order is
    seed-identical across hosts). Every shard is truncated to
    ``num_records // count`` records per epoch so ALL hosts yield the
    same number of batches: a ragged shard would leave one host inside
    a collective the others never enter (multi-host deadlock on finite
    feeds). ``shard="auto"`` reads :func:`process_shard`; None (default)
    reads everything.

    `.tpr` paths read through the native inflater
    (``data/tpr.read_samples``) — same record contract, same semantics
    (pre-padded `.tpr` files should prefer ``tpr_batches``'s fast path).
    """
    if path.endswith(".tpr"):
        from tpupose_torch.data import tpr as reader_mod
    else:
        reader_mod = hdf5_io

    if shard == "auto":
        shard = process_shard()
    per_shard = None
    if shard is not None:
        s_idx, s_cnt = shard
        if not 0 <= s_idx < s_cnt:
            raise ValueError(f"bad shard {shard!r}")
        if s_cnt == 1:
            shard = None
        else:
            per_shard = reader_mod.num_samples(path) // s_cnt
            if per_shard == 0:
                # with default epochs=None this would otherwise busy-spin
                # yielding nothing forever — fail loudly instead
                raise ValueError(
                    f"dataset {path!r} has fewer records "
                    f"({reader_mod.num_samples(path)}) than shards ({s_cnt})"
                )

    def epochs_iter():
        counter = itertools.count() if epochs is None else range(epochs)
        for e in counter:
            seed = None if shuffle_seed is None else shuffle_seed + e
            it = reader_mod.read_samples(path, shuffle_seed=seed)
            if shard is not None:
                it = itertools.islice(
                    (s for i, s in enumerate(it) if i % s_cnt == s_idx),
                    per_shard,
                )
            yield from it

    batches = batch_samples(
        epochs_iter(),
        cfg.train.batch_size,
        target_h,
        target_w,
        cfg.augment.max_persons,
        num_workers=num_workers,
    )
    return prefetch(batches, prefetch_depth)


def tpr_batches(
    path: str,
    cfg: PoseConfig,
    target_h: int = 368,
    target_w: int = 368,
    epochs: int | None = None,
    shuffle_seed: int | None = 0,
    prefetch_depth: int = 2,
    threads: int = 8,
    num_workers: int = 4,
    shard: tuple[int, int] | str | None = None,
) -> Iterator[dict[str, np.ndarray]]:
    """Training feed over a native `.tpr` dataset (``data/pack_tpr.py``).

    For PRE-PADDED files whose record geometry matches
    ``(target_h, target_w)`` the hot loop is a single
    ``TprReader.read_batch_into`` call per batch — C++ threads inflate
    every record directly into the batch arrays (no per-sample cv2, no
    Python stacking; the GIL is released for the whole call). Metadata
    (joints/centers/scales) is parsed once at open into dense arrays and
    sliced per batch.

    Files that are not pre-padded (or whose geometry differs) fall back
    to the generic pad-and-stack path, still reading through the native
    inflater. Shard semantics match ``hdf5_batches`` exactly: seed-
    identical shuffled order across hosts, every count-th position,
    truncated so all hosts yield the same number of batches.

    The fast path returns a :class:`TprBatches` — a CHECKPOINTABLE
    iterator (``get_state``/``set_state``, the same duck-type contract
    as the reference's Grain feed), so ``training.loop.train`` persists the
    exact mid-epoch data position in every checkpoint. The native feed is
    therefore both the fastest and the operational option.
    """
    from tpupose_torch.data import tpr

    if shard == "auto":
        shard = process_shard()
    if shard is not None:
        s_idx, s_cnt = shard
        if not 0 <= s_idx < s_cnt:
            raise ValueError(f"bad shard {shard!r}")
        if s_cnt == 1:
            shard = None

    reader = tpr.TprReader(path)
    n_rec = reader.count
    if n_rec == 0:
        reader.close()
        raise ValueError(f"dataset {path!r} is empty")
    if shard is not None and n_rec // s_cnt == 0:
        reader.close()
        raise ValueError(
            f"dataset {path!r} has fewer records ({n_rec}) than "
            f"shards ({s_cnt})"
        )
    meta0 = reader.meta(0)
    fast = (
        reader.static_shapes
        and bool(meta0.get("prepadded"))
        and reader.dims(0) == (target_h, target_w)
    )
    if not fast:
        reader.close()
        return hdf5_batches(
            path, cfg, target_h=target_h, target_w=target_w, epochs=epochs,
            shuffle_seed=shuffle_seed, prefetch_depth=prefetch_depth,
            num_workers=num_workers, shard=shard,
        )

    batch = cfg.train.batch_size
    max_p = cfg.augment.max_persons

    # metadata is tiny relative to pixels: densify once at open
    joints_all = np.full((n_rec, max_p, topology.NUM_PARTS, 3), 2.0,
                         np.float32)
    areas_all = np.zeros((n_rec, max_p), np.float32)
    centers_all = np.zeros((n_rec, 2), np.float32)
    scales_all = np.zeros((n_rec,), np.float32)
    for i in range(n_rec):
        m = meta0 if i == 0 else reader.meta(i)
        j = np.asarray(m["joints"], np.float32)
        if j.size == 0:
            j = j.reshape(0, topology.NUM_PARTS, 3)
        p = min(j.shape[0], max_p)
        joints_all[i, :p] = j[:p]
        a = np.asarray(m.get("areas", ()), np.float32)
        areas_all[i, : min(len(a), max_p)] = a[:max_p]
        centers_all[i] = np.asarray(m["center"], np.float32)[:2]
        scales_all[i] = np.float32(m["scale_provided"])

    return TprBatches(
        reader=reader,
        meta_arrays=(joints_all, centers_all, scales_all),
        batch=batch,
        geometry=(target_h, target_w),
        epochs=epochs,
        shuffle_seed=shuffle_seed,
        shard=None if shard is None else (s_idx, s_cnt),
        threads=threads,
        prefetch_depth=prefetch_depth,
    )


class TprBatches:
    """Checkpointable prefetched iterator over a pre-padded `.tpr` file.

    State is the pair ``(epoch, offset)`` of the NEXT batch to hand out
    — serialized as JSON bytes through ``get_state``/``set_state``, the
    same duck-type contract Grain's iterators use, so
    ``training/checkpoint.py`` stores it in the checkpoint file beside the
    model state and ``loop.train`` needs no feed-specific code.
    A producer thread keeps ``prefetch_depth`` batches decompressed
    ahead of the consumer; each queued batch carries the state that
    RESUMES AFTER it, so a restore never replays or skips a batch
    regardless of what was in flight at save time.
    """

    def __init__(self, reader, meta_arrays, batch, geometry, epochs,
                 shuffle_seed, shard, threads, prefetch_depth):
        self._reader = reader
        self._joints, self._centers, self._scales = meta_arrays
        self._batch = batch
        self._h, self._w = geometry
        self._epochs = epochs
        self._seed = shuffle_seed
        self._shard = shard
        self._threads = threads
        self._depth = max(1, prefetch_depth)
        self._pos = (0, 0)          # state of the next batch to consume
        self._queue: queue.Queue | None = None
        self._stop: threading.Event | None = None
        self._thread: threading.Thread | None = None
        self._exhausted = False

    # -- order/position bookkeeping ------------------------------------

    def _order(self, epoch: int) -> np.ndarray:
        n = len(self._scales)
        if self._seed is None:
            order = np.arange(n)
        else:
            order = np.random.default_rng(self._seed + epoch).permutation(n)
        if self._shard is not None:
            s_idx, s_cnt = self._shard
            order = order[s_idx::s_cnt][: n // s_cnt]
        return order

    def _advance(self, epoch: int, k: int, order_len: int):
        k += self._batch
        if k + self._batch > order_len:
            return epoch + 1, 0
        return epoch, k

    # -- producer ------------------------------------------------------

    def _produce(self, q: queue.Queue, stop: threading.Event,
                 pos: tuple[int, int]):
        sentinel_sent = False
        try:
            epoch, k = pos
            while self._epochs is None or epoch < self._epochs:
                order = self._order(epoch)
                if len(order) < self._batch:
                    break
                while k + self._batch <= len(order):
                    if stop.is_set():
                        return
                    idx = order[k:k + self._batch]
                    imgs = np.empty((self._batch, self._h, self._w, 3),
                                    np.uint8)
                    masks = np.empty((self._batch, self._h, self._w),
                                     np.uint8)
                    self._reader.read_batch_into(idx, imgs, masks,
                                                 threads=self._threads)
                    item = {
                        "images": imgs,
                        "masks": masks,
                        "joints": self._joints[idx],
                        "centers": self._centers[idx],
                        "scales": self._scales[idx],
                    }
                    nxt = self._advance(epoch, k, len(order))
                    while not stop.is_set():
                        try:
                            q.put((item, nxt, None), timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    k += self._batch
                epoch += 1
                k = 0
            q.put((None, None, None))      # end of feed
            sentinel_sent = True
        except BaseException as e:
            while not sentinel_sent and not stop.is_set():
                try:
                    q.put((None, None, e), timeout=0.1)
                    break
                except queue.Full:
                    continue

    def _ensure_thread(self):
        if self._thread is None:
            self._queue = queue.Queue(maxsize=self._depth)
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._produce,
                args=(self._queue, self._stop, self._pos),
                daemon=True,
            )
            self._thread.start()

    def _kill_thread(self):
        if self._thread is not None:
            self._stop.set()
            # drain so a blocked put() observes the stop flag
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=10)
            self._thread = None
            self._queue = None
            self._stop = None

    # -- iterator protocol ---------------------------------------------

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        if self._exhausted:
            raise StopIteration
        self._ensure_thread()
        item, nxt, err = self._queue.get()
        if err is not None:
            raise err
        if item is None:
            self._exhausted = True   # repeated next() must not block
            raise StopIteration
        self._pos = nxt
        return item

    # -- checkpoint contract (the duck type of is_checkpointable) ------

    def get_state(self) -> bytes:
        return json.dumps({"epoch": self._pos[0], "offset": self._pos[1],
                           "version": 1}).encode()

    def set_state(self, state: bytes) -> None:
        s = json.loads(state.decode())
        self._kill_thread()
        self._pos = (int(s["epoch"]), int(s["offset"]))
        self._exhausted = False

    def close(self) -> None:
        self._kill_thread()
        self._reader.close()


def dataset_batches(path: str, cfg: PoseConfig, **kwargs):
    """Extension-dispatching training feed: `.tpr` -> native fast path,
    anything else -> the HDF5 reader."""
    if path.endswith(".tpr"):
        return tpr_batches(path, cfg, **kwargs)
    return hdf5_batches(path, cfg, **kwargs)


def synthetic_batches(
    cfg: PoseConfig,
    target_h: int = 368,
    target_w: int = 368,
    seed: int = 0,
    n_batches: int | None = None,
) -> Iterator[dict[str, np.ndarray]]:
    """Deterministic synthetic feed for smoke tests and benchmarks."""
    rng = np.random.default_rng(seed)
    n = cfg.train.batch_size
    p = cfg.augment.max_persons
    count = itertools.count() if n_batches is None else range(n_batches)
    for _ in count:
        joints = np.full((n, p, 18, 3), 2.0, np.float32)
        joints[:, 0, :, 0] = rng.uniform(20, target_w - 20, (n, 18))
        joints[:, 0, :, 1] = rng.uniform(20, target_h - 20, (n, 18))
        joints[:, 0, :, 2] = 0.0
        yield {
            "images": rng.uniform(0, 255, (n, target_h, target_w, 3)).astype(
                np.uint8
            ),
            "masks": np.full((n, target_h, target_w), 255, np.uint8),
            "joints": joints,
            "centers": np.tile(
                np.asarray([[target_w / 2, target_h / 2]], np.float32), (n, 1)
            ),
            "scales": np.full((n,), 0.8, np.float32),
        }
