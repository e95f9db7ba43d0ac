"""Training feeds. Counterpart of ``tpupose/data/pipeline.py``; of its
feeds only the synthetic one is ported so far."""

from __future__ import annotations

import itertools
from typing import Iterator

import numpy as np

from tpupose_torch.config import PoseConfig


def synthetic_batches(cfg: PoseConfig, target_h: int = 368, target_w: int = 368,
                      seed: int = 0, n_batches: int | None = None
                      ) -> Iterator[dict[str, np.ndarray]]:
    """Deterministic synthetic feed for smoke tests and benchmarks: the
    same draws, in the same order, as the reference's feed of that name."""
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
            "images": rng.uniform(0, 255, (n, target_h, target_w, 3)).astype(np.uint8),
            "masks": np.full((n, target_h, target_w), 255, np.uint8),
            "joints": joints,
            "centers": np.tile(np.asarray([[target_w / 2, target_h / 2]], np.float32), (n, 1)),
            "scales": np.full((n,), 0.8, np.float32),
        }
