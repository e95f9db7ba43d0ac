"""The comparisons that decide a run's ``correct``, one module per kind of
output. Each returns named numbers; the workload file gives each its
limit."""

import numpy as np


def sample(seed: int, n: int, k: int) -> list[int]:
    """``k`` of ``n`` indices, drawn from the seed: the answers a run
    checks."""
    rng = np.random.default_rng([seed, 0x5EED])
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())
