"""Persistent build cache of the port's kernels (the cold-start lever).

The port's counterpart of ``tpupose/utils/compile_cache.py``. Where the
reference keeps XLA executables, the port keeps the shared libraries it
builds at first use: the CUDA kernels of ``csrc/`` (nvcc, seconds each)
and the host libraries of ``native/`` (``cc`` / ``c++``). Each library's
file name is its key, a hash of its sources, the compiler's flags and the
compiler's ``--version`` (``ops/_build.py``, ``data/_native.py``), so one
directory can be shared by checkouts and toolkits and never hands one of
them a library built for another. A process that finds its library there
loads it without running a compiler.

Opt-in three ways:
  * env:  TPUPOSE_COMPILE_CACHE=/path/to/cache  (read at ``import tpupose_torch``)
  * CLI:  --compile-cache /path  (serve)
  * code: enable_compile_cache("/path")
"""

from __future__ import annotations

import os


def enable_compile_cache(cache_dir: str, min_compile_secs: float = 1.0) -> bool:
    """Build and load every kernel and host library of the port in
    ``cache_dir``, which is created if missing. Returns True.

    Only libraries built or loaded after the call move: one that this
    process has loaded already stays loaded from where it was. Every build
    is kept, whatever ``min_compile_secs`` says (the reference's argument,
    accepted for its callers): a kernel takes seconds to build, above the
    default of 1 s. A directory that cannot be created or written raises
    ``OSError`` naming it.
    """
    from tpupose_torch.data import _native

    path = os.path.abspath(cache_dir)
    os.makedirs(path, exist_ok=True)
    if not os.access(path, os.W_OK | os.X_OK):
        raise PermissionError(f"compile cache {path} is not writable")
    _native.BUILD_DIR = path
    return True


def enable_from_env() -> bool:
    """TPUPOSE_COMPILE_CACHE=<dir> enables the cache at import time."""
    path = os.environ.get("TPUPOSE_COMPILE_CACHE")
    if not path:
        return False
    return enable_compile_cache(path)
