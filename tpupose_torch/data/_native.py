"""Build and load the port's host libraries, ``tpupose_torch/native/``.

``rle.c`` (the COCO mask codec) and ``feed.cpp`` (the ``.tpr`` reader) are
plain C / C++ for the host CPU, bound with ``ctypes``. The first use of
one compiles its source with the host compiler (``cc`` / ``c++``) into
``tpupose_torch/_build/``, writing a temporary file that is then renamed,
so a reader never loads a half-written library. The library's file name
carries a hash of the source and the command: an edited source is
rebuilt, and a library built from another source (the JAX package's
``native/``, whose libraries have the same base names) is never loaded.
A failed build raises with the compiler's stderr; nothing falls back to
the pure-Python twins.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(_PKG, "_build")
_lock = threading.Lock()


def load(name: str, source: str, compiler: list[str], libs: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (once) and load ``lib<name>`` from ``native/<source>`` with
    ``compiler + ["-o", out, source, *libs]``."""
    src = os.path.join(NATIVE_DIR, source)
    h = hashlib.sha256(" ".join([*compiler, *libs]).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    lib = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    with _lock:
        if not os.path.exists(lib):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{lib[:-3]}.{os.getpid()}.tmp.so"
            argv = [*compiler, "-o", tmp, src, *libs]
            try:
                proc = subprocess.run(argv, capture_output=True, text=True)
            except FileNotFoundError as e:
                raise RuntimeError(f"cannot build {src}: {compiler[0]!r} not found") from e
            if proc.returncode != 0:
                raise RuntimeError(f"building {src} failed ({' '.join(argv)}):\n{proc.stderr}")
            os.replace(tmp, lib)
        return ctypes.CDLL(lib)
