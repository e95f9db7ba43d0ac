"""Build and load the port's host libraries, ``tpupose_torch/native/``.

``rle.c`` (the COCO mask codec) and ``feed.cpp`` (the ``.tpr`` reader) are
plain C / C++ for the host CPU, bound with ``ctypes``. The first use of
one compiles its source with the host compiler (``cc`` / ``c++``) into
``BUILD_DIR``, writing a temporary file that is then renamed, so a reader
never loads a half-written library. The library's file name carries a
hash of the source, the command and the compiler's ``--version``: an
edited source or another toolkit is rebuilt, and a library built from
another source (the JAX package's ``native/``, whose libraries have the
same base names) is never loaded. A failed build raises with the
compiler's stderr; nothing falls back to the pure-Python twins.

``BUILD_DIR`` is where every build of the port goes, the CUDA kernels'
(``ops/_build.py``) too. It defaults to ``tpupose_torch/_build/``;
``utils.compile_cache.enable_compile_cache`` points it elsewhere.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(_PKG, "_build")
_lock = threading.Lock()
builds = 0      # compiler runs of this process: a library loaded from BUILD_DIR is not one


@functools.lru_cache(maxsize=None)
def compiler_version(compiler: str) -> str:
    """What ``compiler --version`` prints, part of every library's key.
    Raises ``FileNotFoundError`` when there is no such compiler."""
    proc = subprocess.run([compiler, "--version"], capture_output=True, text=True)
    return proc.stdout + proc.stderr


def lib_path(name: str, source: str, compiler: list[str], libs: tuple[str, ...] = ()) -> str:
    """Where ``lib<name>`` built from ``native/<source>`` by ``compiler``
    lives in ``BUILD_DIR``."""
    src = os.path.join(NATIVE_DIR, source)
    try:
        version = compiler_version(compiler[0])
    except FileNotFoundError as e:
        raise RuntimeError(f"cannot build {src}: {compiler[0]!r} not found") from e
    h = hashlib.sha256(" ".join([*compiler, *libs]).encode())
    h.update(version.encode())
    with open(src, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def load(name: str, source: str, compiler: list[str], libs: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (once) and load ``lib<name>`` from ``native/<source>`` with
    ``compiler + ["-o", out, source, *libs]``."""
    global builds
    src = os.path.join(NATIVE_DIR, source)
    lib = lib_path(name, source, compiler, libs)
    with _lock:
        if not os.path.exists(lib):
            os.makedirs(os.path.dirname(lib), exist_ok=True)
            tmp = f"{lib[:-3]}.{os.getpid()}.tmp.so"
            argv = [*compiler, "-o", tmp, src, *libs]
            builds += 1
            proc = subprocess.run(argv, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building {src} failed ({' '.join(argv)}):\n{proc.stderr}")
            os.replace(tmp, lib)
        return ctypes.CDLL(lib)
