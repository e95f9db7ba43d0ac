"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel is one source, ``tpupose_torch/csrc/<name>.cu``, exporting an
``extern "C"`` launcher that enqueues the kernel on the stream it is given
and returns the ``cudaError_t`` of the launch. The first launch of a
kernel compiles its source with nvcc for ``sm_90a`` into a shared library
under ``tpupose_torch/_build/`` and loads it with ``ctypes`` (a plain C
interface: no PyTorch headers, so a build takes seconds). The library's
file name carries a hash of the sources and flags, so an edited source is
rebuilt and a stale library is never loaded. Without nvcc the build
raises: there is no fallback for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
_HEADERS = ("common.cuh", "hopper.cuh")


def find_nvcc() -> str:
    """nvcc from PATH, ``$CUDA_HOME/bin`` or ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the port's CUDA "
        "kernels are compiled from tpupose_torch/csrc at first use"
    )


class CudaKernel:
    """One hand-written kernel: its source, its C launcher, its launch count.

    ``launches`` counts the calls of ``launch`` that enqueued the kernel;
    callers reset it to measure which kernels a run went through.
    """

    def __init__(self, name: str, symbol: str, argtypes: list, replaces: str):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces          # file:line of the Pallas kernel
        self.source = f"tpupose_torch/csrc/{name}.cu"
        self.launches = 0
        self._fn = None
        self._lock = threading.Lock()

    def _lib_path(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for fname in (f"{self.name}.cu", *_HEADERS):
            with open(os.path.join(CSRC, fname), "rb") as f:
                h.update(f.read())
        return os.path.join(BUILD_DIR, f"lib{self.name}-{h.hexdigest()[:16]}.so")

    @staticmethod
    def _tmp_path(lib: str) -> str:
        """Where nvcc writes before the library is renamed into place: one
        file per process and thread, so that two builds of one kernel (a
        server's request threads, say) never write the same file and the
        rename only ever moves a complete library."""
        return f"{lib[:-3]}.{os.getpid()}.{threading.get_ident()}.tmp.so"

    def compile_command(self) -> tuple[list[str], str]:
        """(nvcc argv writing a temporary file, final library path)."""
        lib = self._lib_path()
        tmp = self._tmp_path(lib)
        argv = [find_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
                os.path.join(CSRC, f"{self.name}.cu")]
        return argv, lib

    def build(self):
        """Compile (if no current library exists) and load; idempotent."""
        with self._lock:
            if self._fn is None:
                lib = self._lib_path()
                if not os.path.exists(lib):
                    _compile([self])
                handle = ctypes.CDLL(lib)
                fn = getattr(handle, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._handle = handle
                err = handle.tp_error_string
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._error_string = err
                self._fn = fn
        return self._fn

    def entry(self, name: str, argtypes: list):
        """Another ``extern "C"`` function of this kernel's library (a test
        entry); calling it does not count as a launch."""
        self.build()
        fn = getattr(self._handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn

    def launch(self, *args) -> None:
        """Enqueue the kernel; raise if the launch was refused."""
        fn = self.build()
        code = fn(*args)
        if code != 0:
            msg = self._error_string(code).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: {msg} ({code})")
        self.launches += 1


def _compile(kernels) -> None:
    """Run nvcc for every kernel whose library is missing, in parallel."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for k in kernels:
        argv, lib = k.compile_command()
        if os.path.exists(lib):
            continue
        proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((k, proc, argv[argv.index("-o") + 1], lib))
    failed = []
    for k, proc, tmp, lib in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{k.source}:\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def build_all(kernels) -> None:
    """Compile the missing libraries of ``kernels`` together, then load."""
    _compile([k for k in kernels if k._fn is None])
    for k in kernels:
        k.build()
