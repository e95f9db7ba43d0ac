"""The port's kernels and image ops.

Each kernel module pairs a hand-written CUDA kernel (``csrc/``) with its
plain PyTorch version, and dispatches by device: a CPU tensor takes the
plain version, a CUDA tensor the kernel (built at first use). There is
no switch that forces either on CUDA. The inference kernels are
registered operators (``torch.library.custom_op``, namespace
``tpupose_torch``: the plain version is the CPU kernel, the launch the
CUDA kernel), so that ``torch.export`` keeps each call as one node of a
program (``deploy.py``); ``gt``, training only, is called directly.
"""

from tpupose_torch.ops import (  # noqa: F401
    assoc, block1, dense_epilogue, gt, image, peak_tables, peaks, pyramid_peaks, sample,
)
from tpupose_torch.ops._build import build_all as _build_all

KERNELS = (block1.KERNEL, pyramid_peaks.KERNEL, sample.KERNEL, assoc.KERNEL, gt.KERNEL,
           peaks.KERNEL, peak_tables.KERNEL, dense_epilogue.KERNEL)


def build_kernels() -> None:
    """Compile (in parallel) and load every kernel of the port."""
    _build_all(KERNELS)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}
