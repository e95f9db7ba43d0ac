"""The port's kernels and image ops.

Each kernel module pairs a hand-written CUDA kernel (``csrc/``) with its
plain PyTorch version, and dispatches by device: a CPU tensor takes the
plain version, a CUDA tensor the kernel (built at first use). There is
no switch that forces either on CUDA.
"""

from tpupose_torch.ops import assoc, block1, image, pyramid_peaks, sample  # noqa: F401
from tpupose_torch.ops._build import build_all as _build_all

KERNELS = (block1.KERNEL, pyramid_peaks.KERNEL, sample.KERNEL, assoc.KERNEL)


def build_kernels() -> None:
    """Compile (in parallel) and load every kernel of the inference path."""
    _build_all(KERNELS)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}
