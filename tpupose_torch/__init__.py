"""tpupose_torch — the PyTorch/CUDA port of tpupose for NVIDIA Hopper.

A second package beside the JAX reference ``tpupose``, mirroring its
layout (``models/``, ``ops/``, ``decode/``, ``infer.py``) module for
module. Public functions keep the reference's layouts — NHWC maps,
(C, H*W) score maps, the same table dicts — so each one can be held
against its JAX counterpart on the same inputs.

Every Pallas kernel on the inference path has a hand-written CUDA
counterpart under ``csrc/``, built with nvcc for sm_90a at first use
(``ops/_build.py``). Each kernel's wrapper runs its plain PyTorch version
for CPU tensors and launches the kernel for CUDA tensors.

This package imports ``torch`` and never ``jax``; of the reference it
uses only the numpy-only modules ``tpupose.topology`` and
``tpupose.config``.
"""

__version__ = "0.1.0"
