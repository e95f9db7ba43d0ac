"""tpupose_torch — the PyTorch/CUDA port of tpupose for NVIDIA Hopper.

A second package beside the JAX reference ``tpupose``, mirroring its
layout (``models/``, ``ops/``, ``decode/``, ``gt/``, ``training/``,
``data/``, ``parallel/``, ``reference_impl/``, ``infer.py``, ``buckets.py``,
``tracking.py``, ``deploy.py``) module for module. Public functions keep the reference's layouts — NHWC maps,
(C, H*W) score maps, the same table dicts — so each one can be held
against its JAX counterpart on the same inputs.

Every Pallas kernel of the reference (six) has a
hand-written CUDA counterpart under ``csrc/``, built with nvcc for sm_90a at first use
(``ops/_build.py``; ``TPUPOSE_COMPILE_CACHE=<dir>`` moves the builds,
``utils/compile_cache.py``). Each kernel's wrapper runs its plain PyTorch version
for CPU tensors and launches the kernel for CUDA tensors.

This package imports ``torch`` and never ``jax``, and nothing of the
reference: ``config.py`` and ``topology.py`` are its own copies.
"""

__version__ = "0.1.0"

import os as _os

if _os.environ.get("TPUPOSE_COMPILE_CACHE"):
    from tpupose_torch.utils.compile_cache import enable_from_env as _ecc

    _ecc()
