"""Device kernels by class: a frozen copy of the table of
``tpupose_torch/utils/profile_inference.py``. A kernel's class is the
first entry whose fragment its name contains."""

from __future__ import annotations

CLASSES = (
    ("block1", ("block1_kernel",)),
    ("pyramid_peaks", ("pyramid_peaks", "pyramid_census", "pyramid_poisoned")),
    ("sample", ("sample_staged", "sample_direct", "sample_kernel", "sample_census",
                "sample_poisoned")),
    ("assoc", ("assoc_kernel",)),
    ("peaks", ("peaks_kernel", "peak_scores")),
    ("gt", ("gt_kernel",)),
    ("conv/GEMM", ("cudnn", "cutlass", "gemm", "conv", "xmma", "implicit", "winograd", "sgemm",
                   "nchwToNhwc", "nhwcToNchw", "cublas")),
    ("element-wise", ("elementwise", "vectorized", "Memcpy", "Memset", "copy", "CatArray",
                      "fill", "index", "reduce", "upsample", "clamp")),
)


def classify(name: str) -> str:
    for label, fragments in CLASSES:
        if any(f in name for f in fragments):
            return label
    return "other"
