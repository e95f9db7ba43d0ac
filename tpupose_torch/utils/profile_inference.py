"""Where the device time of the inference cells goes, by kernel class.

    python3 -m tpupose_torch.utils.profile_inference [--readout fullres]

Runs the full-width estimator (seeded random weights, 368x368 uint8
images) on one CUDA device under ``torch.profiler`` and prints, per cell
(4 scales at batch 8, scale 1.0 at batch 16, 4 scales at batch 1): wall ms
per ``process_batch`` call on the host clock, device-busy ms (the sum of
the kernels' and copies' durations), the idle share, and the busy time by
class: the library's convolutions and matrix products, element-wise and
copy kernels, each of the port's own kernels, and the rest. One JSON line
per cell follows the table, then the card's name and power limit. Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

# a kernel's class is the first entry whose fragment its name contains
CLASSES = (
    ("block1", ("block1_kernel",)),
    ("pyramid_peaks", ("pyramid_peaks",)),
    ("sample", ("sample_staged", "sample_direct", "sample_kernel")),
    ("assoc", ("assoc_kernel",)),
    ("peaks", ("peaks_kernel", "peak_scores")),
    ("conv/GEMM", ("cudnn", "cutlass", "gemm", "conv", "xmma", "implicit", "winograd", "sgemm",
                   "nchwToNhwc", "nhwcToNchw", "cublas")),
    ("element-wise", ("elementwise", "vectorized", "Memcpy", "Memset", "copy", "CatArray",
                      "fill", "index", "reduce", "upsample", "clamp")),
)
CELLS = (("4-scale, batch 8", 8, None, 4), ("scale 1.0, batch 16", 16, (1.0,), 6),
         ("4-scale, batch 1", 1, None, 6))


def classify(name: str) -> str:
    for label, fragments in CLASSES:
        if any(f in name for f in fragments):
            return label
    return "other"


def profile_cell(torch, est, images, scales, calls: int) -> dict:
    """Profile ``calls`` warm ``process_batch`` calls; ms per call."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        est.process_batch(images, scales=scales)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(calls):
            est.process_batch(images, scales=scales)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) * 1e3 / calls
    by_class: dict[str, float] = {}
    n_kernels = 0
    for evt in prof.events():
        if "cuda" not in str(evt.device_type).lower():
            continue
        us = getattr(evt, "device_time", None)
        if us is None:
            us = evt.cuda_time
        label = classify(evt.name)
        by_class[label] = by_class.get(label, 0.0) + us / 1e3 / calls
        n_kernels += 1
    busy = sum(by_class.values())
    if busy <= 0.0:
        raise RuntimeError("the profiler recorded no device time")
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": max(0.0, 1.0 - busy / wall),
            "device_events_per_call": n_kernels / calls, "ms_by_class": by_class}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--readout", choices=("scalespace", "fullres"), default="scalespace")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_inference: torch sees no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from tpupose_torch.config import DEFAULT
    from tpupose_torch.infer import PoseEstimator

    cfg = dataclasses.replace(DEFAULT, inference=dataclasses.replace(
        DEFAULT.inference, paf_readout=args.readout))
    est = PoseEstimator(cfg, seed=args.seed, device="cuda")
    rng = np.random.default_rng(args.seed)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    results = []
    for label, batch, scales, calls in CELLS:
        images = rng.integers(0, 256, (batch, 368, 368, 3)).astype(np.uint8)
        r = profile_cell(torch, est, images, scales, calls)
        results.append({"cell": label, "readout": args.readout, "calls": calls, **r})
        parts = ", ".join(f"{k} {v:.2f} ({v / r['busy_ms']:.3f})"
                          for k, v in sorted(r["ms_by_class"].items(), key=lambda kv: -kv[1]))
        print(f"{label} ({args.readout}): wall {r['wall_ms']:.2f} ms, device busy "
              f"{r['busy_ms']:.2f} ms, idle share {r['idle_share']:.3f}, "
              f"{r['device_events_per_call']:.0f} device events per call; ms per call "
              f"(share of busy): {parts}", flush=True)
    for r in results:
        print(json.dumps(r), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
