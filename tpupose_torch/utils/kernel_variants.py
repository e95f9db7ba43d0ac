"""Time variants of one peak kernel's source against the source itself.

    python3 -m tpupose_torch.utils.kernel_variants pyramid_peaks \\
        --variant "no peak list" "kPeakList = 1024;" "kPeakList = 0;" ...

Each ``--variant LABEL OLD NEW`` replaces the text OLD of
``tpupose_torch/csrc/<kernel>.cu`` by NEW (OLD must occur). Every variant
and the source as it stands are built with the port's nvcc flags (in
parallel, into a temporary directory), loaded in turn in place of the
kernel's library, and timed through the kernel's wrapper at the main
path's shapes: pyramid_peaks on seeded smooth heat maps (batch 8, 4
scales to 368x368), peaks on a seeded smooth field (8, 368, 368, 19).
Times are CUDA-event means of 10 calls queued behind a long matrix
product, taken in the listed order and again in reverse. Each line says
whether the variant still agrees with the plain version (a cut made only
to measure may not; the output is laid into a block filled with NaN). One JSON line per variant, then the card's name and
power limit. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile


def _ms(torch, fn, reps: int = 10) -> float:
    fn()
    ballast = torch.empty((8192, 8192), device="cuda").normal_()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.mm(ballast, ballast)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=("pyramid_peaks", "peaks"))
    ap.add_argument("--variant", nargs=3, action="append", default=[],
                    metavar=("LABEL", "OLD", "NEW"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: torch sees no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from tpupose_torch.ops import peaks, pyramid_peaks
    from tpupose_torch.ops._build import CSRC

    mod = pyramid_peaks if args.kernel == "pyramid_peaks" else peaks
    with open(os.path.join(CSRC, f"{args.kernel}.cu")) as f:
        source = f.read()
    variants = {"as it stands": source}
    for label, old, new in args.variant:
        if old not in source:
            raise SystemExit(f"kernel_variants: {old!r} is not in {args.kernel}.cu")
        variants[label] = source.replace(old, new)

    tmp = tempfile.mkdtemp()
    try:
        return _measure(args, mod, variants, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _measure(args, mod, variants: dict, tmp: str) -> int:
    import numpy as np
    import torch

    from tpupose_torch.decode.peaks import gaussian_blur
    from tpupose_torch.decode.scalespace import ScaleSpace
    from tpupose_torch.ops import image, peaks, pyramid_peaks
    from tpupose_torch.ops._build import CSRC, NVCC_FLAGS, find_nvcc

    jobs = {}
    for i, (label, text) in enumerate(variants.items()):
        cu, so = os.path.join(tmp, f"v{i}.cu"), os.path.join(tmp, f"v{i}.so")
        with open(cu, "w") as f:
            f.write(text)
        argv = [find_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", so, cu]
        jobs[label] = (subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for label, (proc, so) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"kernel_variants: {label!r} does not build:\n{out[-3000:]}")
        libs[label] = ctypes.CDLL(so)

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    if mod is pyramid_peaks:
        sizes = image.scale_sizes(368, 368, (0.5, 1.0, 1.5, 2.0), 368, 8)
        maps = []
        for _, _, ph, pw in sizes:
            m = rng.normal(size=(8, ph // 8, pw // 8, 19)).astype(np.float32)
            maps.append(torch.from_numpy((m + np.roll(m, 1, 1) + np.roll(m, 1, 2)) / 3.0 * 0.6)
                        .cuda())
        space = ScaleSpace(maps, [s[:2] for s in sizes], (368, 368))
        call = lambda: pyramid_peaks.pyramid_peak_scores(space, 18, 3.0, 0.1)  # noqa: E731
        want = pyramid_peaks.pyramid_peak_scores_plain(space, 18, 3.0, 0.1)
    else:
        noise = torch.from_numpy(rng.normal(size=(8, 368, 368, 19)).astype(np.float32)).cuda()
        field = gaussian_blur(noise, 4.0) * 0.75
        call = lambda: peaks.peak_scores(field, 18, 3.0, 0.1)  # noqa: E731
        want = peaks.peak_scores_plain(field, 18, 3.0, 0.1)
    mask = torch.isfinite(want)

    def run(label):
        lib = libs[label]
        fn = getattr(lib, mod.KERNEL.symbol)
        fn.argtypes, fn.restype = mod.KERNEL.argtypes, ctypes.c_int
        err = lib.tp_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        mod.KERNEL._fn, mod.KERNEL._handle, mod.KERNEL._error_string = fn, lib, err
        # the output's block is the one just freed, filled with NaN: what the
        # variant leaves unwritten shows (None where the allocator chose another)
        poison = torch.full_like(want, float("nan"))
        at = poison.data_ptr()
        del poison
        got = call()
        agrees = (torch.equal(got, want) if mod is peaks else
                  bool(torch.equal(torch.isfinite(got), mask))
                  and (got[mask] - want[mask]).abs().max().item() <= 1e-5)
        return _ms(torch, call), agrees if got.data_ptr() == at else None

    times = {label: [] for label in variants}
    agree = {}
    for label in list(variants) + list(variants)[::-1]:
        ms, agree[label] = run(label)
        times[label].append(ms)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    for label, ms in times.items():
        print(json.dumps({"kernel": args.kernel, "variant": label, "ms": ms,
                          "mean_ms": sum(ms) / len(ms), "agrees_with_plain": agree[label]}),
              flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
