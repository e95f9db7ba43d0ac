"""Time variants of one kernel's source against the source itself.

    python3 -m tpupose_torch.utils.kernel_variants pyramid_peaks \\
        --variant "no peak list" "kPeakList = 1024;" "kPeakList = 0;" ...

Each ``--variant LABEL OLD NEW`` replaces the text OLD of
``tpupose_torch/csrc/<kernel>.cu`` by NEW (OLD must occur). Every variant
and the source as it stands are built with the port's nvcc flags (in
parallel, into a temporary directory), loaded in turn in place of the
kernel's library, and timed through the kernel's wrapper at the main
path's shapes: pyramid_peaks on seeded smooth heat maps (batch 8, 4
scales to 368x368), peaks on a seeded smooth field (8, 368, 368, 19),
assoc on seeded random tables (batch 8, K = 96, 512 candidates a limb)
and on the tables of 8 crowded 720x1280 frames (``testing.crowded_scene``,
32 people each), gt on a seeded training batch (10 samples, 24 persons, 6
live, 46x46). Times are CUDA-event means of 10 calls queued behind a long
matrix product, taken in the listed order and again in reverse. Each line
says whether the variant still agrees with the plain version (a cut made
only to measure may not; for the peak kernels the output is laid into a
block filled with NaN). One JSON line per variant and input, then the
card's name and power limit. Exits non-zero without a CUDA device.
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
    ap.add_argument("kernel", choices=("pyramid_peaks", "peaks", "assoc", "gt"))
    ap.add_argument("--variant", nargs=3, action="append", default=[],
                    metavar=("LABEL", "OLD", "NEW"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: torch sees no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from tpupose_torch import ops
    from tpupose_torch.ops._build import CSRC

    mod = getattr(ops, args.kernel)
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

    from tpupose_torch.ops import gt, peaks, pyramid_peaks
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
    cases = _inputs(args.kernel, np, torch)

    def run(label, call, want):
        lib = libs[label]
        fn = getattr(lib, mod.KERNEL.symbol)
        fn.argtypes, fn.restype = mod.KERNEL.argtypes, ctypes.c_int
        err = lib.tp_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        mod.KERNEL._fn, mod.KERNEL._handle, mod.KERNEL._error_string = fn, lib, err
        if mod is pyramid_peaks or mod is peaks:
            # the output's block is the one just freed, filled with NaN: what the
            # variant leaves unwritten shows (None where the allocator chose another)
            poison = torch.full_like(want, float("nan"))
            at = poison.data_ptr()
            del poison
        got = call()
        if mod is peaks:
            agrees = torch.equal(got, want)
        elif mod is pyramid_peaks:
            mask = torch.isfinite(want)
            agrees = (bool(torch.equal(torch.isfinite(got), mask))
                      and (got[mask] - want[mask]).abs().max().item() <= 1e-5)
        elif mod is gt:
            agrees = all(torch.equal(g != 0, w != 0) and (g - w).abs().max().item() <= 1e-6
                         for g, w in zip(got, want))
        else:
            agrees = all(torch.equal(got[key], want[key]) for key in want)
        if (mod is pyramid_peaks or mod is peaks) and got.data_ptr() != at:
            agrees = None
        return _ms(torch, call), agrees

    times = {(label, case): [] for label in variants for case in cases}
    agree = {}
    for label in list(variants) + list(variants)[::-1]:
        for case, (call, want) in cases.items():
            ms, agree[label, case] = run(label, call, want)
            times[label, case].append(ms)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    for (label, case), ms in times.items():
        print(json.dumps({"kernel": args.kernel, "variant": label, "input": case, "ms": ms,
                          "mean_ms": sum(ms) / len(ms),
                          "agrees_with_plain": agree[label, case]}), flush=True)
    print(card, flush=True)
    return 0


def _inputs(kernel: str, np, torch) -> dict:
    """{input name: (the wrapper's call, the plain version's output)} at the
    main path's shapes, from seeds."""
    from tpupose_torch.config import DEFAULT
    from tpupose_torch.decode import paf as paf_mod
    from tpupose_torch.decode import peaks as peaks_mod
    from tpupose_torch.decode.scalespace import ScaleSpace
    from tpupose_torch.ops import assoc, gt, image, peaks, pyramid_peaks

    rng = np.random.default_rng(0)
    icfg = DEFAULT.inference
    if kernel == "pyramid_peaks":
        sizes = image.scale_sizes(368, 368, (0.5, 1.0, 1.5, 2.0), 368, 8)
        maps = []
        for _, _, ph, pw in sizes:
            m = rng.normal(size=(8, ph // 8, pw // 8, 19)).astype(np.float32)
            maps.append(torch.from_numpy((m + np.roll(m, 1, 1) + np.roll(m, 1, 2)) / 3.0 * 0.6)
                        .cuda())
        space = ScaleSpace(maps, [s[:2] for s in sizes], (368, 368))
        return {"pyramid": (lambda: pyramid_peaks.pyramid_peak_scores(space, 18, 3.0, 0.1),
                            pyramid_peaks.pyramid_peak_scores_plain(space, 18, 3.0, 0.1))}
    if kernel == "peaks":
        noise = torch.from_numpy(rng.normal(size=(8, 368, 368, 19)).astype(np.float32)).cuda()
        field = peaks_mod.gaussian_blur(noise, 4.0) * 0.75
        return {"field": (lambda: peaks.peak_scores(field, 18, 3.0, 0.1),
                          peaks.peak_scores_plain(field, 18, 3.0, 0.1))}
    if kernel == "gt":
        j = np.full((10, 24, 18, 3), 2.0, np.float32)
        j[:, :6, :, :2] = rng.uniform(0, 368, (10, 6, 18, 2))
        j[:, :6, :, 2] = rng.choice([0.0, 1.0, 2.0], (10, 6, 18), p=[0.6, 0.2, 0.2])
        joints = torch.from_numpy(j).cuda()
        mask = torch.from_numpy(rng.uniform(size=(10, 46, 46)).astype(np.float32)).cuda()
        return {"training batch": (lambda: gt.create_labels(joints, mask),
                                   gt.create_labels_plain(joints, mask))}
    from tpupose_torch.testing import crowded_scene

    k = icfg.max_peaks
    kw = dict(k_slots=k, n_conn=min(icfg.max_connections, k),
              max_people=max(icfg.max_people, icfg.scan_people_capacity))
    prior = torch.from_numpy(rng.normal(size=(8, 19, k, k)).astype(np.float32)).cuda()
    ok = torch.from_numpy(rng.random((8, 19, k, k)) < 0.02).cuda()
    scores = torch.from_numpy(rng.random((8, 18, k)).astype(np.float32)).cuda()
    limits = torch.from_numpy(rng.integers(1, k + 1, (8, 19)).astype(np.int32)).cuda()
    tables = {"random": (*paf_mod.candidates(prior, ok, scores, min(512, k * k)), limits)}
    hw = (720, 1280)
    sizes = image.scale_sizes(*hw, icfg.scale_search, 368, 8)
    geoms = [s[:2] for s in sizes]
    scenes = [crowded_scene(sizes, 32, seed) for seed in range(8)]
    heat = ScaleSpace([torch.cat([sc[0][i] for sc in scenes]).cuda() for i in range(len(sizes))],
                      geoms, hw)
    pafs = ScaleSpace([torch.cat([sc[1][i] for sc in scenes]).cuda() for i in range(len(sizes))],
                      geoms, hw)
    flats = pyramid_peaks.pyramid_peak_scores(heat, 18, icfg.peak_sigma, icfg.thre1)
    pk = {key: v.reshape(8, 18, k)
          for key, v in peaks_mod.peak_tables(flats.reshape(8 * 18, -1), hw[1], k).items()}
    prior, ok, n_a, n_b = paf_mod.pair_scores(pafs, pk, icfg.mid_num, icfg.thre2,
                                              icfg.connect_min_ratio)
    tables["crowded"] = (*paf_mod.candidates(prior, ok, pk["scores"], min(512, k * k)),
                         torch.minimum(n_a, n_b))
    return {name: ((lambda t=t: assoc.assoc(*t, **kw)), assoc.assoc_plain(*t, **kw))
            for name, t in tables.items()}


if __name__ == "__main__":
    sys.exit(main())
