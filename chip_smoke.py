#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpupose_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line each (a phase that fails raises, and the script
exits non-zero):

  a. the card (nvidia-smi name and power limit) and the kernels' build
     from tpupose_torch/csrc with nvcc;
  b. each CUDA kernel against its plain PyTorch version at main-path
     shapes: block1 at 368x368 and 736x736, batch 8 (error against an f32
     truth at most 2x the plain bf16 error + 1e-3); pyramid peaks at the
     4-scale 368x368 geometry (same peak mask, values within 1e-5);
     sample at the (8, 19, 96, 96, 10) point shape (within 1e-5); assoc
     bit-equal on a planted scene's candidates and on random tables;
  c. the main path: a full-width estimator (VGG19 + 6 stages, boxsize
     368, bf16, seeded random weights) runs process_batch on 368x368
     uint8 images, batch 8 over the 4-scale pyramid and batch 16 at scale
     1.0; every kernel's launch count over that run must be > 0, and the
     bf16 network must agree with its f32 version (relative L2 <= 5e-2);
  d. a planted two-person scene decodes to 2 people on the card, with
     tables equal (integers) and within 1e-4 (floats) to the plain decode
     on the CPU;
  e. timings: images/s (4 scales, batch 8; scale 1.0, batch 16), batch-1
     latency, a network/decode split, per-kernel ms against the plain
     version.

The last three lines are the kernels' JSON record, the card's name and
power limit, and {"ok": true, "device": {...}}. Without a CUDA device, or
outside a checkout of the repository, the script exits non-zero before
printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

os.environ.pop("JAX_PLATFORMS", None)   # the port never imports jax
ROOT = os.path.dirname(os.path.abspath(__file__))


def _say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _ms(torch, fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _alternate(torch, plain, kernel, reps: int) -> tuple[float, float]:
    """(kernel ms, plain ms), measured plain, kernel, kernel, plain."""
    p1 = _ms(torch, plain, reps)
    k1 = _ms(torch, kernel, reps)
    k2 = _ms(torch, kernel, reps)
    p2 = _ms(torch, plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from tpupose import topology
    from tpupose.config import DEFAULT
    from tpupose_torch import ops
    from tpupose_torch.decode import paf as paf_mod
    from tpupose_torch.decode import peaks as peaks_mod
    from tpupose_torch.decode.api import decode_impl_batch, to_people
    from tpupose_torch.decode.scalespace import ScaleSpace
    from tpupose_torch.infer import PoseEstimator
    from tpupose_torch.models import OpenPose
    from tpupose_torch.ops import assoc as assoc_mod
    from tpupose_torch.ops import block1 as block1_mod
    from tpupose_torch.ops import image
    from tpupose_torch.ops import pyramid_peaks as pp_mod
    from tpupose_torch.ops import sample as sample_mod
    from tpupose_torch.testing import planted_scene

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    icfg = DEFAULT.inference
    sizes = image.scale_sizes(368, 368, icfg.scale_search, 368, 8)
    geoms = [s[:2] for s in sizes]
    rng = np.random.default_rng(0)
    record: dict[str, dict] = {}

    # --- a. device and build ----------------------------------------------
    card = _card()
    t0 = time.perf_counter()
    ops.build_kernels()
    _say("a", f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
              f"built {len(ops.KERNELS)} kernels with nvcc in "
              f"{time.perf_counter() - t0:.1f} s")

    def rand(shape, scale):
        return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32)).to(dev)

    # --- b. each kernel against its plain version ---------------------------
    wts = (rand((3, 3, 3, 64), 0.2), rand((64,), 0.1), rand((3, 3, 64, 64), 0.05),
           rand((64,), 0.1))
    errs, times = [], []
    for _, _, ph, pw in sizes:
        x = torch.from_numpy(rng.uniform(-0.5, 0.5, (8, ph, pw, 3)).astype(np.float32)).to(dev)
        got = block1_mod.block1(x, *wts)
        plain = block1_mod.block1_plain(x, *wts)
        if ph in (368, 736):
            truth = block1_mod.block1_plain(x, *wts, dtype=torch.float32)
            d_got = (got.float() - truth).abs().max().item()
            d_plain = (plain.float() - truth).abs().max().item()
            if not d_got <= 2 * d_plain + 1e-3:
                raise AssertionError(f"block1 {ph}x{pw}: kernel err {d_got} > 2 x plain {d_plain} + 1e-3")
            _say("b", f"block1 batch 8 at {ph}x{pw}: err vs f32 truth kernel {d_got:.3e}, "
                      f"plain bf16 {d_plain:.3e} (bound 2x + 1e-3): pass")
        errs.append((got.float() - plain.float()).abs().max().item())
        times.append(_alternate(torch, lambda: block1_mod.block1_plain(x, *wts),
                                lambda: block1_mod.block1(x, *wts), 5))
    record["block1"] = {"max_abs_err": max(errs), "ms": sum(t[0] for t in times),
                        "plain_ms": sum(t[1] for t in times)}
    _say("b", "block1 ms per 4-scale batch of 8 (184/368/552/736): kernel "
              + "/".join(f"{t[0]:.3f}" for t in times) + ", plain "
              + "/".join(f"{t[1]:.3f}" for t in times) + f" ({card})")

    def smooth_maps(c, batch):
        out = []
        for _, _, ph, pw in sizes:
            m = rng.normal(size=(batch, ph // 8, pw // 8, c)).astype(np.float32)
            out.append(torch.from_numpy((m + np.roll(m, 1, 1) + np.roll(m, 1, 2)) / 3.0 * 0.6).to(dev))
        return out

    heat_space = ScaleSpace(smooth_maps(19, 8), geoms, (368, 368))
    got = pp_mod.pyramid_peak_scores(heat_space, 18, icfg.peak_sigma, icfg.thre1)
    want = pp_mod.pyramid_peak_scores_plain(heat_space, 18, icfg.peak_sigma, icfg.thre1)
    mask = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), mask):
        raise AssertionError(f"pyramid peaks: {int((torch.isfinite(got) != mask).sum())} mask flips")
    err = (got[mask] - want[mask]).abs().max().item()
    if not err <= 1e-5:
        raise AssertionError(f"pyramid peaks: max err {err}")
    k_ms, p_ms = _alternate(
        torch, lambda: pp_mod.pyramid_peak_scores_plain(heat_space, 18, icfg.peak_sigma, icfg.thre1),
        lambda: pp_mod.pyramid_peak_scores(heat_space, 18, icfg.peak_sigma, icfg.thre1), 5)
    record["pyramid_peaks"] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms}
    _say("b", f"pyramid peaks batch 8, 4 scales -> 368x368: {int(mask.sum())} peaks, same mask, "
              f"max err {err:.3e} (<= 1e-5): pass; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms ({card})")

    paf_space = ScaleSpace(smooth_maps(38, 8), geoms, (368, 368))
    shape = (8, 19, icfg.max_peaks, icfg.max_peaks, icfg.mid_num)
    iy = torch.from_numpy(rng.integers(0, 368, shape).astype(np.int32)).to(dev)
    ix = torch.from_numpy(rng.integers(0, 368, shape).astype(np.int32)).to(dev)
    iy[:, :, 0, 0, :4] = torch.tensor([0, 367, 0, 367], dtype=torch.int32)
    ix[:, :, 0, 0, :4] = torch.tensor([0, 0, 367, 367], dtype=torch.int32)
    chans = torch.as_tensor(topology.decode_limb_tables()[1])
    got = sample_mod.sample_avg(paf_space, iy, ix, chans)
    want = sample_mod.sample_avg_plain(paf_space, iy, ix, chans)
    err = (got - want).abs().max().item()
    if not err <= 1e-5:
        raise AssertionError(f"sample: max err {err}")
    k_ms, p_ms = _alternate(torch, lambda: sample_mod.sample_avg_plain(paf_space, iy, ix, chans),
                            lambda: sample_mod.sample_avg(paf_space, iy, ix, chans), 3)
    record["sample"] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms}
    _say("b", f"sample {tuple(shape)} points x 4 scales: max err {err:.3e} (<= 1e-5): pass; "
              f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms ({card})")

    def candidate_tables(heats, pafs):
        """The decode's inputs to assoc, computed on the card."""
        hs = ScaleSpace(heats, geoms, (368, 368))
        flats = pp_mod.pyramid_peak_scores(hs, 18, icfg.peak_sigma, icfg.thre1)
        b, c, n = flats.shape
        k = icfg.max_peaks
        tables = peaks_mod.peak_tables(flats.reshape(b * c, n), 368, k)
        pk = {key: v.reshape(b, c, k) for key, v in tables.items()}
        prior, ok, n_a, n_b = paf_mod.pair_scores(ScaleSpace(pafs, geoms, (368, 368)), pk,
                                                  icfg.mid_num, icfg.thre2, icfg.connect_min_ratio)
        return (*paf_mod.candidates(prior, ok, pk["scores"], min(512, k * k)),
                torch.minimum(n_a, n_b))

    heats1, pafs1 = planted_scene(sizes)
    planted = candidate_tables([h.to(dev) for h in heats1], [p.to(dev) for p in pafs1])
    k = icfg.max_peaks
    prior = rand((8, 19, k, k), 1.0)
    ok = torch.from_numpy(rng.random((8, 19, k, k)) < 0.02).to(dev)
    scores = torch.from_numpy(rng.random((8, 18, k)).astype(np.float32)).to(dev)
    limits = torch.from_numpy(rng.integers(1, k + 1, (8, 19)).astype(np.int32)).to(dev)
    random_tables = (*paf_mod.candidates(prior, ok, scores, min(512, k * k)), limits)
    kw = dict(k_slots=k, n_conn=min(icfg.max_connections, k),
              max_people=max(icfg.max_people, icfg.scan_people_capacity))
    for name, tables in (("planted scene", planted), ("random tables", random_tables)):
        got = assoc_mod.assoc(*tables, **kw)
        want = assoc_mod.assoc_plain(*tables, **kw)
        for key in want:
            if not torch.equal(got[key], want[key]):
                raise AssertionError(f"assoc {name}: {key} differs")
        _say("b", f"assoc on {name}: {int(want['active'].sum())} rows, bit-equal: pass")
    k_ms, p_ms = _alternate(torch, lambda: assoc_mod.assoc_plain(*random_tables, **kw),
                            lambda: assoc_mod.assoc(*random_tables, **kw), 2)
    record["assoc"] = {"max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms}
    _say("b", f"assoc batch 8, K=96, 512 candidates/limb: kernel {k_ms:.3f} ms, "
              f"plain {p_ms:.3f} ms ({card})")

    # --- c. the main path ---------------------------------------------------
    est = PoseEstimator(DEFAULT, seed=0, device="cuda")
    imgs8 = rng.integers(0, 256, (8, 368, 368, 3)).astype(np.uint8)
    imgs16 = rng.integers(0, 256, (16, 368, 368, 3)).astype(np.uint8)
    ops.reset_launch_counts()
    people8 = est.process_batch(imgs8)
    people16 = est.process_batch(imgs16, scales=(1.0,))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if len(people8) != 8 or len(people16) != 16:
        raise AssertionError("process_batch returned the wrong number of images")
    for p in (pp for batch in (people8, people16) for img in batch for pp in img):
        vals = [p["score"]] + [v for kp in p["keypoints"].values() for v in kp.values()]
        if not np.isfinite(vals).all():
            raise AssertionError("non-finite value in the people JSON")
    if min(counts.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {counts}")
    _say("c", f"process_batch 8x368x368 x 4 scales and 16x368x368 x scale 1.0: "
              f"{sum(map(len, people8))} + {sum(map(len, people16))} people; launches {counts}")
    ref = OpenPose(DEFAULT.model.num_stages, dtype=torch.float32)
    ref.load_state_dict(est.model.state_dict())
    ref.to(dev, memory_format=torch.channels_last).eval()
    x = image.normalize(torch.from_numpy(imgs8[:2]).to(dev))
    with torch.inference_mode():
        pairs = zip(("paf", "heat"), est.model(x)[-1], ref(x)[-1])
        for name, a, b in pairs:
            rel = ((a.float() - b).norm() / b.norm()).item()
            if not rel <= 0.05:
                raise AssertionError(f"bf16 network {name}: relative L2 error {rel}")
            _say("c", f"bf16 network (block1 kernel) vs its f32 version, {name}: relative "
                      f"L2 error {rel:.3e} (bound 5e-2): pass")
    del ref

    # --- d. planted scene ------------------------------------------------------
    out = {}
    for d in ("cpu", "cuda"):
        out[d] = decode_impl_batch(ScaleSpace([h.to(d) for h in heats1], geoms, (368, 368)),
                                   ScaleSpace([p.to(d) for p in pafs1], geoms, (368, 368)), icfg)
    for key, v in out["cpu"].items():
        g = out["cuda"][key].cpu()
        if v.dtype.is_floating_point:
            if not (g - v).abs().max().item() <= 1e-4:
                raise AssertionError(f"planted scene: {key} differs from the CPU decode")
        elif not torch.equal(g, v):
            raise AssertionError(f"planted scene: {key} differs from the CPU decode")
    people = to_people({key: v[0].cpu().numpy() for key, v in out["cuda"].items()})
    if len(people) != 2:
        raise AssertionError(f"planted scene decoded to {len(people)} people, not 2")
    _say("d", f"planted 2-person scene: {len(people)} people "
              f"({[p['num_parts'] for p in people]} parts), tables equal to the CPU decode: pass")

    # --- e. timings -------------------------------------------------------------
    def throughput(batch, scales, n_warm, n_timed):
        for _ in est.stream([batch] * n_warm, scales=scales):
            pass
        torch.cuda.synchronize()
        t = time.perf_counter()
        done = sum(len(r) for r in est.stream([batch] * n_timed, scales=scales))
        return done / (time.perf_counter() - t)

    torch.cuda.reset_peak_memory_stats()
    ips4 = throughput(imgs8, None, 2, 8)
    ips1 = throughput(imgs16, (1.0,), 2, 12)
    lat = {}
    for label, scales in (("4-scale", None), ("scale 1.0", (1.0,))):
        est.process_batch(imgs8[:1], scales=scales)
        samples = []
        for _ in range(15):
            t = time.perf_counter()
            est.process_batch(imgs8[:1], scales=scales)
            samples.append((time.perf_counter() - t) * 1e3)
        lat[label] = sorted(samples)[len(samples) // 2]
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    _say("e", f"4 scales, batch 8: {ips4:.2f} images/s; scale 1.0, batch 16: {ips1:.2f} images/s; "
              f"batch-1 latency p50 {lat['4-scale']:.2f} ms (4-scale), {lat['scale 1.0']:.2f} ms "
              f"(scale 1.0); peak memory {peak_gb:.2f} GiB ({card})")

    # network vs decode split of one 4-scale batch of 8 (device time)
    with torch.inference_mode():
        x0 = image.normalize(torch.from_numpy(imgs8).to(dev))
        xs = []
        for rh, rw, _, _ in sizes:
            xs.append(image.pad_right_down(image.resize_bilinear(x0, rh, rw), 8, image.PAD_NORM)[0])
        net_ms = [_ms(torch, lambda x=x: est.model(x), 3) for x in xs]
        outs = [est.model(x)[-1] for x in xs]
        hs = ScaleSpace([o[1] for o in outs], geoms, (368, 368))
        ps = ScaleSpace([o[0] for o in outs], geoms, (368, 368))
        dec_ms = _ms(torch, lambda: decode_impl_batch(hs, ps, icfg), 3)
    _say("e", "device ms per 4-scale batch of 8: network "
              + " + ".join(f"{t:.2f}" for t in net_ms)
              + f" (184/368/552/736) = {sum(net_ms):.2f}, decode {dec_ms:.2f} ({card})")

    kernels = []
    for kern in ops.KERNELS:
        kernels.append({"name": kern.name, "route": "cuda", "source": kern.source,
                        "replaces": kern.replaces, "launches": counts[kern.name],
                        **record[kern.name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
