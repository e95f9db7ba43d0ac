"""Headline benchmark of the port: 368x368 multi-person images/sec on one card.

The port's counterpart of ``tpupose/benchmark.py``. Measures the full
product path on the card: the reference's 4-scale resize/pad pyramid + CNN
forwards + the multi-person decode, batched and pipelined, warm; the
single-scale realtime variant, the on-device rates, batch-1 latency, the
train step and the training feed are reported alongside, with MFU over the
card's bf16 peak (``utils.flops``). The baseline denominators are the
reference pipeline's per-image latencies (single- and 4-scale) on this
host's CPU: the scipy decode twin (``reference_impl.decode_np``) plus the
port's network in f32 at every pyramid size, measured once and cached in
``tpupose_torch/_build/bench_baseline.json``.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...,
"card"}; the run's kernel launches (``ops.launch_counts()``) go to stderr.

Run:  python -m tpupose_torch.cli bench [--device cuda] [--baseline-cache PATH]
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from tpupose_torch.config import DEFAULT, PoseConfig

DEFAULT_BASELINE_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build",
                                      "bench_baseline.json")


@dataclasses.dataclass(frozen=True)
class Counts:
    """Batch sizes and repetitions of one run (the reference's constants)."""
    batch: int = 8                  # 4-scale pyramid: larger batches go transfer-bound
    batch_single: int = 16          # single-scale: compute is light, batching amortises
    n_batches_4scale: int = 8
    n_warmup_4scale: int = 2
    n_batches: int = 24
    n_warmup: int = 3
    device_iters_single: int = 20
    device_iters_4scale: int = 10
    latency_iters_single: int = 30
    latency_iters_4scale: int = 20
    train_batch: int = 16
    train_iters: int = 12
    feed_records: int = 96
    feed_batch: int = 16


# the keys of the JSON line, in order: the reference's, then the card's name
# and power limit, so that every figure stands beside the card it came from
LINE_KEYS = (
    "metric", "value", "unit", "vs_baseline", "headline_runs", "single_scale_ips_wall",
    "single_scale_runs", "single_scale_ips_on_device", "pyramid_ips_on_device",
    "single_scale_vs_baseline", "latency_single_scale_ms", "latency_4scale_ms",
    "train_batch", "train_step_ms", "train_samples_per_s", "train_samples_per_s_min",
    "train_samples_per_s_max", "train_mfu_pct", "feed_native_tpr_rps", "feed_hdf5_lzf_rps",
    "model_tflops_per_image_4scale", "mfu_4scale_wall_pct", "mfu_4scale_on_device_pct",
    "mfu_single_scale_wall_pct", "mfu_single_scale_on_device_pct", "note", "card",
)


def synthetic_scene(size: int = 368):
    """Deterministic 2-person scene + matching maps for the twin: image
    (size, size, 3) uint8, heat (size, size, 19) f32 with noise of 1e-3
    (seed 7), paf (size, size, 38) f32. The labels are the numpy oracle's
    (``reference_impl.gt_np.create_heatmaps_np``), as the reference's are:
    the scene is the same on every host and card."""
    import cv2

    from tpupose_torch.examples.walkthrough import scene_joints
    from tpupose_torch.reference_impl import gt_np

    labels = gt_np.create_heatmaps_np(scene_joints())
    heat = cv2.resize(labels[:, :, 38:], (size, size), interpolation=cv2.INTER_CUBIC)
    paf = cv2.resize(labels[:, :, :38], (size, size), interpolation=cv2.INTER_CUBIC)
    noise = np.random.default_rng(7).normal(size=heat.shape) * 1e-3
    image = np.clip(heat[:, :, :3] * 200 + 28, 0, 255).astype(np.uint8)
    return image, (heat + noise).astype(np.float32), paf.astype(np.float32)


def measure_baseline(cfg: PoseConfig = DEFAULT, size: int = 368) -> dict:
    """Reference-pipeline per-image latencies (seconds) on this host's CPU.

    The scipy twin decode on the scene's maps, plus the port's network in
    f32 on ``torch.device("cpu")`` at batch 1 (seeded weights, one warm
    call first) at EVERY pyramid size, so both the single-scale and the
    4-scale (the reference's product path) baselines are measurements
    rather than extrapolations."""
    from tpupose_torch.models import OpenPose
    from tpupose_torch.ops.image import scale_sizes
    from tpupose_torch.reference_impl import decode_np

    _, heat, paf = synthetic_scene(size)
    decode_np.decode_np(heat, paf, cfg.inference)
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        decode_np.decode_np(heat, paf, cfg.inference)
    decode_s = (time.perf_counter() - t0) / reps

    mcfg = cfg.model
    model = OpenPose(num_stages=mcfg.num_stages, dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last).eval()
    fwd_per_scale: dict[str, float] = {}
    with torch.inference_mode():
        for _, _, ph, pw in scale_sizes(size, size, cfg.inference.scale_search, mcfg.boxsize,
                                        mcfg.stride):
            x = torch.zeros((1, ph, pw, 3), dtype=torch.float32)
            model(x)
            t0 = time.perf_counter()
            model(x)
            fwd_per_scale[f"{ph}x{pw}"] = time.perf_counter() - t0

    _, _, ph1, pw1 = scale_sizes(size, size, (1.0,), mcfg.boxsize, mcfg.stride)[0]
    fwd_1 = fwd_per_scale[f"{ph1}x{pw1}"]
    return {
        "decode_s": decode_s,
        "fwd_s_per_scale": fwd_per_scale,
        "reference_cpu_latency_s": decode_s + fwd_1,
        "reference_cpu_latency_4scale_s": decode_s + sum(fwd_per_scale.values()),
        "note": "NumPy/SciPy twin decode + the port's network in f32 on this host's CPU "
                f"(torch, {torch.get_num_threads()} threads), per image",
    }


def get_baseline(cache_path: str, cfg: PoseConfig = DEFAULT, size: int = 368) -> dict:
    """The cached baseline, or a new measurement written to ``cache_path``."""
    if os.path.exists(cache_path):
        with open(cache_path) as f:
            data = json.load(f)
        if "reference_cpu_latency_4scale_s" in data:
            return data
    print(f"bench: measuring the reference pipeline's latency on this host's CPU into "
          f"{cache_path}", file=sys.stderr, flush=True)
    data = measure_baseline(cfg, size)
    os.makedirs(os.path.dirname(os.path.abspath(cache_path)), exist_ok=True)
    with open(cache_path + ".tmp", "w") as f:
        json.dump(data, f, indent=2)
    os.replace(cache_path + ".tmp", cache_path)
    return data


def _measure_stream(est, batch, scales, n_warmup, n_batches) -> float:
    """Sustained pipelined throughput (images/sec) for one scale set."""
    for _ in est.stream([batch] * n_warmup, scales=scales):
        pass
    t0 = time.perf_counter()
    n_done = 0
    for people in est.stream([batch] * n_batches, scales=scales):
        n_done += len(people)
    return n_done / (time.perf_counter() - t0)


def _chained_s(est, images: np.ndarray, scales, iters: int) -> float:
    """Seconds per ``program`` call on images uploaded once: one warm call,
    ``iters`` chained calls, ONE final sync on a scalar of the last tables."""
    x, _ = est._upload(images, None)
    with torch.inference_mode():
        est.program(None, x, None, scales)["cnt"].sum().item()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = est.program(None, x, None, scales)
        out["cnt"].sum().item()
    return (time.perf_counter() - t0) / iters


def _measure_on_device(est, batch, scales, iters=20) -> float:
    """On-device throughput (images/sec): the batch resident on the device,
    ``iters`` chained ``program`` calls, one final sync — no per-batch
    upload or download rides the measurement. Unlike the reference's
    jitted program, each call of the port's reads the decode's
    peak-overflow switch on the host once (``decode.peaks.peak_tables``),
    so the host waits for every batch's peak scores before it enqueues the
    rest of that batch's decode: the rate includes that wait."""
    return batch.shape[0] / _chained_s(est, batch, scales, iters)


def _measure_latency(est, image, scales, iters=30) -> dict:
    """Per-image latency (batch 1): wall p50/p99 (upload -> people on the
    host: ``est._run`` + ``PoseEstimator._finish``) and on-device mean
    (chained ``program`` calls, one sync — per-program execution time)."""
    img = image[None]
    est._finish(1, est._run(img, scales, None))           # warm
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        est._finish(1, est._run(img, scales, None))
        samples.append((time.perf_counter() - t0) * 1e3)
    samples.sort()
    dev_mean = _chained_s(est, img, scales, iters) * 1e3
    return {
        "wall_p50_ms": round(samples[len(samples) // 2], 2),
        "wall_p99_ms": round(samples[min(len(samples) - 1, int(len(samples) * 0.99))], 2),
        "device_mean_ms": round(dev_mean, 2),
    }


def _measure_train(cfg: PoseConfig, device, size: int = 368, batch_size: int = 16,
                   iters: int = 12) -> dict:
    """Train-step line: the full step — on-device augmentation, the gt
    kernel's labels, the forward and backward of every stage and the
    MultiSGD update — at batch ``batch_size`` on one synthetic batch
    uploaded once, each step with a ``torch.Generator`` of its own. The
    median of 3 rounds of ``iters`` steps, each round synced by reading its
    last total loss."""
    from tpupose_torch.data.pipeline import synthetic_batches
    from tpupose_torch.models import OpenPose
    from tpupose_torch.models.openpose import DTYPES
    from tpupose_torch.training import create_state, make_train_step
    from tpupose_torch.training.loop import step_generator
    from tpupose_torch.utils import flops as flops_lib

    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=batch_size))
    model = OpenPose(num_stages=cfg.model.num_stages, dtype=DTYPES[cfg.model.compute_dtype])
    model.reset_parameters(torch.Generator().manual_seed(0))
    state, tx = create_state(cfg, model.state_dict(), device)
    step = make_train_step(cfg, model, tx, loss_denom=batch_size)
    tree = state.tree()
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in next(iter(synthetic_batches(cfg, size, size))).items()}
    tree, losses = step(tree, step_generator(1, 0), batch)
    losses["total"].item()
    # median of 3 measurement rounds: one round cannot tell a regression
    # from the host's variance
    rounds = []
    for r in range(3):
        t0 = time.perf_counter()
        for i in range(iters):
            tree, losses = step(tree, step_generator(1, 1 + r * iters + i), batch)
        losses["total"].item()
        rounds.append((time.perf_counter() - t0) / iters)
    rounds.sort()
    dt = rounds[len(rounds) // 2]
    step_flops = 3 * flops_lib.forward_flops(cfg.model.boxsize, cfg.model.boxsize,
                                             cfg.model.num_stages)
    return {
        "train_batch": batch_size,
        "train_step_ms": round(dt * 1e3, 1),
        "train_samples_per_s": round(batch_size / dt, 1),
        "train_samples_per_s_min": round(batch_size / rounds[-1], 1),
        "train_samples_per_s_max": round(batch_size / rounds[0], 1),
        "train_mfu_pct": round(
            100.0 * batch_size / dt * step_flops / flops_lib.PEAK_BF16_FLOPS, 1
        ),
    }


def _feed_files(directory: str, cfg: PoseConfig, size: int, n_records: int):
    """The feed's seeded size x size records, in the reference's order of
    draws: a pre-padded ``.tpr`` (``hdf5.pad_sample`` of each record as the
    HDF5 reader returns it, written by ``tpr.TprWriter``) and, where h5py
    imports, the same records as an lzf HDF5 file. Returns (tpr path, HDF5
    path or None)."""
    from tpupose_torch.data import hdf5 as hdf5_io, tpr

    try:
        import h5py  # noqa: F401
    except ImportError:
        h5 = None
    else:
        h5 = os.path.join(directory, "feed.h5")
    rng = np.random.default_rng(0)
    records = []
    for _ in range(n_records):
        img = rng.integers(0, 255, (size, size, 3), np.uint8)
        joints = rng.uniform(10, size - 18, (2, 18, 3)).astype(np.float32)
        joints[..., 2] = 1.0
        records.append((img, joints))
    center, scale = np.float32([size / 2, size / 2]), np.float32(0.8)
    if h5 is not None:
        with hdf5_io.SampleWriter(h5, compression="lzf") as w:
            for img, joints in records:
                w.add(img, np.ones((size, size), np.float32), joints, center, scale)
    tp = os.path.join(directory, "feed.tpr")
    max_persons = cfg.augment.max_persons
    with tpr.TprWriter(tp) as w:
        for img, joints in records:
            s = {"image": img, "mask": np.ones((size, size), np.uint8), "joints": joints,
                 "center": center, "scale_provided": scale,
                 "areas": hdf5_io.estimate_areas(joints)}
            p = hdf5_io.pad_sample(s, size, size, max_persons)
            meta = tpr._meta_from_sample(p)
            meta["prepadded"] = {"max_persons": max_persons}
            w.add(p["image"], np.round(p["mask"] * 255).astype(np.uint8), meta)
    return tp, h5


def _measure_feed(cfg: PoseConfig, size: int = 368, n_records: int = 96,
                  batch: int = 16) -> dict:
    """Host-side training-feed rates, records/s on size^2 records: the
    native ``.tpr`` feed (threaded C++ inflate) and, where h5py imports, the
    HDF5-lzf thread feed (null elsewhere). The feed must out-run
    train_samples_per_s or training goes input-bound."""
    from tpupose_torch.data import pipeline

    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=batch))

    def rate(feed, n_batches):
        it = iter(feed)
        next(it)
        t0 = time.perf_counter()
        for _ in range(n_batches):
            next(it)
        return n_batches * batch / (time.perf_counter() - t0)

    tmp = tempfile.mkdtemp()
    try:
        tp, h5 = _feed_files(tmp, cfg, size, n_records)
        n_b = 2 * n_records // batch
        feed = pipeline.tpr_batches(tp, cfg, size, size, epochs=None)
        try:
            tpr_rps = rate(feed, n_b)
        finally:
            feed.close()
        h5_rps = None
        if h5 is not None:
            h5_rps = round(rate(pipeline.hdf5_batches(h5, cfg, size, size, epochs=None), n_b), 1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"feed_native_tpr_rps": round(tpr_rps, 1), "feed_hdf5_lzf_rps": h5_rps}


def _card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them; "cpu" on the CPU."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def main(baseline_cache: str | None = None, device="cuda", cfg: PoseConfig = DEFAULT,
         size: int = 368, counts: Counts = Counts()) -> None:
    """Run the benchmark on ``device`` (a card unless the caller asks for
    the CPU) and print its JSON line. ``cfg``, ``size`` and ``counts`` are
    the reference's unless a caller narrows them (the CPU tests do)."""
    from tpupose_torch import ops
    from tpupose_torch.infer import PoseEstimator
    from tpupose_torch.utils import flops as flops_lib

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench(device='cuda'): no CUDA device is available")
    card = _card(device)
    ops.reset_launch_counts()
    c = counts
    image, _, _ = synthetic_scene(size)
    est = PoseEstimator(cfg, device=device)
    batch = np.stack([image] * c.batch)

    # headline: the reference's product path — the full pyramid, batched +
    # pipelined; median of 3 runs with min/max, so that a difference between
    # two runs can be read against the spread within one
    runs4 = sorted(_measure_stream(est, batch, None, c.n_warmup_4scale if r == 0 else 0,
                                   c.n_batches_4scale) for r in range(3))
    ips4 = runs4[1]
    batch1 = np.stack([image] * c.batch_single)
    runs1 = sorted(_measure_stream(est, batch1, (1.0,), c.n_warmup if r == 0 else 0,
                                   c.n_batches) for r in range(3))
    ips1 = runs1[1]
    ips1_dev = _measure_on_device(est, batch1, (1.0,), c.device_iters_single)
    ips4_dev = _measure_on_device(est, batch, None, c.device_iters_4scale)
    lat1 = _measure_latency(est, image, (1.0,), c.latency_iters_single)
    lat4 = _measure_latency(est, image, None, c.latency_iters_4scale)
    train = _measure_train(cfg, device, size, c.train_batch, c.train_iters)
    feed = _measure_feed(cfg, size, c.feed_records, c.feed_batch)
    launches = ops.launch_counts()

    cache = baseline_cache or DEFAULT_BASELINE_CACHE
    baseline = get_baseline(cache, cfg, size)
    base4_ips = 1.0 / baseline["reference_cpu_latency_4scale_s"]
    base1_ips = 1.0 / baseline["reference_cpu_latency_s"]

    mcfg, icfg = cfg.model, cfg.inference
    fl4 = flops_lib.pyramid_flops(size, size, icfg.scale_search, mcfg.boxsize, mcfg.stride,
                                  mcfg.num_stages)
    fl1 = flops_lib.pyramid_flops(size, size, (1.0,), mcfg.boxsize, mcfg.stride,
                                  mcfg.num_stages)
    peak = flops_lib.PEAK_BF16_FLOPS
    note = ("wall numbers are host-clock rates of this process (upload to people on the "
            "host); *_wall_pct MFU uses the wall rate, *_on_device_pct the chained-program "
            "rate, whose every call reads the decode's peak-overflow switch on the host; MFU "
            "is model-FLOPs-based (decode/resize not counted) over the card's dense bf16 peak "
            f"of {peak:.4g} FLOP/s; throughput fields are medians of 3 runs with min/max "
            "alongside; the baselines are the reference pipeline's per-image latencies on "
            f"this host's CPU ({baseline['note']}), cached in {cache}")
    if feed["feed_hdf5_lzf_rps"] is None:
        note += "; feed_hdf5_lzf_rps is null: h5py is not installed on this host"
    print(f"bench: kernel launches {json.dumps(launches)}", file=sys.stderr, flush=True)
    print(json.dumps({
        "metric": f"{size}x{size} multi-person images/sec/chip "
                  f"({icfg.num_scales}-scale pyramid fwd+decode, batched+pipelined)",
        "value": round(ips4, 3),
        "unit": "images/sec",
        "vs_baseline": round(ips4 / base4_ips, 2),
        "headline_runs": {"median": round(runs4[1], 3), "min": round(runs4[0], 3),
                          "max": round(runs4[2], 3)},
        "single_scale_ips_wall": round(ips1, 3),
        "single_scale_runs": {"median": round(runs1[1], 3), "min": round(runs1[0], 3),
                              "max": round(runs1[2], 3)},
        "single_scale_ips_on_device": round(ips1_dev, 3),
        "pyramid_ips_on_device": round(ips4_dev, 3),
        "single_scale_vs_baseline": round(ips1 / base1_ips, 2),
        "latency_single_scale_ms": lat1,
        "latency_4scale_ms": lat4,
        **train,
        **feed,
        "model_tflops_per_image_4scale": round(fl4 / 1e12, 3),
        "mfu_4scale_wall_pct": round(100.0 * ips4 * fl4 / peak, 2),
        "mfu_4scale_on_device_pct": round(100.0 * ips4_dev * fl4 / peak, 2),
        "mfu_single_scale_wall_pct": round(100.0 * ips1 * fl1 / peak, 2),
        "mfu_single_scale_on_device_pct": round(100.0 * ips1_dev * fl1 / peak, 2),
        "note": note,
        "card": card,
    }), flush=True)
