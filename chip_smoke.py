#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpupose_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

With ``--parent DIR`` (a checkout of an earlier commit of this repository)
the redesigned kernels of that checkout, block1, sample, pyramid_peaks,
peaks, assoc and gt, are timed beside this checkout's on the same inputs,
in turns (parent, change, change, parent; the parent's in a process of
its own), and their times enter the kernels' record as ``prev_ms``. The
outputs of pyramid_peaks, peaks, assoc (on random and on crowded tables)
and gt on the same saved inputs must equal the parent's bit for bit.
assoc and gt, redesigned in this checkout, must be faster than the
parent's; pyramid_peaks and peaks, where their source differs from the
parent's, at most 5 % slower; block1 and sample are shown.

Phases, one printed line each (a phase that fails raises, and the script
exits non-zero):

  a. the card (nvidia-smi name and power limit) and the kernels' build
     from tpupose_torch/csrc with nvcc;
  b. each CUDA kernel against its plain PyTorch version at main-path
     shapes: block1 at 368x368 and 736x736, batch 8 (error against an f32
     truth at most 2x the plain bf16 error + 1e-3); pyramid peaks at the
     4-scale 368x368 geometry (same peak mask, values within 1e-5);
     sample at the (8, 19, 96, 96, 10) point shape (within 1e-5); assoc
     bit-equal on a planted scene's candidates, on random tables and on
     the tables of 8 crowded 720x1280 frames (testing.crowded_scene, 32
     people each; accepted connections per limb and phase-2 steps shown,
     the chain floor beside the bound); pyramid peaks also at the portrait
     656x496 bucket and a 720x1280 frame (4 scales); peaks also at sigma
     4.5 and 6.0 (the generic-radius path, bit-equal); gt
     at the training shape (10, 24, 18, 3) joints on the 46x46 grid (the
     same heat > 0 and band masks, values within 1e-6); peaks on smooth
     random full-res maps at (8, 368, 368, 19) and (2, 496, 656, 19)
     (bit-equal to its plain version; the same peak coordinates as the
     scipy twin on one image, values within 1e-5). Beside each
     kernel's time: its bound on this card (the larger of bytes moved
     over 3.35 TB/s and operations over the peak rate of their type,
     counted from this run's inputs);
  c. the inference path: a full-width estimator (VGG19 + 6 stages, boxsize
     368, bf16, seeded random weights) runs process_batch on 368x368
     uint8 images, batch 8 over the 4-scale pyramid and batch 16 at scale
     1.0; block1, pyramid_peaks, sample and assoc must each be launched
     in that run and gt and peaks never, and the bf16 network must agree
     with its f32 version (relative L2 <= 5e-2); one 720x1280 frame
     through process_batch at the 4 scales.
     Then the full-res path: a second full-width estimator with
     paf_readout="fullres" runs process_batch on the same batch of 8 over
     the 4 scales: peaks launched once, block1 4 times, assoc once,
     pyramid_peaks and sample never; maps() of one image has shapes
     (368, 368, 19) and (368, 368, 38) and agrees with maps_batch of the
     batch, which is what process_batch decodes (relative L2 <= 5e-2: the
     bf16 network at batch 1 and batch 8 may take different convolution
     routines);
  d. a planted two-person scene decodes to 2 people on the card, with
     tables equal (integers) and within 1e-4 (floats) to the plain decode
     on the CPU; materialised with upsample_to, the same scene decodes
     through decode_maps to the same 2 people, held the same way against
     the full-res decode on the CPU, the scale-space decode, and the
     decode of the full-res heat map with the scale-space PAFs;
     BucketedRunner.process_many over three images of different shapes
     (the full-res estimator, its two output convolutions scaled so that
     the random network emits peaks) returns, in input order and original
     coordinates, what process_batch gives for each canvas alone; so
     does a BucketedRunner over the scale-space estimator on a 640x480
     portrait image (the 656x496 bucket);
  e. the crowded scenes end to end: the scale-space decode's device ms and
     the assoc kernel's share of it; the people decoded per frame must
     equal the plain decode's on the CPU. Timings: images/s (4 scales,
     batch 8; scale 1.0, batch 16), batch-1
     latency, a network/decode split, per-kernel ms against the plain
     version; sample at the main path's own point tables (the points
     pair_scores builds from the seeded network's peaks, nearly all of them
     empty slots that coincide) beside its time on random points; the full-res path beside the scale-space one (images/s in
     turns, upsample + average and full-res decode device ms, the decode
     by part, maps() ms, peak memory); train steps/s at batch 10, taken
     after both estimators are released and the allocator's cache is
     emptied (a first window of 8 steps is shown apart, then the median
     of five more windows, all five shown) with a device split (augment,
     GT kernel, forward + backward, update) and peak memory; every device
     time is taken with the calls queued behind a long matrix product, so
     that it holds no host enqueue time;
  f. the training path at full width: train() takes 5 steps of the
     default configuration as it stands (batch 10, 24 persons, bf16,
     base_lr 4e-5) on the card: 13 finite losses per step, the gt kernel
     launched once per step and block1 never; 5 more steps with
     clip_norm 5 leave a checkpoint, and a trainer restored from it takes
     the same next step, bit for bit, as the uninterrupted one; with a fixed augmentation the total loss over 5
     steps is shown for the default in bf16, the default in f32 and
     clip_norm 5 in bf16, and must fall in one of them (from a random
     init the default rate is past its stable value, see PERF.md); the f32
     run is repeated with torch.optim.SGD and a loss written out in this
     script, and must take the same steps; 3
     steps with the VGG base frozen leave every vgg tensor bit-identical
     and move stage 2;
  g. one small train step (2 stages, boxsize 64, batch 2, 3 persons) on
     the card against the CPU: per-head losses within 1e-4 relative in
     f32; with the network's arithmetic in f64 (no ReLU within rounding of
     zero decides differently) the updated f32 parameters within 1e-5;
  h. the serving path (run after phase d, on its scale-space estimator):
     the estimator's weights saved with torch.save under the original
     release's Caffe layer names (OIHW, no h5py) and loaded by
     PoseEstimator(weights_path=): pretrained, and on a 4-scale batch of 8
     its tables bit-equal to those of the estimator built from the same
     params; warmup_estimator over the bucket ladder at max batch 8 (its
     seconds shown); serve(max_batch=8, batch_window_ms=5, the ladder)
     answers 32 PNG requests (encoded with zlib, rows filtered as libpng
     chooses by default, Paeth and Average among them; 368x368 images,
     640x480 portraits for the 656x496 bucket and 720x1280 frames, sizes
     H x W) from 8 client threads, the server decoding them with cv2 as
     the reference does, each response equal to the
     people a BucketedRunner returns for the images of the device batch the
     server ran it in (integers equal, floats within 1e-4; what one image
     decodes to depends on its device batch, through the batch size and the
     batch-global peak-overflow switch), every shape decoding people;
     /healthz pretrained, /metrics 32 requests, 0 errors and a mean device
     batch above 1; a 1-byte body 400, an unknown path 404, a body over
     32 MiB 413; block1, pyramid_peaks, sample and assoc launched during the
     requests, gt and peaks never; requests/s and latency p50/p99; the
     batch dependence shown on one image (copies of it at device batch
     1/2/4/8 against batch 1: block 1's output, a cuDNN conv's, the last
     stage's maps and the people, in bf16 and with the same weights in
     f32); host times to decode a body; a serial server (max batch 1, no
     buckets) answers one 368x368 request with process()'s people. (Phase d's planted scene is a set of network
     outputs, not an image: no image drives the seeded network to it, so
     the requests are seeded random images and the heads are scaled as in
     phase d so that they decode people.)

The phase e, f and h lines are printed once more at the end; the last three
lines are the kernels' JSON record, the card's name and
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

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
F32_FLOPS = 67e12             # outside the tensor cores
BF16_FLOPS = 989e12           # tensor cores, dense
ROOT = os.path.dirname(os.path.abspath(__file__))


_SAID: list[str] = []


def _say(phase: str, msg: str) -> None:
    _SAID.append(f"[{phase}] {msg}")
    print(_SAID[-1], flush=True)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _sm_clock_mhz() -> tuple[float, float]:
    """(current, maximum) SM clock of card 0 in MHz, as nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    now, top = (float(v) for v in out.split(","))
    return now, top


def _ms(torch, fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls (CUDA events). The calls
    are queued behind a long matrix product, so the two events bracket what
    the device runs and not the host's enqueue cost, which for the shortest
    kernels is the longer of the two."""
    fn()
    ballast = torch.empty((8192, 8192), device="cuda").normal_()    # freed on return
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.mm(ballast, ballast)
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


def _bound(n_bytes: float, ops: float, rate: float) -> dict:
    """The least ms this card could take: bytes at the memory rate or
    operations at ``rate``, whichever is longer."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _redesigned_times(torch, np, data_path: str) -> dict:
    """Device ms of the redesigned kernels of whichever tpupose_torch is first
    on the path: block1 (each pyramid geometry at batch 8, fed as phase b
    feeds it), sample (seeded random points on seeded maps, and the main
    path's point tables), pyramid_peaks (batch 8, 4 scales to 368x368),
    peaks ((8, 368, 368, 19), sigma 3), assoc (phase b's random tables and
    the crowded scenes' tables) and gt (phase b's batch), the last five on
    the inputs saved under ``data_path``. Their outputs are saved beside
    them, the file's path under "outputs", for a bit-for-bit comparison.
    Inputs depend on nothing but the seeds."""
    from tpupose_torch import topology
    from tpupose_torch.config import DEFAULT
    from tpupose_torch.decode.scalespace import ScaleSpace
    from tpupose_torch.ops import assoc as assoc_mod
    from tpupose_torch.ops import block1 as block1_mod
    from tpupose_torch.ops import gt as gt_mod
    from tpupose_torch.ops import image
    from tpupose_torch.ops import peaks as peaks_mod
    from tpupose_torch.ops import pyramid_peaks as pp_mod
    from tpupose_torch.ops import sample as sample_mod

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    sizes = image.scale_sizes(368, 368, (0.5, 1.0, 1.5, 2.0), 368, 8)
    geoms = [s[:2] for s in sizes]
    sigma, thre1 = DEFAULT.inference.peak_sigma, DEFAULT.inference.thre1

    def rand(shape, scale):
        return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32)).to(dev)

    wts = (rand((3, 3, 3, 64), 0.2), rand((64,), 0.1), rand((3, 3, 64, 64), 0.05),
           rand((64,), 0.1))
    out = {"block1": []}
    for _, _, ph, pw in sizes:
        x = torch.from_numpy(rng.uniform(-0.5, 0.5, (8, ph, pw, 3)).astype(np.float32)).to(dev)
        out["block1"].append(_ms(torch, lambda: block1_mod.block1(x, *wts), 5))
    chans = torch.as_tensor(topology.decode_limb_tables()[1])
    maps = [rand((8, ph // 8, pw // 8, 38), 0.3) for _, _, ph, pw in sizes]
    space = ScaleSpace(maps, geoms, (368, 368))
    iy = torch.from_numpy(rng.integers(0, 368, (8, 19, 96, 96, 10)).astype(np.int32)).to(dev)
    ix = torch.from_numpy(rng.integers(0, 368, (8, 19, 96, 96, 10)).astype(np.int32)).to(dev)
    out["sample_random"] = _ms(torch, lambda: sample_mod.sample_avg(space, iy, ix, chans), 3)
    data = torch.load(data_path)
    space = ScaleSpace([m.to(dev) for m in data["maps"]], geoms, (368, 368))
    iy, ix = data["iy"].to(dev), data["ix"].to(dev)
    out["sample_main_path"] = _ms(torch, lambda: sample_mod.sample_avg(space, iy, ix, chans), 3)
    heat = ScaleSpace([m.to(dev) for m in data["heat"]], geoms, (368, 368))
    field = data["field"].to(dev)
    tables = {name: [t.to(dev) for t in data[name]] for name in ("assoc_random", "assoc_crowded")}
    gj, gm = (t.to(dev) for t in data["gt"])
    calls = {
        "pyramid_peaks": lambda: pp_mod.pyramid_peak_scores(heat, 18, sigma, thre1),
        "peaks": lambda: peaks_mod.peak_scores(field, 18, sigma, thre1),
        "assoc_random": lambda: assoc_mod.assoc(*tables["assoc_random"], **data["assoc_kw"]),
        "assoc_crowded": lambda: assoc_mod.assoc(*tables["assoc_crowded"], **data["assoc_kw"]),
        "gt": lambda: gt_mod.create_labels(gj, gm, **data["gt_kw"]),
    }
    outputs = {}
    for name, call in calls.items():
        got = call()
        outputs[name] = ({k: v.cpu() for k, v in got.items()} if isinstance(got, dict)
                         else [v.cpu() for v in got] if isinstance(got, tuple) else got.cpu())
        out[name] = _ms(torch, call, 20 if name.startswith(("assoc", "gt")) else 5)
    out["outputs"] = f"{data_path}.{os.getpid()}.outputs.pt"
    torch.save(outputs, out["outputs"])
    return out


def _bits_differ(torch, a, b) -> int:
    """Elements of two outputs (a tensor, or a list or dict of them) whose
    bits differ."""
    if isinstance(a, dict):
        return sum(_bits_differ(torch, a[k], b[k]) for k in a)
    if isinstance(a, list):
        return sum(_bits_differ(torch, x, y) for x, y in zip(a, b))
    if a.dtype == torch.bool:
        return int((a != b).sum())
    width = {1: torch.uint8, 4: torch.int32}[a.element_size()]
    return int((a.view(width) != b.view(width)).sum())


def _parent_times(parent: str, data_path: str) -> dict:
    """``_redesigned_times`` of the checkout under ``parent``, in a process
    of its own (two versions of one package do not share a process)."""
    done = subprocess.run([sys.executable, os.path.abspath(__file__), "--kernel-times-of",
                           os.path.abspath(parent), data_path],
                          capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        raise RuntimeError(f"timing the kernels of {parent} failed:\n{done.stderr[-2000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def _post(server, body: bytes, path: str = "/pose", timeout: float = 300.0):
    """(status, JSON body) of one POST to the server."""
    import http.client

    conn = http.client.HTTPConnection(*server.server_address[:2], timeout=timeout)
    try:
        conn.request("POST", path, body=body)
        reply = conn.getresponse()
        return reply.status, json.loads(reply.read())
    finally:
        conn.close()


def _get(server, path: str):
    import http.client

    conn = http.client.HTTPConnection(*server.server_address[:2], timeout=60)
    try:
        conn.request("GET", path)
        reply = conn.getresponse()
        return reply.status, json.loads(reply.read())
    finally:
        conn.close()


def _same_people(got: list, want: list, what: str) -> None:
    """People equal: counts, parts and coordinates exactly, scores within 1e-4."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} people, the reference {len(want)}")
    for a, b in zip(got, want):
        if a["num_parts"] != b["num_parts"] or sorted(a["keypoints"]) != sorted(b["keypoints"]):
            raise AssertionError(f"{what}: a person's parts differ from the reference")
        if abs(a["score"] - b["score"]) > 1e-4:
            raise AssertionError(f"{what}: a person's score differs from the reference")
        for name, kp in a["keypoints"].items():
            o = b["keypoints"][name]
            if (kp["x"], kp["y"]) != (o["x"], o["y"]) or abs(kp["score"] - o["score"]) > 1e-4:
                raise AssertionError(f"{what}: keypoint {name} differs from the reference")


def _row_filter_counts(np, body: bytes) -> list:
    """How many rows of an 8-bit RGB PNG use each filter type 0..4."""
    import struct
    import zlib

    w, h = struct.unpack(">II", body[16:24])
    pos, idat = 8, []
    while pos < len(body):
        length, kind = struct.unpack(">I4s", body[pos:pos + 8])
        if kind == b"IDAT":
            idat.append(body[pos + 8:pos + 8 + length])
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return np.bincount(raw[::3 * w + 1][:h], minlength=5).tolist()


def _batch_witness(torch, np, est, image) -> dict:
    """Copy 0 of ``image`` (a canvas of a bucket) in device batches of 1, 2,
    4 and 8 copies, against batch 1: the elements of block 1's output
    (conv2_1's input) that differ, the largest difference of conv2_1's
    output (a cuDNN conv) and of the last stage's heat and PAF maps over
    the 4 scales (beside the maps' largest magnitude), and the people a
    BucketedRunner of that batch size decodes."""
    from tpupose_torch.buckets import BucketedRunner

    seen = []
    hook = est.model.vgg.conv2_1.register_forward_hook(
        lambda module, args, out: seen.append((args[0][:1].float(), out[:1].float())))
    out, ref = {}, None
    try:
        for n in (1, 2, 4, 8):
            seen.clear()
            with torch.inference_mode():
                _, heats, pafs = est._low_res(np.repeat(image[None], n, axis=0), None)
            now = (list(seen), [t[:1].float() for t in heats], [t[:1].float() for t in pafs])
            people = len(BucketedRunner(est, batch_size=n).process_many([image])[0])
            if ref is None:
                ref = now
            gap = lambda xs, ys: max(float((x - y).abs().max()) for x, y in zip(xs, ys))  # noqa: E731
            out[n] = {
                "people": people,
                "block1_differ": sum(int((a != b).sum()) for (a, _), (b, _) in zip(now[0], ref[0])),
                "conv2_1": gap([o for _, o in now[0]], [o for _, o in ref[0]]),
                "heat": gap(now[1], ref[1]), "paf": gap(now[2], ref[2]),
            }
        out["magnitude"] = {"conv2_1": max(float(o.abs().max()) for _, o in ref[0]),
                            "heat": max(float(t.abs().max()) for t in ref[1]),
                            "paf": max(float(t.abs().max()) for t in ref[2])}
    finally:
        hook.remove()
    return out


def _serving_phase(torch, np, est, card: str, rng) -> dict:
    """Phase h: the serving path on the card. ``est`` is the seeded
    full-width scale-space estimator (its output convolutions scaled as
    phase d scales them). Returns the launches during the requests."""
    import concurrent.futures
    import dataclasses
    import hashlib
    import tempfile

    import cv2

    from tpupose_torch import ops
    from tpupose_torch.buckets import DEFAULT_BUCKETS, BucketedRunner, choose_bucket, to_bucket
    from tpupose_torch.config import DEFAULT
    from tpupose_torch.infer import PoseEstimator
    from tpupose_torch.models import weights as weights_lib
    from tpupose_torch.serve import _decode_png, decode_image, serve, warmup_estimator
    from tpupose_torch.testing import png_bytes

    # 1. a torch weight file of the original release's naming, written without
    # h5py: model0.<caffe layer>.weight (OIHW) / .bias
    params = weights_lib.to_flax(est.model.state_dict())
    state = {}
    for scope, layers in params.items():
        for layer, leaves in layers.items():
            name = weights_lib._flax_name_to_keras(scope, layer)
            state[f"model0.{name}.weight"] = torch.from_numpy(
                np.ascontiguousarray(leaves["kernel"].transpose(3, 2, 0, 1)))
            state[f"model0.{name}.bias"] = torch.from_numpy(leaves["bias"])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pose_model.pth")
        torch.save(state, path)
        served = PoseEstimator(DEFAULT, weights_path=path, device="cuda")
    from_params = PoseEstimator(DEFAULT, params=params, device="cuda")
    if served.pretrained is not True:
        raise AssertionError("PoseEstimator(weights_path=.pth) is not pretrained")
    imgs8 = rng.integers(0, 256, (8, 368, 368, 3)).astype(np.uint8)
    n8, got = served.process_batch_async(imgs8)
    want = from_params.process_batch_async(imgs8)[1]
    for key in want:
        if not torch.equal(got[key], want[key]):
            raise AssertionError(f"the .pth estimator's {key} differs from the params-built one's")
    people_pth, people_params = served._finish(n8, got), from_params._finish(n8, want)
    if people_pth != people_params or not sum(map(len, people_pth)):
        raise AssertionError("the .pth estimator's people differ from the params-built one's")
    _say("h", f"weights written as a torch .pth ({len(state)} tensors, Caffe layer names, OIHW) "
              f"and loaded with PoseEstimator(weights_path=): pretrained, 4-scale batch of 8 "
              f"({sum(map(len, people_pth))} people) bit-equal to the params-built estimator "
              "in every table: pass")
    del from_params, got, want, state, params

    # 2. warm-up over the bucket ladder, then the micro-batching server. Every
    # device batch the server runs is recorded (its canvases in order): what
    # the decode finds in one image depends on its batch, through the batch
    # size (cuDNN takes other routines for the bf16 convolutions) and through
    # the peak tables' overflow switch, which is batch-global as in the
    # reference. So each recorded batch's images are run again through a
    # BucketedRunner of that batch size, which builds the same device batch,
    # and every response must equal the runner's people for its image.
    t0 = time.perf_counter()
    n_geoms = warmup_estimator(served, DEFAULT_BUCKETS, max_batch=8)
    warm_s = time.perf_counter() - t0

    class Recorded:
        pretrained = served.pretrained

        def __init__(self):
            self.batches = []
            self.busy_s = 0.0       # host clock inside process_batch

        def process_batch(self, images, scales=None, valid_hw=None):
            self.batches.append([hashlib.sha1(c.tobytes()).hexdigest() for c in images])
            t = time.perf_counter()
            people = served.process_batch(images, scales=scales, valid_hw=valid_hw)
            self.busy_s += time.perf_counter() - t
            return people

    recorded = Recorded()
    shapes = ((368, 368, 3), (640, 480, 3), (720, 1280, 3))      # H x W x 3
    images = [rng.integers(0, 256, shapes[i % 3]).astype(np.uint8) for i in range(32)]
    # PNGs as libpng writes them by default: each row's filter chosen by the
    # least sum of its signed bytes (held to cv2.imencode's choice by a CPU test)
    bodies = [png_bytes(img, "adaptive", level=6) for img in images]
    row_filters = np.sum([_row_filter_counts(np, body) for body in bodies], axis=0).tolist()
    server = serve(recorded, port=0, max_batch=8, batch_window_ms=5, buckets=DEFAULT_BUCKETS)
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            replies = list(pool.map(lambda body: _post(server, body), bodies))
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        deadline = time.time() + 30
        while True:     # a request is counted after its reply is written
            metrics = _get(server, "/metrics")[1]
            if metrics["requests"] >= 32 or time.time() > deadline:
                break
            time.sleep(0.01)
        health = _get(server, "/healthz")
        bad = {"1-byte body": _post(server, b"x")[0], "unknown path": _post(server, b"x", "/x")[0]}
        import http.client

        conn = http.client.HTTPConnection(*server.server_address[:2], timeout=60)
        conn.putrequest("POST", "/pose")
        conn.putheader("Content-Length", str((32 << 20) + 1))
        conn.endheaders()
        bad["body over 32 MiB"] = conn.getresponse().status
        conn.close()
    finally:
        server.shutdown()
        server.batcher.close()
    if [status for status, _ in replies] != [200] * 32:
        raise AssertionError(f"request statuses {[status for status, _ in replies]}")
    request_of = {}
    for i, img in enumerate(images):
        canvas = to_bucket(img, *choose_bucket(img.shape[0], img.shape[1], DEFAULT_BUCKETS))[0]
        request_of[hashlib.sha1(canvas.tobytes()).hexdigest()] = i
    by_shape, answered = {}, set()
    for digests in recorded.batches:
        # the batch's requests in order; the batcher pads with copies of the last
        order = [request_of[d] for i, d in enumerate(digests) if d not in digests[:i]]
        want = BucketedRunner(served, batch_size=len(digests)).process_many(
            [images[i] for i in order])
        for i, people in zip(order, want):
            shape = images[i].shape
            _same_people(replies[i][1]["people"], people,
                         f"request {i}, a {shape[0]}x{shape[1]} image")
            by_shape.setdefault(shape[:2], []).append((len(digests), len(people)))
            answered.add(i)
    if answered != set(range(32)):
        raise AssertionError(f"requests in no recorded batch: {sorted(set(range(32)) - answered)}")
    if min(sum(k for _, k in v) for v in by_shape.values()) < 1:
        raise AssertionError(f"a request shape decoded no person: {by_shape}")
    if health != (200, {"status": "ok", "pretrained": True}):
        raise AssertionError(f"/healthz: {health}")
    if not (metrics["requests"] == 32 and metrics["errors"] == 0 and metrics["mean_batch"] > 1):
        raise AssertionError(f"/metrics: {metrics}")
    if bad != {"1-byte body": 400, "unknown path": 404, "body over 32 MiB": 413}:
        raise AssertionError(f"error statuses: {bad}")
    kernels = ("block1", "pyramid_peaks", "sample", "assoc")
    if min(counts[k] for k in kernels) < 1 or counts["gt"] or counts["peaks"]:
        raise AssertionError(f"launches during the requests: {counts}")
    _say("h", f"warm-up: {n_geoms} batch geometries (7 buckets x batch 1/2/4/8) in {warm_s:.2f} s")
    _say("h", f"32 PNG requests (H x W 368x368, 640x480, 720x1280; rows by filter None, Sub, "
              f"Up, Average, Paeth: {row_filters}; decoded by cv2 {cv2.__version__}) from 8 "
              "client threads, max batch 8, 5 ms window, the bucket ladder: every response "
              "equals the people of a "
              "BucketedRunner given the images of its device batch; (device batch, people) "
              "per shape "
              + "; ".join(f"{h}x{w}: {v}" for (h, w), v in by_shape.items())
              + f"; /healthz pretrained, /metrics {metrics['requests']} requests, "
              f"{metrics['errors']} errors, {metrics['batches']} device batches, mean "
              f"{metrics['mean_batch']:.2f}; statuses {bad}; launches {counts}: pass")
    _say("h", f"serving, max batch 8: {32 / wall:.2f} requests/s over the 32 requests, latency "
              f"p50 {metrics['latency_ms']['p50']:.2f} ms, p99 {metrics['latency_ms']['p99']:.2f} "
              f"ms (/metrics); the batcher's worker inside process_batch {recorded.busy_s:.3f} "
              f"of the {wall:.3f} s ({recorded.busy_s / wall:.3f}), "
              f"{sum(map(len, recorded.batches))} images in its device batches, padding included "
              f"({card})")

    # the batch dependence, on one image: its copies at each device batch
    # size in bf16, and with the same weights in f32 (TF32 off)
    f32_cfg = dataclasses.replace(
        DEFAULT, model=dataclasses.replace(DEFAULT.model, compute_dtype="float32"))
    f32 = PoseEstimator(f32_cfg, params=weights_lib.to_flax(served.model.state_dict()),
                        device="cuda")
    witness = {"bf16": _batch_witness(torch, np, served, images[0]),
               "f32": _batch_witness(torch, np, f32, images[0])}
    del f32
    _say("h", f"batch dependence, copy 0 of one 368x368 request image at device batch n "
              f"(copies of it) against batch 1: {json.dumps(witness)}")

    # host time to decode a request body: the server's decode_image (cv2), and
    # _decode_png, the decoder of a server without cv2, on the 368x368 body
    paeth = png_bytes(images[2], filters=(4,), level=6)
    decode_ms = {}
    for label, decode, body, img in (
            ("368x368", decode_image, bodies[0], images[0]),
            ("640x480", decode_image, bodies[1], images[1]),
            ("720x1280", decode_image, bodies[2], images[2]),
            ("720x1280 Paeth rows", decode_image, paeth, images[2]),
            ("368x368 by _decode_png", _decode_png, bodies[0], images[0])):
        t0 = time.perf_counter()
        decoded = decode(body)
        decode_ms[label] = round((time.perf_counter() - t0) * 1e3, 3)
        if not np.array_equal(decoded, img):
            raise AssertionError(f"the {label} body decodes to another image")
    _say("h", f"host ms to decode a request body: {decode_ms}")

    # 3. serial mode: no batcher, no buckets, one request through process()
    image = rng.integers(0, 256, (368, 368, 3)).astype(np.uint8)
    server = serve(served, port=0, max_batch=1)
    try:
        status, reply = _post(server, png_bytes(image, "adaptive", level=6))
    finally:
        server.shutdown()
    if server.batcher is not None or status != 200:
        raise AssertionError(f"serial server: batcher {server.batcher}, status {status}")
    _same_people(reply["people"], served.process(image)["people"], "the serial server")
    _say("h", f"serial server (max batch 1, no buckets): one 368x368 request, "
              f"{len(reply['people'])} people, equal to process(image): pass")
    return counts


def main(parent: str | None = None) -> int:
    import dataclasses
    import gc
    import tempfile

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from tpupose_torch import ops, topology
    from tpupose_torch.buckets import (
        DEFAULT_BUCKETS, BucketedRunner, choose_bucket, to_bucket, unscale_people,
    )
    from tpupose_torch.config import DEFAULT, AugmentConfig, ModelConfig, PoseConfig, TrainConfig
    from tpupose_torch.data.pipeline import synthetic_batches
    from tpupose_torch.decode import paf as paf_mod
    from tpupose_torch.decode import peaks as peaks_mod
    from tpupose_torch.decode.api import decode_impl_batch, decode_maps, to_people
    from tpupose_torch.decode.scalespace import ScaleSpace, chain_matrices, scale_shapes
    from tpupose_torch.gt import augment as gt_augment
    from tpupose_torch.gt import rasterize as gt_rasterize
    from tpupose_torch.infer import PoseEstimator
    from tpupose_torch.models import OpenPose
    from tpupose_torch.reference_impl import decode_np
    from tpupose_torch.ops import assoc as assoc_mod
    from tpupose_torch.ops import block1 as block1_mod
    from tpupose_torch.ops import gt as gt_mod
    from tpupose_torch.ops import image
    from tpupose_torch.ops import peaks as pk_mod
    from tpupose_torch.ops import pyramid_peaks as pp_mod
    from tpupose_torch.ops import sample as sample_mod
    from tpupose_torch.testing import crowded_scene, planted_scene
    from tpupose_torch.training import checkpoint as ckpt_lib
    from tpupose_torch.training import create_state, make_train_step
    from tpupose_torch.training import loss as loss_lib
    from tpupose_torch.training.loop import step_generator, train
    from tpupose_torch.training.optimizer import multipliers, param_labels

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
    b1_bytes = b1_flops = 0
    for _, _, ph, pw in sizes:
        # x read as f32, the pooled bf16 output written; 2 x (27 + 576) x 64 per pixel
        b1_bytes += 8 * ph * pw * 3 * 4 + 8 * (ph // 2) * (pw // 2) * 64 * 2
        b1_flops += 8 * ph * pw * 2 * (27 + 576) * 64
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
                        "plain_ms": sum(t[1] for t in times),
                        **_bound(b1_bytes + _nbytes(*wts), b1_flops, BF16_FLOPS),
                        # the two cuDNN convolutions of the plain version
                        "library_ms": sum(t[1] for t in times)}
    _say("b", "block1 ms per 4-scale batch of 8 (184/368/552/736): kernel "
              + "/".join(f"{t[0]:.3f}" for t in times) + ", plain "
              + "/".join(f"{t[1]:.3f}" for t in times) + f" ({card})")

    def smooth_maps(c, batch, sizes=sizes):
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
    # the blurred map everywhere (left and right products per image, channel
    # and scale), the averaged map at this run's peaks only; the operator
    # matrices are banded, so only their non-zero entries count
    n_peaks = int(mask.sum())
    pp_flops = 0
    chain = chain_matrices(scale_shapes(heat_space), heat_space.out_hw, float(icfg.peak_sigma))
    for m, (wy, wx, ay, bx) in zip(heat_space.maps, chain):
        wl = m.shape[2]
        pp_flops += 8 * 18 * 2 * (np.count_nonzero(ay) * wl + 368 * np.count_nonzero(bx))
        taps_y, taps_x = np.count_nonzero(wy) / 368, np.count_nonzero(wx) / 368
        pp_flops += n_peaks * 2 * (taps_y * taps_x + taps_x)
    record["pyramid_peaks"] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                               **_bound(_nbytes(*heat_space.maps, got), pp_flops, F32_FLOPS),
                               "library_ms": None}
    _say("b", f"pyramid peaks batch 8, 4 scales -> 368x368: {int(mask.sum())} peaks, same mask, "
              f"max err {err:.3e} (<= 1e-5): pass; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms ({card})")
    # the portrait bucket and a 720p frame at 4 scales: their band tables
    # once reached past the rows a block stages, and the wrapper refused them
    for hw_x, batch_x in (((656, 496), 2), ((720, 1280), 1)):
        sizes_x = image.scale_sizes(*hw_x, icfg.scale_search, 368, 8)
        space_x = ScaleSpace(smooth_maps(19, batch_x, sizes_x), [g[:2] for g in sizes_x], hw_x)
        got = pp_mod.pyramid_peak_scores(space_x, 18, icfg.peak_sigma, icfg.thre1)
        want = pp_mod.pyramid_peak_scores_plain(space_x, 18, icfg.peak_sigma, icfg.thre1)
        mask_x = torch.isfinite(want)
        if not torch.equal(torch.isfinite(got), mask_x) or int(mask_x.sum()) < 100:
            raise AssertionError(f"pyramid peaks at {hw_x}: {int(mask_x.sum())} peaks, "
                                 f"{int((torch.isfinite(got) != mask_x).sum())} mask flips")
        err_x = (got[mask_x] - want[mask_x]).abs().max().item()
        if not err_x <= 1e-5:
            raise AssertionError(f"pyramid peaks at {hw_x}: max err {err_x}")
        ms_x = _ms(torch, lambda: pp_mod.pyramid_peak_scores(space_x, 18, icfg.peak_sigma,
                                                             icfg.thre1), 5)
        record["pyramid_peaks"][f"ms_{hw_x[0]}x{hw_x[1]}_batch{batch_x}"] = ms_x
        _say("b", f"pyramid peaks at {hw_x[0]}x{hw_x[1]}, 4 scales, batch {batch_x}: "
                  f"{int(mask_x.sum())} peaks, same mask, max err {err_x:.3e} (<= 1e-5): pass; "
                  f"kernel {ms_x:.3f} ms ({card})")
    del space_x, got, want, mask_x

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
    # per point and scale 2 channels x (16 + 4) multiply-adds; a tap set
    # depends only on (scale, axis, coordinate), ~30 operations for each
    n_sc = len(paf_space.maps)
    record["sample"] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                        **_bound(_nbytes(*paf_space.maps, iy, ix, got),
                                 iy.numel() * n_sc * 2 * 20 * 2 + n_sc * (368 + 368) * 30,
                                 F32_FLOPS),
                        "library_ms": None}
    _say("b", f"sample {tuple(shape)} points x 4 scales: max err {err:.3e} (<= 1e-5): pass; "
              f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms ({card})")

    def candidate_tables(heats, pafs, geoms=geoms, hw=(368, 368)):
        """The decode's inputs to assoc, computed on the card."""
        hs = ScaleSpace(heats, geoms, hw)
        flats = pp_mod.pyramid_peak_scores(hs, 18, icfg.peak_sigma, icfg.thre1)
        b, c, n = flats.shape
        k = icfg.max_peaks
        tables = peaks_mod.peak_tables(flats.reshape(b * c, n), hw[1], k)
        pk = {key: v.reshape(b, c, k) for key, v in tables.items()}
        prior, ok, n_a, n_b = paf_mod.pair_scores(ScaleSpace(pafs, geoms, hw), pk,
                                                  icfg.mid_num, icfg.thre2, icfg.connect_min_ratio)
        return (*paf_mod.candidates(prior, ok, pk["scores"], min(512, k * k)),
                torch.minimum(n_a, n_b))

    heats1, pafs1 = planted_scene(sizes)
    planted = candidate_tables([h.to(dev) for h in heats1], [p.to(dev) for p in pafs1])
    # a crowd: 8 frames of 720x1280 with 32 people each (testing.crowded_scene,
    # seeds 0..7), the 4-scale maps resized from their rasterised labels
    crowd_hw = (720, 1280)
    crowd_sizes = image.scale_sizes(*crowd_hw, icfg.scale_search, 368, 8)
    crowd_geoms = [g[:2] for g in crowd_sizes]
    t_crowd = time.perf_counter()
    scenes = [crowded_scene(crowd_sizes, 32, seed) for seed in range(8)]
    crowd_heats = [torch.cat([sc[0][i] for sc in scenes]) for i in range(len(crowd_sizes))]
    crowd_pafs = [torch.cat([sc[1][i] for sc in scenes]) for i in range(len(crowd_sizes))]
    crowd_people = len(scenes[0][2])
    del scenes
    crowded = candidate_tables([h.to(dev) for h in crowd_heats], [p.to(dev) for p in crowd_pafs],
                               crowd_geoms, crowd_hw)
    _say("b", f"crowded scenes: 8 frames of {crowd_hw[0]}x{crowd_hw[1]}, {crowd_people} people "
              f"each, built and scored in {time.perf_counter() - t_crowd:.1f} s")
    k = icfg.max_peaks
    prior = rand((8, 19, k, k), 1.0)
    ok = torch.from_numpy(rng.random((8, 19, k, k)) < 0.02).to(dev)
    scores = torch.from_numpy(rng.random((8, 18, k)).astype(np.float32)).to(dev)
    limits = torch.from_numpy(rng.integers(1, k + 1, (8, 19)).astype(np.int32)).to(dev)
    random_tables = (*paf_mod.candidates(prior, ok, scores, min(512, k * k)), limits)
    kw = dict(k_slots=k, n_conn=min(icfg.max_connections, k),
              max_people=max(icfg.max_people, icfg.scan_people_capacity))
    clock_now, clock_max = _sm_clock_mhz()
    assoc_stats = {}
    for name, tables in (("planted scene", planted), ("random tables", random_tables),
                         ("crowded scenes", crowded)):
        got = assoc_mod.assoc(*tables, **kw)
        want = assoc_mod.assoc_plain(*tables, **kw)
        for key in want:
            if not torch.equal(got[key], want[key]):
                raise AssertionError(f"assoc {name}: {key} differs")
        # phase 2 walks every kept connection of an image in turn: its steps
        n_valid = paf_mod.greedy_accept(*tables, kw["k_slots"], kw["n_conn"])["n_valid"]
        steps = n_valid.sum(dim=1)
        assoc_stats[name] = (want, int(steps.max()), n_valid)
        _say("b", f"assoc on {name}: {int(want['active'].sum())} rows, bit-equal: pass; accepted "
                  f"connections per limb (batch max) {n_valid.amax(dim=0).tolist()}, phase-2 "
                  f"steps per image {steps.tolist()}")
    timed_assoc = {}
    for name, tables in (("random tables", random_tables), ("crowded scenes", crowded)):
        timed_assoc[name] = _alternate(torch, lambda: assoc_mod.assoc_plain(*tables, **kw),
                                       lambda: assoc_mod.assoc(*tables, **kw), 2)
    # a sequential walk: ~10 integer operations per finite candidate of this
    # run's tables (counted at the f32 rate) and per accepted connection; the
    # chain floor: the slowest image's phase-2 steps, one shared-memory round
    # trip (about 30 SM cycles) each, at the card's highest SM clock
    (k_ms, p_ms), (c_ms, c_plain_ms) = timed_assoc["random tables"], timed_assoc["crowded scenes"]
    want, steps_random, _ = assoc_stats["random tables"]
    visited = int(torch.isfinite(random_tables[0]).sum()) + int(want["active"].sum()) * 19
    floor = {name: st[1] * 30 / (clock_max * 1e3) for name, st in assoc_stats.items()}
    record["assoc"] = {"max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms,
                       **_bound(_nbytes(*random_tables, *want.values()), 10 * visited, F32_FLOPS),
                       "library_ms": None, "chain_floor_ms": floor["random tables"],
                       "phase2_steps": steps_random, "crowded_ms": c_ms,
                       "crowded_plain_ms": c_plain_ms,
                       "crowded_chain_floor_ms": floor["crowded scenes"],
                       "crowded_phase2_steps": assoc_stats["crowded scenes"][1],
                       "sm_clock_mhz": [clock_now, clock_max]}
    _say("b", f"assoc batch 8, K=96, 512 candidates/limb: random tables kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.3f} ms, chain floor {floor['random tables']:.4f} ms "
              f"({steps_random} phase-2 steps); crowded scenes kernel {c_ms:.4f} ms, plain "
              f"{c_plain_ms:.3f} ms, chain floor {floor['crowded scenes']:.4f} ms "
              f"({assoc_stats['crowded scenes'][1]} steps); SM clock {clock_now:.0f} MHz now, "
              f"{clock_max:.0f} at most ({card})")

    # gt: the training shape, some joints absent, two persons overlapping,
    # one sample empty, a random mask
    tcfg = DEFAULT
    n_b, n_p, lab = tcfg.train.batch_size, tcfg.augment.max_persons, tcfg.model.label_size
    jn = np.full((n_b, n_p, 18, 3), 2.0, np.float32)
    live = 6
    jn[:, :live, :, :2] = rng.uniform(0, tcfg.model.boxsize, (n_b, live, 18, 2))
    jn[:, :live, :, 2] = rng.choice([0.0, 1.0, 2.0], (n_b, live, 18), p=[0.6, 0.2, 0.2])
    jn[0, 1] = jn[0, 0] + np.asarray([3.0, -2.0, 0.0], np.float32)
    jn[-1, :, :, 2] = 2.0
    gj = torch.from_numpy(jn).to(dev)
    gm = torch.from_numpy(rng.uniform(size=(n_b, lab, lab)).astype(np.float32)).to(dev)
    gt_kw = dict(label_size=lab, stride=tcfg.model.stride, sigma=tcfg.augment.sigma,
                 paf_thre=tcfg.augment.paf_thre)
    got = gt_mod.create_labels(gj, gm, **gt_kw)
    want = gt_mod.create_labels_plain(gj, gm, **gt_kw)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, w in zip(("paf", "heat"), got, want):
        if g.shape != w.shape or not torch.equal(g != 0, w != 0):
            raise AssertionError(f"gt {name}: {int(((g != 0) != (w != 0)).sum())} mask flips")
        err = max(err, (g - w).abs().max().item())
    if not err <= 1e-6:
        raise AssertionError(f"gt: max err {err}")
    k_ms, p_ms = _alternate(torch, lambda: gt_mod.create_labels_plain(gj, gm, **gt_kw),
                            lambda: gt_mod.create_labels(gj, gm, **gt_kw), 5)
    # per pixel: ~9 operations (and an exp) per present joint, ~11 per live limb,
    # ~100 to finish the 57 channels — of this run's joints
    present = jn[..., 2] < 2.0
    limbs = np.asarray(topology.LIMBS)
    live_limbs = present[:, :, limbs[:, 0]] & present[:, :, limbs[:, 1]]
    gt_flops = lab * lab * (9.0 * present.sum() + 11.0 * live_limbs.sum() + 100.0 * n_b)
    record["gt"] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                    **_bound(_nbytes(gj, gm, *got), gt_flops, F32_FLOPS), "library_ms": None}
    _say("b", f"gt batch {n_b}, {n_p} persons, {lab}x{lab}: {int((want[1][..., :18] > 0).sum())} "
              f"heat and {int((want[0] != 0).sum())} PAF entries, same masks, max err {err:.3e} "
              f"(<= 1e-6): pass; kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms ({card})")
    # peaks: smooth random full-res maps (noise blurred at sigma 4), made on
    # the CPU from their own seed; a square batch and a non-square canvas
    prng = np.random.default_rng(3)
    for shape in ((8, 368, 368, 19), (2, 496, 656, 19)):
        noise = torch.from_numpy(prng.normal(size=shape).astype(np.float32))
        field_cpu = peaks_mod.gaussian_blur(noise, 4.0) * 0.75
        field = field_cpu.to(dev)
        got = pk_mod.peak_scores(field, 18, icfg.peak_sigma, icfg.thre1)
        torch.cuda.synchronize()
        want = pk_mod.peak_scores_plain(field, 18, icfg.peak_sigma, icfg.thre1)
        n_peaks = int(torch.isfinite(want).sum())
        if got.shape != (shape[0], 18, shape[1] * shape[2]) or n_peaks < 1000:
            raise AssertionError(f"peaks {shape}: output {tuple(got.shape)}, {n_peaks} peaks")
        if not torch.equal(got, want):
            flips = int((torch.isfinite(got) != torch.isfinite(want)).sum())
            raise AssertionError(f"peaks {shape}: not bit-equal to the plain version "
                                 f"({flips} mask flips)")
        _say("b", f"peaks at {shape}: {n_peaks} peaks, bit-equal to the plain version: pass")
        if shape[0] == 8:
            pk_field, pk_out, pk_field_cpu = field, got, field_cpu
    twin = decode_np.find_peaks_np(pk_field[0].cpu().numpy(), icfg)
    twin_err, twin_n = 0.0, 0
    for part in range(18):
        flat = pk_out[0, part].cpu()
        at = torch.nonzero(torch.isfinite(flat))[:, 0]
        if [(int(i) % 368, int(i) // 368) for i in at] != [(x, y) for x, y, _, _ in twin[part]]:
            raise AssertionError(f"peaks: part {part} differs from the scipy twin's peaks")
        twin_n += len(at)
        for i, (_, _, score, _) in zip(at, twin[part]):
            twin_err = max(twin_err, abs(float(flat[i]) - score))
    if not twin_err <= 1e-5:
        raise AssertionError(f"peaks: values differ from the scipy twin's by {twin_err}")
    _say("b", f"peaks, image 0 against the scipy twin: the same {twin_n} peak coordinates, "
              f"values within {twin_err:.1e} (<= 1e-5): pass")
    k_ms, p_ms = _alternate(
        torch, lambda: pk_mod.peak_scores_plain(pk_field, 18, icfg.peak_sigma, icfg.thre1),
        lambda: pk_mod.peak_scores(pk_field, 18, icfg.peak_sigma, icfg.thre1), 5)
    # wider blurs than the templated radii: the generic path, bit-equal too
    for sigma_x in (4.5, 6.0):
        got = pk_mod.peak_scores(pk_field, 18, sigma_x, icfg.thre1)
        want = pk_mod.peak_scores_plain(pk_field, 18, sigma_x, icfg.thre1)
        if int(torch.isfinite(want).sum()) < 100:
            raise AssertionError(f"peaks at sigma {sigma_x}: {int(torch.isfinite(want).sum())} "
                                 "peaks")
        if not torch.equal(got, want):
            raise AssertionError(f"peaks at sigma {sigma_x}: not bit-equal to the plain version "
                                 f"({int((torch.isfinite(got) != torch.isfinite(want)).sum())} "
                                 "mask flips)")
        sig_ms = _ms(torch, lambda: pk_mod.peak_scores(pk_field, 18, sigma_x, icfg.thre1), 5)
        record.setdefault("peaks_sigma_ms", {})[sigma_x] = sig_ms
        _say("b", f"peaks at (8, 368, 368, 19), sigma {sigma_x} (radius "
                  f"{(len(peaks_mod.gaussian_kernel1d(sigma_x)) - 1) // 2}): "
                  f"{int(torch.isfinite(want).sum())} peaks, bit-equal to the plain version: "
                  f"pass; kernel {sig_ms:.3f} ms ({card})")
    # bytes: the 18 scored channels of the input (the 19th is never read) and
    # the output; per output: two passes of 25 taps, a multiply and an add each
    n_taps = len(peaks_mod.gaussian_kernel1d(icfg.peak_sigma))
    record["peaks"] = {"max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms,
                       **_bound(2 * _nbytes(pk_out), pk_out.numel() * 2 * n_taps * 2,
                                F32_FLOPS),
                       "library_ms": None, "sigma_ms": record.pop("peaks_sigma_ms")}
    _say("b", f"peaks batch 8, 368x368, 18 channels: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
              f"({card})")
    del pk_field, pk_out, field, got, want
    for name, r in record.items():
        _say("b", f"{name}: bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
                  f"({r['bound_ms'] / r['ms']:.3f} of the kernel's {r['ms']:.4f} ms); "
                  f"library call {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 3)}")

    # --- c. the main path ---------------------------------------------------
    est = PoseEstimator(DEFAULT, seed=0, device="cuda")
    imgs8 = rng.integers(0, 256, (8, 368, 368, 3)).astype(np.uint8)
    imgs16 = rng.integers(0, 256, (16, 368, 368, 3)).astype(np.uint8)
    ops.reset_launch_counts()
    people8 = est.process_batch(imgs8)
    people16 = est.process_batch(imgs16, scales=(1.0,))
    torch.cuda.synchronize()
    counts_infer = ops.launch_counts()
    if len(people8) != 8 or len(people16) != 16:
        raise AssertionError("process_batch returned the wrong number of images")
    for p in (pp for batch in (people8, people16) for img in batch for pp in img):
        vals = [p["score"]] + [v for kp in p["keypoints"].values() for v in kp.values()]
        if not np.isfinite(vals).all():
            raise AssertionError("non-finite value in the people JSON")
    inference_kernels = ("block1", "pyramid_peaks", "sample", "assoc")
    if (min(counts_infer[k] for k in inference_kernels) < 1 or counts_infer["gt"] != 0
            or counts_infer["peaks"] != 0):
        raise AssertionError(f"launches over the inference path: {counts_infer}")
    _say("c", f"process_batch 8x368x368 x 4 scales and 16x368x368 x scale 1.0: "
              f"{sum(map(len, people8))} + {sum(map(len, people16))} people; launches {counts_infer}")
    # a 720p frame at the four scales: block1 at up to 736x1312, and band
    # tables whose plain-chain runs once reached past the staged rows
    frame720 = rng.integers(0, 256, (1, 720, 1280, 3)).astype(np.uint8)
    ops.reset_launch_counts()
    people720 = est.process_batch(frame720)
    torch.cuda.synchronize()
    counts720 = ops.launch_counts()
    if len(people720) != 1 or min(counts720[k] for k in inference_kernels) < 1:
        raise AssertionError(f"process_batch on a 720x1280 frame: {len(people720)} results, "
                             f"launches {counts720}")
    for p in people720[0]:
        vals = [p["score"]] + [v for kp in p["keypoints"].values() for v in kp.values()]
        if not np.isfinite(vals).all():
            raise AssertionError("non-finite value in the 720p people JSON")
    _say("c", f"process_batch on one 720x1280 frame x 4 scales: {len(people720[0])} people; "
              f"launches {counts720}")
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

    # the full-res path: the same batch through a second estimator
    full_cfg = dataclasses.replace(DEFAULT, inference=dataclasses.replace(
        DEFAULT.inference, paf_readout="fullres"))
    est_full = PoseEstimator(full_cfg, seed=0, device="cuda")
    ops.reset_launch_counts()
    people8f = est_full.process_batch(imgs8)
    torch.cuda.synchronize()
    counts_full = ops.launch_counts()
    want_full = {"block1": 4, "pyramid_peaks": 0, "sample": 0, "assoc": 1, "gt": 0, "peaks": 1}
    if counts_full != want_full:
        raise AssertionError(f"launches over one full-res batch: {counts_full}, not {want_full}")
    if len(people8f) != 8:
        raise AssertionError("full-res process_batch returned the wrong number of images")
    for p in (pp for img in people8f for pp in img):
        vals = [p["score"]] + [v for kp in p["keypoints"].values() for v in kp.values()]
        if not np.isfinite(vals).all():
            raise AssertionError("non-finite value in the full-res people JSON")
    _say("c", f"paf_readout='fullres': process_batch 8x368x368 x 4 scales: "
              f"{sum(map(len, people8f))} people; launches {counts_full}")
    heat1, paf1 = est_full.maps(imgs8[0])
    heat_avg8, paf_avg8 = est_full.maps_batch(imgs8)
    if tuple(heat1.shape) != (368, 368, 19) or tuple(paf1.shape) != (368, 368, 38):
        raise AssertionError(f"maps(): shapes {tuple(heat1.shape)}, {tuple(paf1.shape)}")
    for name, one, many in (("heat", heat1, heat_avg8[0]), ("paf", paf1, paf_avg8[0])):
        rel = ((one - many).norm() / many.norm()).item()
        if not (torch.isfinite(one).all() and rel <= 0.05):
            raise AssertionError(f"maps() {name}: relative L2 {rel} from the batch's averaged map")
        _say("c", f"maps() of image 0, {name} {tuple(one.shape)} f32: relative L2 {rel:.3e} from "
                  f"maps_batch of the batch, image 0 (bound 5e-2): pass")
    # what the runner's check below scales the random network's outputs by
    heat_top, paf_top = heat1[..., :18].abs().max().item(), paf1.abs().max().item()
    # released until its timings, so that the scale-space runs' peak memory
    # holds no second estimator
    del one, many, heat1, paf1, heat_avg8, paf_avg8, est_full

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

    # the same scene materialised at full resolution, through decode_maps
    def materialise(maps, d):
        return image.average_upsampled([m.to(d) for m in maps], sizes, 368, 368, 8)[0]

    full = {d: decode_maps(materialise(heats1, d), materialise(pafs1, d), icfg)
            for d in ("cpu", "cuda")}
    mixed = decode_maps(materialise(heats1, "cuda"),
                        ScaleSpace([p[0].to(dev) for p in pafs1], geoms, (368, 368)), icfg)
    others = (("the full-res decode on the CPU", full["cpu"]),
              ("the scale-space decode", {key: v[0] for key, v in out["cuda"].items()}),
              ("full-res heat with scale-space PAFs", mixed))
    for label, other in others:
        for key, v in full["cuda"].items():
            o = other[key].to(dev)
            if v.dtype.is_floating_point:
                if not (v - o).abs().max().item() <= 1e-4:
                    raise AssertionError(f"planted scene, decode_maps: {key} differs from {label}")
            elif not torch.equal(v, o):
                raise AssertionError(f"planted scene, decode_maps: {key} differs from {label}")
    people = to_people({key: v.cpu().numpy() for key, v in full["cuda"].items()})
    if len(people) != 2:
        raise AssertionError(f"planted scene decoded to {len(people)} people through decode_maps")
    _say("d", f"the scene materialised with upsample_to, through decode_maps: {len(people)} people "
              f"({[p['num_parts'] for p in people]} parts); integers equal and floats within 1e-4 "
              "of " + ", ".join(label for label, _ in others) + ": pass")

    # --- e. timings -------------------------------------------------------------
    def throughput(runner, batch, scales, n_warm, n_timed):
        for _ in runner.stream([batch] * n_warm, scales=scales):
            pass
        torch.cuda.synchronize()
        t = time.perf_counter()
        done = sum(len(r) for r in runner.stream([batch] * n_timed, scales=scales))
        return done / (time.perf_counter() - t)

    torch.cuda.reset_peak_memory_stats()
    ips4 = throughput(est, imgs8, None, 2, 8)
    ips1 = throughput(est, imgs16, (1.0,), 2, 12)
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

    # sample at the main path's own tables: the points pair_scores builds from
    # the peaks of the seeded network's maps
    with torch.inference_mode():
        flats = pp_mod.pyramid_peak_scores(hs, 18, icfg.peak_sigma, icfg.thre1)
        pk = {key: v.reshape(8, 18, k) for key, v in
              peaks_mod.peak_tables(flats.reshape(8 * 18, -1), 368, k).items()}
        iy_main, ix_main = paf_mod.limb_points(pk, (368, 368), icfg.mid_num)[:2]
        n_live = int(pk["valid"].sum())
        got = sample_mod.sample_avg(ps, iy_main, ix_main, chans)
        err = (got - sample_mod.sample_avg_plain(ps, iy_main, ix_main, chans)).abs().max().item()
        if not err <= 1e-5:
            raise AssertionError(f"sample at the main path's tables: max err {err}")
        main_ms = (_ms(torch, lambda: sample_mod.sample_avg(ps, iy_main, ix_main, chans), 3)
                   + _ms(torch, lambda: sample_mod.sample_avg(ps, iy_main, ix_main, chans), 3)) / 2
    record["sample"]["main_path_ms"] = main_ms
    _say("e", f"sample, device ms at {tuple(iy_main.shape)} points: the main path's own tables "
              f"({n_live} live peaks of {8 * 18 * k} slots, the rest coincide) {main_ms:.3f} "
              f"(max err {err:.1e} <= 1e-5), random points {record['sample']['ms']:.3f} ({card})")
    # the crowded scenes end to end: the scale-space decode of the 8 frames on
    # the card (device ms, the assoc kernel's share) and the people it finds,
    # against the plain decode of the same maps on the CPU
    with torch.inference_mode():
        ch = ScaleSpace([m.to(dev) for m in crowd_heats], crowd_geoms, crowd_hw)
        cp = ScaleSpace([m.to(dev) for m in crowd_pafs], crowd_geoms, crowd_hw)
        crowd_out = decode_impl_batch(ch, cp, icfg)
        crowd_ms = _ms(torch, lambda: decode_impl_batch(ch, cp, icfg), 3)
        # the decode by part, as decode_impl_batch runs them
        c_flats = pp_mod.pyramid_peak_scores(ch, 18, icfg.peak_sigma, icfg.thre1)
        c_pk = {key: v.reshape(8, 18, k) for key, v in
                peaks_mod.peak_tables(c_flats.reshape(8 * 18, -1), crowd_hw[1], k).items()}
        c_prior, c_ok, _, _ = paf_mod.pair_scores(cp, c_pk, icfg.mid_num, icfg.thre2,
                                                  icfg.connect_min_ratio)
        crowd_parts = {
            "pyramid_peaks kernel": _ms(torch, lambda: pp_mod.pyramid_peak_scores(
                ch, 18, icfg.peak_sigma, icfg.thre1), 5),
            "peak tables": _ms(torch, lambda: peaks_mod.peak_tables(
                c_flats.reshape(8 * 18, -1), crowd_hw[1], k), 5),
            "pair scores": _ms(torch, lambda: paf_mod.pair_scores(
                cp, c_pk, icfg.mid_num, icfg.thre2, icfg.connect_min_ratio), 3),
            "candidates": _ms(torch, lambda: paf_mod.candidates(
                c_prior, c_ok, c_pk["scores"], min(512, k * k)), 5),
            "assoc kernel": _ms(torch, lambda: assoc_mod.assoc(*crowded, **kw), 20),
        }
        crowd_parts["cull and the rest"] = crowd_ms - sum(crowd_parts.values())
        crowd_cpu = decode_impl_batch(ScaleSpace(crowd_heats, crowd_geoms, crowd_hw),
                                      ScaleSpace(crowd_pafs, crowd_geoms, crowd_hw), icfg)
    n_card = [len(to_people({key: v[i].cpu().numpy() for key, v in crowd_out.items()}))
              for i in range(8)]
    n_cpu = [len(to_people({key: v[i].numpy() for key, v in crowd_cpu.items()})) for i in range(8)]
    if n_card != n_cpu or min(n_card) < crowd_people // 2:
        raise AssertionError(f"crowded scenes: the card decodes {n_card} people, the CPU {n_cpu}")
    record["assoc"]["crowded_decode_ms"] = crowd_ms
    _say("e", f"crowded scenes, 8 frames of {crowd_hw[0]}x{crowd_hw[1]} with {crowd_people} "
              f"people each, 4 scales: scale-space decode {crowd_ms:.2f} device ms, of which the "
              f"assoc kernel {crowd_parts['assoc kernel']:.4f} "
              f"({crowd_parts['assoc kernel'] / crowd_ms:.4f}); by part: "
              + ", ".join(f"{key} {v:.3f}" for key, v in crowd_parts.items())
              + f"; people decoded per frame {n_card}, equal to the plain decode on the CPU: "
              f"pass ({card})")
    del ch, cp, crowd_out, crowd_cpu, c_flats, c_pk, c_prior, c_ok

    # the kernels redesigned in an earlier PR or in this one: timed beside the
    # parent's (--parent); those whose source differs from the parent's are
    # held to it as the header says
    for name in ("block1", "sample", "pyramid_peaks", "peaks", "assoc", "gt"):
        record[name]["prev_ms"] = None
    if parent is not None:
        with tempfile.TemporaryDirectory() as tmp:
            data_path = os.path.join(tmp, "kernel_inputs.pt")
            torch.save({"maps": [m.float().cpu() for m in ps.maps], "iy": iy_main.cpu(),
                        "ix": ix_main.cpu(), "heat": [m.cpu() for m in heat_space.maps],
                        "field": pk_field_cpu,
                        "assoc_random": [t.cpu() for t in random_tables],
                        "assoc_crowded": [t.cpu() for t in crowded], "assoc_kw": kw,
                        "gt": [gj.cpu(), gm.cpu()], "gt_kw": gt_kw}, data_path)
            turns = [_parent_times(parent, data_path), _redesigned_times(torch, np, data_path),
                     _redesigned_times(torch, np, data_path), _parent_times(parent, data_path)]
            outs = [torch.load(t.pop("outputs")) for t in turns]
        # bit for bit: each run's outputs against the parent's first run's
        diff = {name: [_bits_differ(torch, o[name], outs[0][name]) for o in outs[1:]]
                for name in outs[0]}
        was = {key: np.mean([turns[0][key], turns[3][key]], axis=0) for key in turns[0]}
        now = {key: np.mean([turns[1][key], turns[2][key]], axis=0) for key in turns[0]}
        record["block1"]["prev_ms"] = float(was["block1"].sum())
        record["sample"]["prev_ms"] = float(was["sample_random"])
        record["sample"]["prev_main_path_ms"] = float(was["sample_main_path"])
        for name in ("pyramid_peaks", "peaks", "gt"):
            record[name]["prev_ms"] = float(was[name])
            record[name]["in_turns_ms"] = float(now[name])
        record["assoc"]["prev_ms"] = float(was["assoc_random"])
        record["assoc"]["prev_crowded_ms"] = float(was["assoc_crowded"])
        record["assoc"]["in_turns_ms"] = float(now["assoc_random"])
        record["assoc"]["crowded_in_turns_ms"] = float(now["assoc_crowded"])
        changed = set()
        for kern in ops.KERNELS:
            with open(os.path.join(parent, kern.source), "rb") as f_was, \
                    open(os.path.join(ROOT, kern.source), "rb") as f_now:
                if f_was.read() != f_now.read():
                    changed.add(kern.name)
        _say("e", "the redesigned kernels beside the parent's, in turns (parent, change, change, "
                  "parent), device ms, parent -> change: block1 per geometry "
                  + ", ".join(f"{a:.3f} -> {b:.3f}" for a, b in zip(was["block1"], now["block1"]))
                  + f" (184/368/552/736), sum {was['block1'].sum():.3f} -> "
                  f"{now['block1'].sum():.3f}; sample on random points "
                  f"{was['sample_random']:.3f} -> {now['sample_random']:.3f}, on the main "
                  f"path's tables {was['sample_main_path']:.3f} -> "
                  f"{now['sample_main_path']:.3f}; pyramid_peaks {was['pyramid_peaks']:.4f} -> "
                  f"{now['pyramid_peaks']:.4f}; peaks {was['peaks']:.4f} -> {now['peaks']:.4f}; "
                  f"assoc on random tables {was['assoc_random']:.4f} -> "
                  f"{now['assoc_random']:.4f}, on the crowded scenes {was['assoc_crowded']:.4f} "
                  f"-> {now['assoc_crowded']:.4f}; gt {was['gt']:.4f} -> {now['gt']:.4f} "
                  f"({card}); sources changed: {sorted(changed)}")
        _say("e", "outputs on the saved inputs, elements whose bits differ from the parent's "
                  "first run (change, change, parent): "
                  + ", ".join(f"{name} {d}" for name, d in diff.items()))
        # redesigned here: faster than the parent's; only repaired (source
        # changed): bit-equal to it and at most 5 % slower
        slower = [key for key, name in (("assoc_random", "assoc"), ("assoc_crowded", "assoc"),
                                        ("gt", "gt")) if now[key] >= was[key]]
        slower += [name for name in ("pyramid_peaks", "peaks")
                   if name in changed and now[name] > 1.05 * was[name]]
        unequal = [name for name, d in diff.items() if any(d)]
        if slower or unequal:
            raise AssertionError(f"against the parent: slower {slower}, outputs differ {unequal}")
    del flats, pk, iy_main, ix_main, got

    # the full-res path beside the scale-space one, in turns within this call
    est_full = PoseEstimator(full_cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    turns = {"scalespace": [ips4], "fullres": []}
    for name, runner in (("fullres", est_full), ("fullres", est_full), ("scalespace", est)):
        turns[name].append(throughput(runner, imgs8, None, 2, 8))
    full_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    with torch.inference_mode():
        # from the low-res outputs of the split above (the two estimators hold
        # the same seeded weights)
        up_ms = _ms(torch, lambda: (image.average_upsampled(hs.maps, sizes, 368, 368, 8),
                                    image.average_upsampled(ps.maps, sizes, 368, 368, 8)), 3)
        heat_avg8, paf_avg8 = est_full.maps_batch(imgs8)
        fdec_ms = _ms(torch, lambda: decode_impl_batch(heat_avg8, paf_avg8, icfg), 3)
        # the decode's parts on this batch's maps: the peaks kernel, the peak
        # tables, the pair scores with their indexed readout, and the rest
        # (candidate sort, assoc, cull)
        flats8 = pk_mod.peak_scores(heat_avg8, 18, icfg.peak_sigma, icfg.thre1)
        pk8 = {key: v.reshape(8, 18, k) for key, v in
               peaks_mod.peak_tables(flats8.reshape(8 * 18, -1), 368, k).items()}
        parts_ms = {
            "peaks kernel": _ms(torch, lambda: pk_mod.peak_scores(
                heat_avg8, 18, icfg.peak_sigma, icfg.thre1), 5),
            "peak tables": _ms(torch, lambda: peaks_mod.peak_tables(
                flats8.reshape(8 * 18, -1), 368, k), 5),
            "pair scores": _ms(torch, lambda: paf_mod.pair_scores(
                paf_avg8, pk8, icfg.mid_num, icfg.thre2, icfg.connect_min_ratio), 3),
            "indexed readout alone": _ms(torch, lambda: paf_mod.sample_fullres(
                paf_avg8, iy, ix, chans), 3),
        }
        parts_ms["candidates + assoc + cull"] = fdec_ms - sum(
            parts_ms[key] for key in ("peaks kernel", "peak tables", "pair scores"))
        del flats8, pk8
    samples = []
    for _ in range(7):
        t = time.perf_counter()
        est_full.maps(imgs8[0])
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t) * 1e3)
    _say("e", "4 scales, batch 8, in turns (scale-space, full-res, full-res, scale-space): "
              f"fullres {' / '.join(f'{v:.2f}' for v in turns['fullres'])} images/s, scalespace "
              f"{' / '.join(f'{v:.2f}' for v in turns['scalespace'])} images/s; full-res device "
              f"ms per batch: upsample + average {up_ms:.2f}, decode {fdec_ms:.2f} (scale-space "
              f"decode {dec_ms:.2f}); maps() of one image p50 {sorted(samples)[3]:.2f} ms (host "
              f"clock); peak memory over the turns {full_gb:.2f} GiB ({card})")
    _say("e", "full-res decode, device ms per batch of 8 by part: "
              + ", ".join(f"{key} {v:.3f}" for key, v in parts_ms.items()) + f" ({card})")
    del heat_avg8, paf_avg8, outs, hs, ps, xs, x0

    # BucketedRunner over three shapes. The random network emits no peak, so the
    # two output convolutions are scaled until the largest heat and PAF values
    # of one image are 1; the runner is then held against process_batch on each
    # canvas alone (same batch geometry: the canvas twice).
    with torch.no_grad():
        for branch, peak in (("stage6_L2", heat_top), ("stage6_L1", paf_top)):
            head = getattr(est_full.model, branch).out
            head.weight.mul_(1.0 / peak)
            head.bias.mul_(1.0 / peak)
        del head
    mixed_imgs = [rng.integers(0, 256, shape).astype(np.uint8)
                  for shape in ((300, 400, 3), (368, 368, 3), (600, 800, 3))]
    got_many = BucketedRunner(est_full, batch_size=2).process_many(mixed_imgs)
    if len(got_many) != 3:
        raise AssertionError(f"BucketedRunner returned {len(got_many)} results for 3 images")
    picked = []
    for img, got_people in zip(mixed_imgs, got_many):
        bh, bw, scale = choose_bucket(*img.shape[:2], DEFAULT_BUCKETS)
        canvas, vh, vw = to_bucket(img, bh, bw, scale)
        alone = est_full.process_batch(np.stack([canvas, canvas]),
                                       valid_hw=np.asarray([[vh, vw]] * 2, np.int32))[0]
        want_people = unscale_people(alone, scale)
        picked.append(((bh, bw), round(scale, 4), len(got_people)))
        if len(got_people) != len(want_people):
            raise AssertionError(f"BucketedRunner: {len(got_people)} people, alone {len(want_people)}")
        for a, b in zip(got_people, want_people):
            if a["num_parts"] != b["num_parts"] or sorted(a["keypoints"]) != sorted(b["keypoints"]):
                raise AssertionError("BucketedRunner: a person differs from the canvas alone")
            for name, kp in a["keypoints"].items():
                o = b["keypoints"][name]
                if (kp["x"], kp["y"]) != (o["x"], o["y"]) or abs(kp["score"] - o["score"]) > 1e-4:
                    raise AssertionError("BucketedRunner: a keypoint differs from the canvas alone")
                if not (0 <= kp["x"] < img.shape[1] + 1 and 0 <= kp["y"] < img.shape[0] + 1):
                    raise AssertionError("BucketedRunner: a keypoint lies outside its image")
    _say("d", "BucketedRunner.process_many over 300x400, 368x368, 600x800 (output convolutions "
              f"scaled): (bucket, scale, people) {picked}; each equals process_batch on its "
              "canvas alone, in input order and original coordinates: pass")
    # a portrait image through the scale-space estimator (the same seeded
    # weights, its output convolutions scaled the same way): the 656x496
    # bucket, whose band tables once reached past the staged rows
    with torch.no_grad():
        for branch, peak in (("stage6_L2", heat_top), ("stage6_L1", paf_top)):
            head = getattr(est.model, branch).out
            head.weight.mul_(1.0 / peak)
            head.bias.mul_(1.0 / peak)
        del head
    portrait = rng.integers(0, 256, (640, 480, 3)).astype(np.uint8)
    bh, bw, scale = choose_bucket(*portrait.shape[:2], DEFAULT_BUCKETS)
    if (bh, bw) != (656, 496):
        raise AssertionError(f"the 640x480 image went to the {bh}x{bw} bucket")
    ops.reset_launch_counts()
    got_portrait = BucketedRunner(est, batch_size=2).process_many([portrait])
    torch.cuda.synchronize()
    counts_portrait = ops.launch_counts()
    canvas, vh, vw = to_bucket(portrait, bh, bw, scale)
    alone = unscale_people(est.process_batch(
        np.stack([canvas, canvas]), valid_hw=np.asarray([[vh, vw]] * 2, np.int32))[0], scale)
    if counts_portrait["pyramid_peaks"] < 1 or len(got_portrait) != 1:
        raise AssertionError(f"the portrait runner: launches {counts_portrait}")
    if len(got_portrait[0]) != len(alone) or any(
            a["num_parts"] != b["num_parts"] or abs(a["score"] - b["score"]) > 1e-4
            for a, b in zip(got_portrait[0], alone)):
        raise AssertionError("BucketedRunner (scale-space) on the portrait image differs from "
                             "process_batch on its canvas alone")
    _say("d", f"BucketedRunner (scale-space readout) on a 640x480 portrait image: bucket "
              f"{bh}x{bw}, {len(got_portrait[0])} people, equal to process_batch on its canvas "
              f"alone; launches {counts_portrait}: pass")
    # --- h. the serving path ------------------------------------------------------
    del est_full
    gc.collect()
    counts_serve = _serving_phase(torch, np, est, card, rng)

    # the training phases start as in a process of their own: no estimator,
    # no cached block of the inference paths
    del est
    gc.collect()
    torch.cuda.empty_cache()

    # --- f. the training path at full width -------------------------------------
    torch.backends.cudnn.deterministic = True        # for the bit-equal resume
    # the default recipe as it stands; only the logging and checkpoint periods
    # are set, so that 5 steps show every loss and leave a checkpoint
    fcfg = dataclasses.replace(DEFAULT, train=dataclasses.replace(
        DEFAULT.train, log_every=1, checkpoint_every=5))
    batch = next(synthetic_batches(fcfg, seed=0))
    seen: list[dict] = []
    with tempfile.TemporaryDirectory() as workdir:
        ops.reset_launch_counts()
        ran = train(fcfg, [batch] * 5, workdir=workdir, max_steps=5, seed=0, device="cuda",
                    on_step=lambda i, losses: seen.append(losses))
        torch.cuda.synchronize()
        counts_train = ops.launch_counts()
        if ran["steps"] != 5 or len(seen) != 5:
            raise AssertionError(f"train() took {ran['steps']} steps, logged {len(seen)}")
        for i, losses in enumerate(seen):
            if len(losses) != 13 or not np.isfinite(list(losses.values())).all():
                raise AssertionError(f"step {i + 1}: losses {losses}")
        if counts_train["gt"] != 5 or any(v for k, v in counts_train.items() if k != "gt"):
            raise AssertionError(f"launches over 5 train steps: {counts_train}")
        if ckpt_lib.latest_step(f"{workdir}/{fcfg.train.checkpoint_dir}") != 5:
            raise AssertionError("train() left no checkpoint at step 5")
        _say("f", f"train() 5 steps of the default recipe, batch {n_b}, "
                  f"{fcfg.model.compute_dtype}: 13 finite losses "
                  f"per step, total {seen[0]['total']:.4f} -> {seen[-1]['total']:.4f} (random "
                  f"augmentation), a checkpoint at step 5; launches {counts_train}; "
                  f"{ran['steps_per_sec']:.2f} steps/s with the first step's set-up")

    # resume: a fresh trainer restored from a checkpoint vs the live state. Taken
    # with clip_norm, the configuration's knob for training from scratch: the
    # default recipe's step 6 from this random init is not finite (see below).
    clipped = dataclasses.replace(fcfg, train=dataclasses.replace(fcfg.train, clip_norm=5.0))
    with tempfile.TemporaryDirectory() as workdir:
        ran = train(clipped, [batch] * 5, workdir=workdir, max_steps=5, seed=0, device="cuda")
        model = OpenPose(num_stages=clipped.model.num_stages, dtype=torch.bfloat16)
        model.reset_parameters(torch.Generator().manual_seed(123))
        fresh, tx = create_state(clipped, model.state_dict(), "cuda")
        restored = ckpt_lib.restore(f"{workdir}/{clipped.train.checkpoint_dir}", fresh.tree())
        if restored is None or restored["step"] != 5:
            raise AssertionError("no checkpoint at step 5 to restore")
        step_fn = make_train_step(clipped, model, tx, loss_denom=n_b)
        _, live_losses = step_fn(ran["state"], step_generator(0, 5), batch)
        _, back_losses = step_fn(restored, step_generator(0, 5), batch)
        for k in live_losses:
            if not (torch.isfinite(live_losses[k]) and torch.equal(live_losses[k], back_losses[k])):
                raise AssertionError(f"resume: {k} {float(back_losses[k])} != {float(live_losses[k])}")
        for name, p in ran["state"]["params"].items():
            if not torch.equal(p, restored["params"][name]):
                raise AssertionError(f"resume: {name} differs after the next step")
        _say("f", f"clip_norm 5.0: total {ran['last_losses']['total']:.4f} at step 5; its "
                  f"checkpoint restored into a fresh trainer: step 6 bit-equal "
                  f"(total {float(live_losses['total']):.6f}): pass")
        del fresh, restored, ran

    def descend(cfg, n_steps, draws):
        """n_steps on ``batch`` with fixed augmentation draws, from the
        seeded init: (first params, tree, totals)."""
        model = OpenPose(num_stages=cfg.model.num_stages,
                         dtype=getattr(torch, cfg.model.compute_dtype))
        model.reset_parameters(torch.Generator().manual_seed(0))
        state, tx = create_state(cfg, model.state_dict(), "cuda")
        start = {k: v.clone() for k, v in state.params.items()}
        step_fn = make_train_step(cfg, model, tx, loss_denom=cfg.train.batch_size)
        tree, totals = state.tree(), []
        for _ in range(n_steps):
            tree, losses = step_fn(tree, draws, batch)
            totals.append(float(losses["total"]))
        return start, tree, totals

    fixed = gt_augment.batch_params(torch.Generator().manual_seed(0), fcfg.augment, n_b)
    # From a random init the default recipe (base_lr 4e-5 x 4 on the stages,
    # momentum 0.9, written for fine-tuning pretrained weights) is past its
    # stable rate; the rate is not raised or lowered here. The fall is looked
    # for with the default in bf16, then in f32, then with clip_norm, the
    # configuration's own knob for training from scratch; all three are shown.
    f32cfg = dataclasses.replace(fcfg, model=dataclasses.replace(
        fcfg.model, compute_dtype="float32"))
    fell_with, f32_totals = None, None
    for label, cfg in (("the default recipe in bfloat16", fcfg),
                       ("the default recipe in float32", f32cfg),
                       ("clip_norm 5.0 in bfloat16", clipped)):
        totals = descend(cfg, 5, fixed)[2]
        falls = bool(np.isfinite(totals).all() and totals[-1] < totals[0])
        if cfg is f32cfg:
            f32_totals = totals
        if falls and fell_with is None:
            fell_with = label
        _say("f", f"fixed augmentation, base_lr {cfg.train.base_lr}, {label}: total "
                  + " -> ".join(f"{t:.6g}" for t in totals)
                  + (": falls" if falls else ": does not fall"))
    if fell_with is None:
        raise AssertionError("the total loss fell over 5 steps in none of the three runs")
    _say("f", f"the total loss falls over 5 steps with {fell_with}: pass")
    frozen = dataclasses.replace(fcfg, train=fcfg.train.frozen_vgg())
    start, tree, _ = descend(frozen, 3, fixed)
    for name, p in tree["params"].items():
        if name.startswith("vgg.") and not torch.equal(p, start[name]):
            raise AssertionError(f"frozen VGG: {name} changed")
    moved = (tree["params"]["stage2_L1.conv1.weight"] - start["stage2_L1.conv1.weight"]).abs().max().item()
    if not moved > 0:
        raise AssertionError("frozen VGG: stage2_L1.conv1.weight did not move")
    _say("f", f"3 steps with the VGG base frozen: {sum(k.startswith('vgg.') for k in start)} vgg "
              f"tensors bit-identical, stage2_L1.conv1.weight moved by {moved:.3e}: pass")
    del start, tree
    torch.backends.cudnn.deterministic = False

    # --- g. one small train step, card against CPU -------------------------------
    small = PoseConfig(model=ModelConfig(boxsize=64, num_stages=2, compute_dtype="float32"),
                       augment=AugmentConfig(max_persons=3),
                       train=TrainConfig(batch_size=2, base_lr=1e-4))
    sbatch = next(synthetic_batches(small, 96, 96, seed=4))
    sdraws = gt_augment.batch_params(torch.Generator().manual_seed(4), small.augment, 2)
    for net_dtype in (torch.float32, torch.float64):
        model = OpenPose(num_stages=2, dtype=net_dtype, head_dtype=net_dtype)
        model.reset_parameters(torch.Generator().manual_seed(4))
        res = {}
        for d in ("cpu", "cuda"):
            state, tx = create_state(small, model.state_dict(), d)
            tree, losses = make_train_step(small, model, tx)(state.tree(), sdraws, sbatch)
            res[d] = ({k: float(v) for k, v in losses.items()},
                      {k: v.cpu() for k, v in tree["params"].items()})
        rel = max(abs(res["cuda"][0][k] / res["cpu"][0][k] - 1.0) for k in res["cpu"][0])
        dpar = max((res["cuda"][1][k] - v).abs().max().item() for k, v in res["cpu"][1].items())
        if not rel <= 1e-4:
            raise AssertionError(f"small step ({net_dtype}): losses differ by {rel} relative")
        if net_dtype == torch.float64 and not dpar <= 1e-5:
            raise AssertionError(f"small step (f64 network): parameters differ by {dpar}")
        _say("g", f"small train step, network in {str(net_dtype)[6:]}, card vs CPU: losses within "
                  f"{rel:.2e} relative (<= 1e-4), updated parameters within {dpar:.2e}"
                  + (" (<= 1e-5)" if net_dtype == torch.float64 else " (reported)") + ": pass")

    # --- e (training). steps/s and a device split at batch 10 ---------------------
    from torch.func import functional_call

    model = OpenPose(num_stages=fcfg.model.num_stages, dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    state, tx = create_state(clipped, model.state_dict(), "cuda")      # stays finite
    step_fn = make_train_step(clipped, model, tx, loss_denom=n_b)
    tree = state.tree()
    for i in range(2):
        tree, _ = step_fn(tree, step_generator(1, i), batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_timed = 8
    # six windows of 8 steps. The first, right after the 2 warm-up steps, is
    # shown apart; the figure is the median of the five that follow, because
    # on a host shared with other work single windows spread by more than
    # the metric's bound
    windows = []
    for win in range(6):
        t = time.perf_counter()
        for i in range(n_timed):
            tree, losses = step_fn(tree, step_generator(1, 2 + win * n_timed + i), batch)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t) / n_timed)
    first_s, windows = windows[0], windows[1:]
    step_s = sorted(windows)[len(windows) // 2]
    train_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    on_dev = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    args = (on_dev["images"].float(), on_dev["masks"].float() / 255.0, on_dev["joints"],
            on_dev["centers"], on_dev["scales"])
    with torch.no_grad():
        images_a, label_mask, joints_a = gt_augment.augment_batch(
            fixed, *args, fcfg.model, fcfg.augment)
        paf_gt, heat_gt = gt_rasterize.labels_for_config(joints_a, label_mask, fcfg.model,
                                                         fcfg.augment)
        aug_ms = _ms(torch, lambda: gt_augment.augment_batch(fixed, *args, fcfg.model,
                                                             fcfg.augment), 5)
        gt_ms = _ms(torch, lambda: gt_rasterize.labels_for_config(
            joints_a, label_mask, fcfg.model, fcfg.augment), 20)
    x_norm = image.normalize(images_a, fcfg.model.channel_order)
    grads = {}

    def fwd_bwd():
        leaves = {k: v.detach().requires_grad_() for k, v in tree["params"].items()}
        total = loss_lib.stagewise_losses(functional_call(model, leaves, (x_norm,)), paf_gt,
                                          heat_gt, label_mask, n_b)["total"]
        grads.update(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))

    # a second witness that the default recipe itself leaves the stable range
    # from this init: the same 5 f32 steps on the same targets with the
    # library's SGD and a loss written out here, neither of them the port's
    ref = OpenPose(num_stages=fcfg.model.num_stages, dtype=torch.float32)
    ref.reset_parameters(torch.Generator().manual_seed(0))
    ref.to(dev)
    named = dict(ref.named_parameters())
    mults, groups = multipliers(fcfg.train), {}
    for name, label in param_labels(named).items():
        groups.setdefault(label, []).append(named[name])
    sgd = torch.optim.SGD(
        [{"params": ps, "lr": fcfg.train.base_lr * mults[label],
          "weight_decay": 2.0 * fcfg.train.weight_decay if label.endswith("_w") else 0.0}
         for label, ps in groups.items()], lr=fcfg.train.base_lr, momentum=fcfg.train.momentum)
    m = label_mask[..., None]
    lib_totals = []
    for _ in range(5):
        sgd.zero_grad()
        total = sum(((p.float() * m - paf_gt) ** 2).sum() + ((h.float() * m - heat_gt) ** 2).sum()
                    for p, h in ref(x_norm)) / n_b / 2.0
        total.backward()
        sgd.step()
        lib_totals.append(float(total.detach()))
    gap = max(abs(a / b - 1.0) for a, b in zip(lib_totals[:4], f32_totals[:4]))
    if not (gap <= 5e-2 and lib_totals[-1] > 1e6 and f32_totals[-1] > 1e6):
        raise AssertionError(f"torch.optim.SGD went {lib_totals}, the trainer {f32_totals}")
    _say("f", "the default recipe in float32 with torch.optim.SGD and a written-out loss: total "
              + " -> ".join(f"{t:.6g}" for t in lib_totals) + f": within {gap:.1e} relative of "
              f"the trainer's first 4 steps (<= 5e-2), and it too ends above 1e6: pass")
    del ref, sgd, named, groups

    fb_ms = _ms(torch, fwd_bwd, 5)
    upd_ms = _ms(torch, lambda: tx.update(grads, tree["opt_state"], tree["params"]), 5)
    _say("e", f"training, batch {n_b}, bf16, clip_norm 5.0: {1.0 / step_s:.3f} steps/s, "
              f"{step_s * 1e3:.2f} ms per step (host clock, median of {len(windows)} windows of "
              f"{n_timed} steps: {' / '.join(f'{v * 1e3:.2f}' for v in windows)} ms in order, "
              f"after a first window of {first_s * 1e3:.2f} ms); device ms: augment {aug_ms:.3f}, GT kernel "
              f"{gt_ms:.4f}, forward + backward {fb_ms:.2f}, update {upd_ms:.3f}; peak memory "
              f"{train_gb:.2f} GiB ({card})")

    print("the timings and the training path once more, for a reader of the last lines:",
          flush=True)
    for line in [line for line in _SAID if line[:3] in ("[e]", "[f]", "[h]")]:
        print(line, flush=True)
    kernels = []
    for kern in ops.KERNELS:
        kernels.append({"name": kern.name, "route": "cuda", "source": kern.source,
                        "replaces": kern.replaces,
                        "launches": (counts_infer[kern.name] + counts_train[kern.name]
                                     + counts_full[kern.name] + counts_serve[kern.name]),
                        **record[kern.name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _cli() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR", help="a checkout of an earlier commit: time "
                    "its block1, sample, pyramid_peaks and peaks kernels beside this checkout's")
    ap.add_argument("--kernel-times-of", nargs=2, metavar=("DIR", "DATA"),
                    help="print the redesigned kernels' times of the checkout under DIR as JSON "
                    "(what --parent runs)")
    args = ap.parse_args()
    if args.kernel_times_of:
        import numpy as np
        import torch

        if not torch.cuda.is_available():
            print("chip_smoke: torch sees no CUDA device; nothing was run", file=sys.stderr)
            return 1
        root, data_path = args.kernel_times_of
        sys.path.insert(0, root)
        print(json.dumps(_redesigned_times(torch, np, data_path)), flush=True)
        return 0
    return main(args.parent)


if __name__ == "__main__":
    sys.exit(_cli())
