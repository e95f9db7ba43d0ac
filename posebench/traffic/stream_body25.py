"""Offline batched inference of OpenPose BODY_25 in a closed loop:
``PoseEstimator(arch="body25").stream``.

The traffic, the window, the trace and the sampled check are the ``stream``
kind's (``traffic/stream.py``: the same parameters and the same
``images_per_s``); what names a BODY_25 layer, part or limb is here: the
seeded weights and their calibration, the estimator, the reference's
people and the tally over BODY_25's tables (``checks/people_body25.py``).

Weights: every kernel lecun-normal (as ``weights.make``: one
``trunc_normal_`` call on one flat tensor with a generator on the device,
rescaled to unit variance, times sqrt(1 / fan_in)), every bias zero, every
PReLU slope 0.25; the last PAF stage's and the last heat stage's Mconv7
(``stage3_L2``, ``stage1_L1``) recentred and scaled by the configuration's
``calibration`` on the reference's maps of the first frame at scale 1.0,
as ``weights.scale_heads`` does for COCO.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from posebench import port, scenes
from posebench.checks import sample
from posebench.checks.people_body25 import Tally
from posebench.reference import body25 as ref
from posebench.reference import model as ref_model
from posebench.trace import WINDOW, profiled
from posebench.traffic import stream

SPANS = stream.SPANS
_TRUNC_STD = 0.87962566103423978


def make_params(seed: int, device) -> dict[str, torch.Tensor]:
    """State-dict-named f32 tensors of BODY_25, (O, I, kh, kw) kernels."""
    table = ref.layer_table()
    convs = [t for t in table if len(t) == 4]
    sizes = [cout * cin * k * k for _, cin, cout, k in convs]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    params, off = {}, 0
    for (name, cin, cout, k), n in zip(convs, sizes):
        std = math.sqrt(1.0 / (cin * k * k)) / _TRUNC_STD
        params[f"{name}.weight"] = (flat[off:off + n] * std).view(cout, cin, k, k)
        params[f"{name}.bias"] = torch.zeros(cout, dtype=torch.float32, device=device)
        off += n
    for name, channels in (t for t in table if len(t) == 2):
        params[f"{name}.slope"] = torch.full((channels,), ref.SLOPE_INIT, device=device)
    return params


@torch.no_grad()
def scale_heads(params: dict[str, torch.Tensor], frame: torch.Tensor, config: dict) -> dict:
    """``weights.scale_heads`` for BODY_25's last PAF and heat heads."""
    m, cal = config["model"], config["calibration"]
    ref_model.no_tf32()
    net = ref.Net(params, m["compute_dtype"])
    h, w = frame.shape[:2]
    (rh, rw, ph, pw), = ref_model.scale_sizes(h, w, (1.0,), m["boxsize"], m["stride"])
    x = ref_model.resize(ref_model.normalize(frame[None]), rh, rw)
    x = torch.nn.functional.pad(x, (0, 0, 0, pw - rw, 0, ph - rh))
    paf, heat = net.last(x)
    factors = {}
    for scope, maps, target, used in (("stage1_L1", heat, cal["heat"], slice(0, -1)),
                                      ("stage3_L2", paf, cal["paf"], slice(None))):
        flat = maps.reshape(-1, maps.shape[-1])
        shift = flat.median(dim=0).values if cal["center"] else torch.zeros_like(flat[0])
        level = torch.quantile((flat - shift)[:, used].abs().flatten(), cal["quantile"])
        f = float(target / level)
        params[f"{scope}.Mconv7_{scope}.weight"].mul_(f)
        params[f"{scope}.Mconv7_{scope}.bias"].sub_(shift).mul_(f)
        factors[scope] = f
    return factors


def inputs(ctx):
    """The seeded weights (heads scaled) and the frame pool as host batches."""
    tr = ctx.cell["traffic"]
    b, n = tr["batch"], tr["pool_batches"]
    params = make_params(ctx.seed, ctx.device)
    frames = scenes.frames(ctx.seed, b * n, tr["height"], tr["width"], tr["max_persons"],
                           ctx.device)
    scale_heads(params, frames[0], ctx.config)
    host = frames.cpu().numpy()
    return params, [host[i * b:(i + 1) * b] for i in range(n)]


def estimator(config: dict, params: dict[str, torch.Tensor], device):
    """``PoseEstimator(arch="body25")`` over the benchmark's weights, as the
    nested ``{scope: {layer: {kernel, bias} | {slope}}}`` tree it takes."""
    from tpupose_torch.infer import PoseEstimator

    tree: dict = {}
    for key, value in params.items():
        scope, layer, leaf = key.split(".")
        arr = value.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            leaf, arr = "kernel", np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
        tree.setdefault(scope, {}).setdefault(layer, {})[leaf] = arr.copy()
    return PoseEstimator(port.pose_config(config), params=tree, device=device, arch="body25")


def reference_people(params, config: dict, images: np.ndarray, device, precision=None):
    """The reference's (people per image, averaged heat, averaged PAF) of
    one batch, in the configuration's precision or ``precision``."""
    m, inf = config["model"], config["inference"]
    ref_model.no_tf32()
    net = ref.Net(params, precision or m["compute_dtype"])
    with torch.no_grad():
        heat, paf = ref_model.averaged_maps(net, torch.from_numpy(images).to(device),
                                            inf["scale_search"], m["boxsize"], m["stride"])
        people = ref.decode_batch(heat, paf, inf)
    return people, heat, paf


def tally(params, config: dict, cell: dict, answers, pool, device) -> Tally:
    """``answers``: [(pool index, people per image)] of the program -> the
    ``checks.people_body25`` tally of them against the reference."""
    t = Tally(config["inference"], cell["check"])
    for p, got in answers:
        want, heat, paf = reference_people(params, config, pool[p], device)
        for i in range(len(got)):
            t.add(got[i], want[i], heat[i].cpu().numpy(), paf[i].cpu().numpy())
        del heat, paf
    return t


def control(ctx, precision: str = "fp8") -> dict:
    """The reference computed in ``precision`` in the program's place, on
    the pool batches a run of this seed would sample."""
    params, pool = inputs(ctx)
    picks = sample(ctx.seed, len(pool), ctx.cell["check"]["batches"])
    answers = [(p, reference_people(params, ctx.config, pool[p], ctx.device, precision)[0])
               for p in picks]
    return stream.readings(tally(params, ctx.config, ctx.cell, answers, pool, ctx.device))


def program_readings(ctx) -> dict:
    """The program's answers on the pool batches a run of this seed would
    sample, through ``stream`` at the cell's batch and depth."""
    depth = ctx.cell["traffic"]["depth"]
    params, pool = inputs(ctx)
    picks = sample(ctx.seed, len(pool), ctx.cell["check"]["batches"])
    est = estimator(ctx.config, params, ctx.device)
    answers = list(zip(picks, est.stream(iter([pool[p] for p in picks]), depth=depth)))
    del est
    return stream.readings(tally(params, ctx.config, ctx.cell, answers, pool, ctx.device))


def run(ctx):
    from posebench.run import Result

    tr = ctx.cell["traffic"]
    depth, b = tr["depth"], tr["batch"]
    params, pool = inputs(ctx)
    est = estimator(ctx.config, params, ctx.device)
    for _ in est.stream(iter(pool[:depth + 2]), depth=depth):
        pass
    stream._sync(ctx.device)
    setup_s = time.perf_counter() - ctx.t0

    gc.collect()
    w = stream.window(est, pool, ctx.seconds, depth, ctx.cell["check"]["batches"], ctx.seed)
    if not w.inside:
        raise RuntimeError("no batch finished inside the window")
    e2e = {"images_per_s": w.inside * b / (w.last - w.start), "setup_s": setup_s}
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if torch.device(ctx.device).type == "cuda" else 0)

    trace = None
    if ctx.trace:
        def traced(span):
            for _ in est.stream(iter(pool[:2]), depth=depth):
                pass
            stream._sync(ctx.device)
            gc.collect()
            with span(WINDOW):
                tw = stream.window(est, pool, tr["trace_seconds"], depth, span=span)
                stream._sync(ctx.device)
            return {"images": tw.total * b}
        trace = profiled(traced, SPANS)

    del est
    gc.collect()
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()
    numbers = tally(params, ctx.config, ctx.cell, w.kept, pool, ctx.device).numbers()
    return Result(e2e=e2e, attempted=w.total * b, failed=0, memory_peak_bytes=peak,
                  numbers=numbers, trace=trace,
                  info={"images_per_s": e2e["images_per_s"]})
