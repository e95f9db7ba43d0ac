"""Offline batched inference in a closed loop: ``PoseEstimator.stream``.

Parameters (the workload's ``traffic``): ``height``, ``width`` of the
frames, ``batch``, ``depth`` (batches in flight), ``pool_batches`` (the
seeded frames are rendered once, ``batch * pool_batches`` of them, and the
window cycles through them), ``max_persons`` per scene; ``trace_seconds``
of the traced sub-window. ``check``: ``batches`` sampled from the window,
``match_px``, ``short_share`` and ``short_floor`` (``checks.people``).

``images_per_s``: images whose people reached the host inside the window,
over the time from the window's start to the last of them.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from posebench import port, scenes, weights
from posebench.checks import sample
from posebench.checks.people import Tally
from posebench.reference import decode as ref_decode
from posebench.reference import model as ref_model
from posebench.trace import WINDOW, nospan, profiled

SPANS = ("feed.next", "stream.next")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def inputs(ctx):
    """The seeded weights (heads scaled) and the frame pool as host batches."""
    tr, m = ctx.cell["traffic"], ctx.config["model"]
    b, n = tr["batch"], tr["pool_batches"]
    params = weights.make(ctx.seed, ctx.device, m["num_stages"])
    frames = scenes.frames(ctx.seed, b * n, tr["height"], tr["width"], tr["max_persons"],
                           ctx.device)
    weights.scale_heads(params, frames[0], ctx.config)
    host = frames.cpu().numpy()
    return params, [host[i * b:(i + 1) * b] for i in range(n)]


class Window:
    """What a window of the stream leaves: the batches that reached the
    host inside it (their count and the last one's arrival) and a sample of
    their answers, ``keep`` of them drawn from ``seed`` as they arrive
    (reservoir sampling: the harness holds no more answers than it
    checks)."""

    def __init__(self, keep: int, seed: int):
        self.keep = keep
        self.rng = np.random.default_rng([seed, 0x5EED])
        self.kept: list[tuple[int, list]] = []
        self.inside = self.total = 0
        self.start = self.deadline = self.last = None

    def arrived(self, pool_index: int, people: list, t: float) -> None:
        self.total += 1
        if t > self.deadline:
            return
        self.inside += 1
        self.last = t
        if len(self.kept) < self.keep:
            self.kept.append((pool_index, people))
        else:
            j = int(self.rng.integers(0, self.inside))
            if j < self.keep:
                self.kept[j] = (pool_index, people)


def window(est, pool, seconds: float, depth: int, keep: int = 0, seed: int = 0,
           span=nospan) -> Window:
    """Streams the pool round and round until ``seconds`` have passed."""
    w = Window(keep, seed)

    def feed():
        i = 0
        while True:
            with span("feed.next"):
                if time.perf_counter() >= w.deadline:
                    return
                batch = pool[i % len(pool)]
            yield batch
            i += 1

    w.start = time.perf_counter()
    w.deadline = w.start + seconds
    it = est.stream(feed(), depth=depth)
    k = 0
    while True:
        with span("stream.next"):
            people = next(it, None)
        if people is None:
            break
        w.arrived(k % len(pool), people, time.perf_counter())
        k += 1
    return w


def reference_people(params, config: dict, images: np.ndarray, device, precision=None):
    """The reference's (people per image, averaged heat, averaged PAF) of
    one batch, in the configuration's precision or ``precision``."""
    m, inf = config["model"], config["inference"]
    ref_model.no_tf32()
    net = ref_model.Net(params, precision or m["compute_dtype"], m["num_stages"])
    with torch.no_grad():
        heat, paf = ref_model.averaged_maps(net, torch.from_numpy(images).to(device),
                                            inf["scale_search"], m["boxsize"], m["stride"])
        people = ref_decode.decode_batch(heat, paf, inf)
    return people, heat, paf


def tally(params, config: dict, cell: dict, answers, pool, device) -> Tally:
    """``answers``: [(pool index, people per image)] of the program ->
    the ``checks.people`` tally of them against the reference."""
    t = Tally(config["inference"], cell["check"])
    for p, got in answers:
        want, heat, paf = reference_people(params, config, pool[p], device)
        for i in range(len(got)):
            t.add(got[i], want[i], heat[i].cpu().numpy(), paf[i].cpu().numpy())
        del heat, paf
    return t


def readings(t: Tally) -> dict:
    """The numbers, and each image's people on both sides, for the
    readings that set the limits."""
    return dict(t.numbers(), per_image=t.per_image)


def control(ctx, precision: str = "fp8") -> dict:
    """The control: the reference computed in ``precision`` in the
    program's place, on the pool batches a run of this seed would sample."""
    params, pool = inputs(ctx)
    picks = sample(ctx.seed, len(pool), ctx.cell["check"]["batches"])
    answers = [(p, reference_people(params, ctx.config, pool[p], ctx.device, precision)[0])
               for p in picks]
    return readings(tally(params, ctx.config, ctx.cell, answers, pool, ctx.device))


def program_readings(ctx) -> dict:
    """The program's answers on the pool batches a run of this seed would
    sample, through ``stream`` at the cell's batch and depth, compared as a
    run compares them."""
    depth = ctx.cell["traffic"]["depth"]
    params, pool = inputs(ctx)
    picks = sample(ctx.seed, len(pool), ctx.cell["check"]["batches"])
    est = port.estimator(ctx.config, params, ctx.device)
    answers = list(zip(picks, est.stream(iter([pool[p] for p in picks]), depth=depth)))
    del est
    return readings(tally(params, ctx.config, ctx.cell, answers, pool, ctx.device))


def run(ctx):
    from posebench.run import Result

    tr = ctx.cell["traffic"]
    depth, b = tr["depth"], tr["batch"]
    params, pool = inputs(ctx)
    est = port.estimator(ctx.config, params, ctx.device)
    for _ in est.stream(iter(pool[:depth + 2]), depth=depth):
        pass
    _sync(ctx.device)
    setup_s = time.perf_counter() - ctx.t0

    gc.collect()
    w = window(est, pool, ctx.seconds, depth, ctx.cell["check"]["batches"], ctx.seed)
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
            _sync(ctx.device)
            gc.collect()
            with span(WINDOW):
                tw = window(est, pool, tr["trace_seconds"], depth, span=span)
                _sync(ctx.device)
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
