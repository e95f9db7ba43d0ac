"""Domain-adaptation finetuning: ``training.loop.train`` over a ``.tpr``.

Parameters (the workload's ``traffic``): ``scenes`` seeded square frames
of ``size`` with 1 to ``max_persons`` people, one record a person,
written at set-up as a pre-padded ``.tpr`` under ``TMPDIR`` and fed by
``TprBatches`` (``threads`` inflate threads, shuffled from the seed);
``trace_seconds`` of the traced sub-window.

``train()`` keeps its state inside the call; the one hand-over it offers
is its own resume path. So set-up runs it to step 1 and on to step 3 (each
call ends with a checkpoint of the step, which the next call restores),
reads the state each call returns for the check, and the window is a
third call that resumes at step 3. Its first step's loss, which ``train``
hands to ``on_step``, is compared too: the reference goes on from its own
step 3 on the batch the window was fed. The window's later steps and its
parameters are not compared: ``train`` hands out no state until its loop
has ended. The feed handed to ``train`` closes the window: at the first
``next()`` after ``--seconds`` it synchronises the device and ends the
feed, so the final checkpoint that ``train`` writes after its loop falls
outside the window.

``train_samples_per_s``: samples of the steps fed inside the window (all
finished on the device at its close) over the window's seconds.
"""

from __future__ import annotations

import gc
import math
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from posebench import port, scenes, weights
from posebench.reference import train as ref_train
from posebench.trace import WINDOW, nospan, profiled

SPANS = ("feed.next", "train")
FIRST_STEPS = 3
WINDOW_STEP = FIRST_STEPS + 1        # the window call's first step


class Feed:
    """Wraps the program's feed: keeps copies of the first batches, times
    each ``next()`` and, once ``open_window`` was called, ends the feed at
    the first ``next()`` after the window's length."""

    def __init__(self, inner, device, keep: int = WINDOW_STEP):
        self.inner = inner
        self.device = device
        self.keep = keep
        self.kept: list[dict] = []
        self.span = nospan
        self.seconds = None

    def open_window(self, seconds: float, span=nospan) -> None:
        """The window opens at the next ``next()``; with a recording
        ``span`` it is marked as the traced window."""
        self.seconds = seconds
        self.span = span
        self.start = self.end = None
        self.steps = 0
        self.wait = 0.0
        self.mark = None

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self.seconds is not None:
            now = time.perf_counter()
            if self.start is None:
                if self.span is not nospan:
                    self.mark = self.span(WINDOW)
                    self.mark.__enter__()
                self.start = time.perf_counter()
            elif now - self.start >= self.seconds:
                if torch.device(self.device).type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.end = time.perf_counter()
                if self.mark is not None:
                    self.mark.__exit__(None, None, None)
                self.seconds = None
                raise StopIteration
        t = time.perf_counter()
        with self.span("feed.next"):
            batch = next(self.inner)
        if self.seconds is not None:
            self.wait += time.perf_counter() - t
            self.steps += 1
        if len(self.kept) < self.keep:
            self.kept.append({k: np.array(v, copy=True) for k, v in batch.items()})
        return batch


def _rows(kept: list[dict], records: list[dict], device) -> tuple[list[dict], int]:
    """The benchmark's own records of each kept batch, found by their
    centre and scale; the count of rows whose image or joints differ from
    the record's."""
    index = {(np.float32(r["center"][0]), np.float32(r["center"][1]),
              np.float32(r["scale_provided"])): r for r in records}
    out, wrong = [], 0
    for batch in kept:
        rows = []
        for i in range(batch["images"].shape[0]):
            key = (np.float32(batch["centers"][i][0]), np.float32(batch["centers"][i][1]),
                   np.float32(batch["scales"][i]))
            r = index.get(key)
            if r is None or not np.array_equal(batch["images"][i], r["image"]):
                wrong += 1
                r = r or records[0]
            rows.append(r)
        p = batch["joints"].shape[1]
        joints = np.full((len(rows), p, 18, 3), 2.0, np.float32)
        for i, r in enumerate(rows):
            joints[i, :len(r["joints"])] = r["joints"]
            wrong += int(not np.array_equal(batch["joints"][i], joints[i]))
        out.append({
            "images": torch.from_numpy(np.stack([r["image"] for r in rows])).to(device),
            "masks": torch.from_numpy(np.stack([r["mask"] for r in rows])).to(device),
            "joints": torch.from_numpy(joints).to(device),
            "centers": torch.tensor([r["center"] for r in rows], dtype=torch.float32,
                                    device=device),
            "scales": torch.tensor([r["scale_provided"] for r in rows], dtype=torch.float32,
                                   device=device)})
    return out, wrong


def reference_run(params, config: dict, batches: list[dict], seed: int, precision=None):
    """The reference's losses of every kept step, its first gradient (as
    the optimizer got it, and the raw norms), its parameters after step
    ``FIRST_STEPS`` and the trainer, from the benchmark's weights and
    records."""
    trainer = ref_train.Trainer(params, config, precision)
    losses, first, third = [], None, None
    for step, batch in enumerate(batches):
        d = ref_train.draws(ref_train.step_generator(seed, step), config["augment"],
                            batch["images"].shape[0])
        loss, got, raw = trainer.step(batch, d)
        losses.append(loss)
        if first is None:
            first = (got, raw)
        if step + 1 == FIRST_STEPS:
            third = dict(trainer.p)
    return losses, first, third, trainer


def compare(params0, program: dict, ref_losses, ref_first, ref_third, ref_trainer,
            wrong_rows: int) -> dict:
    """The numbers of the train check (see the workload's limits). A leaf
    counts where the reference's raw first gradient is at least a
    thousandth of the median leaf's (below, round-off alone moves it)."""
    ref_first, raw_grad_norms = ref_first
    trained = list(ref_trainer.trace)
    median = float(np.median([raw_grad_norms[k] for k in trained]))
    moving = [k for k in trained if raw_grad_norms[k] >= 1e-3 * median]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(program["losses"], ref_losses))
    want_window = ref_losses[WINDOW_STEP - 1]
    window_loss_gap = (math.inf if program["window_loss"] is None
                       else abs(program["window_loss"] - want_window) / abs(want_window))
    grad_gap, _ = ref_train.leaf_gap(program["first"], ref_first, moving)
    change = {k: program["params"][k] - params0[k] for k in moving}
    want = {k: ref_third[k] - params0[k] for k in moving}
    update_gap, _ = ref_train.leaf_gap(change, want, moving)
    frozen = [k for k in params0 if k not in ref_trainer.trace]
    frozen_moved = max((float((program["params"][k] - params0[k]).abs().max()) for k in frozen),
                       default=0.0)
    return {"loss_gap": loss_gap, "window_loss_gap": window_loss_gap, "grad_gap": grad_gap,
            "update_gap": update_gap, "frozen_moved": frozen_moved,
            "feed_rows_wrong": float(wrong_rows), "leaves_compared": float(len(moving))}


class Setup:
    """The records, the feed, the weights and the program's state after
    its first steps, in the workdir under a temporary directory."""

    def __init__(self, ctx):
        tr, config = ctx.cell["traffic"], ctx.config
        self.cfg = port.pose_config(config)
        self.tmp = tempfile.mkdtemp(prefix="posebench-train-")
        dev = ctx.device
        self.records = scenes.records(ctx.seed, tr["scenes"], tr["size"], tr["max_persons"], dev)
        path = os.path.join(self.tmp, "scenes.tpr")
        port.write_tpr(path, self.records, config["augment"]["max_persons"])
        self.feed = Feed(port.tpr_feed(path, self.cfg, ctx.seed % (1 << 31), tr["threads"]), dev)
        self.params0 = weights.make(ctx.seed, dev, config["model"]["num_stages"])
        self.workdir = os.path.join(self.tmp, "run")
        losses = {}

        def on_step(step, logged):
            losses[step] = logged["total"]

        first = self.train(ctx, 1, on_step)
        trace1 = {k: v.detach().clone() for k, v in first["state"]["opt_state"]["trace"].items()}
        third = self.train(ctx, FIRST_STEPS, on_step)
        losses[FIRST_STEPS] = third["last_losses"]["total"]
        self.program = {"losses": [losses[s] for s in range(1, FIRST_STEPS + 1)],
                        "first": trace1,
                        "params": {k: v.detach().clone()
                                   for k, v in third["state"]["params"].items()},
                        "window_loss": None}

    def window_step(self, step: int, logged: dict) -> None:
        """``on_step`` of the window's call: keeps its first step's loss."""
        if step == WINDOW_STEP:
            self.program["window_loss"] = logged["total"]

    def train(self, ctx, max_steps: int, on_step=None) -> dict:
        return port.train(self.cfg, self.feed, self.params0, self.workdir, max_steps, ctx.seed,
                          ctx.device, on_step)

    def check(self, ctx, program: dict | None = None) -> dict:
        """Closes the feed, frees the program's memory and compares
        ``program`` (default: the program's own first steps)."""
        self.feed.inner.close()
        gc.collect()
        if torch.device(ctx.device).type == "cuda":
            torch.cuda.empty_cache()
        batches, wrong = _rows(self.feed.kept, self.records, ctx.device)
        ref_losses, ref_first, ref_third, trainer = reference_run(
            self.params0, ctx.config, batches, ctx.seed)
        if program is None:
            program = self.program
        elif callable(program):
            program = program(batches)
        return compare(self.params0, program, ref_losses, ref_first, ref_third, trainer, wrong)

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)


def program_readings(ctx) -> dict:
    """The program's first steps compared, without a measured window: the
    third call, which resumes at step 3 as the window's does, runs one
    step."""
    s = Setup(ctx)
    try:
        s.train(ctx, WINDOW_STEP, s.window_step)
        return s.check(ctx)
    finally:
        s.close()


def control(ctx, precision: str = "fp8") -> dict:
    """The reference computed in ``precision`` in the program's place, on
    the batches the program's feed handed out."""
    s = Setup(ctx)
    try:
        next(s.feed)                   # the batch of the window's first step

        def lower(batches):
            losses, first, third, _ = reference_run(s.params0, ctx.config, batches, ctx.seed,
                                                    precision)
            return {"losses": losses[:FIRST_STEPS], "window_loss": losses[FIRST_STEPS],
                    "first": first[0], "params": third}
        return s.check(ctx, lower)
    finally:
        s.close()


def run(ctx):
    from posebench.run import Result

    tr = ctx.cell["traffic"]
    s = Setup(ctx)
    try:
        setup_s = time.perf_counter() - ctx.t0
        b = s.cfg.train.batch_size
        gc.collect()
        s.feed.open_window(ctx.seconds)
        s.train(ctx, 1 << 40, s.window_step)
        steps = s.feed.steps
        e2e = {"train_samples_per_s": steps * b / (s.feed.end - s.feed.start),
               "setup_s": setup_s}
        peak = (torch.cuda.max_memory_allocated(ctx.device)
                if torch.device(ctx.device).type == "cuda" else 0)
        trace = None
        if ctx.trace:
            def traced(span):
                s.feed.open_window(tr["trace_seconds"], span)
                s.train(ctx, 1 << 40)
                return {"steps": s.feed.steps, "feed_wait_s": s.feed.wait,
                        "samples": s.feed.steps * b}
            trace = profiled(traced, SPANS)
        numbers = s.check(ctx)
    finally:
        s.close()
    return Result(e2e=e2e, attempted=steps * b, failed=0, memory_peak_bytes=peak,
                  numbers=numbers, trace=trace,
                  info={"train_samples_per_s": e2e["train_samples_per_s"]})
