"""Runs one cell once and prints one JSON line.

    python3 -m posebench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights and inputs from the seed, the program built and every
shape the cell runs warmed up) is timed from the start of this module to
the start of the measured window (``setup_s``). Then the window runs for
``--seconds`` with tracing off; with ``--trace 1`` a steady sub-window
under ``torch.profiler`` follows and the per-layer metrics are printed in
place of the end-to-end ones. Last, the program's state is freed and a
sample of its answers is compared with the plain reference; each number
compared is printed beside its limit, on standard error and under
``checks`` in the result line.

Exits non-zero, printing no result, without the CUDA devices the cell
asks for, or when a JAX module is loaded in this process once the window
has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

from posebench import manifest  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tpupose")


@dataclasses.dataclass
class Context:
    """What a traffic driver is given."""

    cell_name: str
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float


@dataclasses.dataclass
class Result:
    """What a traffic driver returns."""

    e2e: dict                    # end-to-end metric name -> value
    attempted: int
    failed: int
    memory_peak_bytes: int
    numbers: dict                # compared number -> value
    trace: object = None         # posebench.trace.Trace of the traced run
    info: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class MetricInput:
    """What a per-layer metric's reader reads."""

    cell_name: str
    cell: dict
    config: dict
    e2e: dict
    trace: object
    info: dict


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each limited number beside its limit: ``{"max": x}`` holds it at or
    under x, ``{"min": x}`` at or over x. A number missing or not finite
    fails."""
    ok, shown = True, {}
    for name, rule in limits.items():
        value = numbers.get(name)
        (kind, limit), = rule.items()
        good = value is not None and math.isfinite(value) and (
            value <= limit if kind == "max" else value >= limit)
        ok = ok and good
        shown[name] = {"value": value, "limit": limit, "rule": "<=" if kind == "max" else ">="}
    return ok, shown


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def keep_tensorflow_out() -> None:
    """The trainer's logger imports tensorboard where it is installed, and
    tensorboard imports TensorFlow, which loads JAX; without TensorFlow,
    tensorboard writes the same event files through its own stub."""
    sys.modules.setdefault("tensorflow", None)


def main(argv=None) -> int:
    keep_tensorflow_out()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = manifest.benchmark()
    entry = manifest.cell_entry(bench, args.workload)
    cell = manifest.workload(args.workload)
    config = manifest.config(cell["config"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"posebench: the cell needs {entry['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = Context(args.workload, cell, config, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda", 0), T0)
    result = manifest.traffic(cell["traffic"]["kind"]).run(ctx)
    return report(bench, ctx, result)


def report(bench: dict, ctx: Context, result: Result, out=None) -> int:
    """Prints the checks on standard error and the result line on ``out``."""
    import torch

    out = out or sys.stdout
    found = loaded_forbidden()
    if found:
        print(f"posebench: the process loaded {found}", file=sys.stderr)
        return 3
    metrics = {}
    if ctx.trace:
        inp = MetricInput(ctx.cell_name, ctx.cell, ctx.config, result.e2e, result.trace,
                          result.info)
        for m in manifest.metrics_of(bench, ctx.cell_name, traced=True):
            value = manifest.reader(m["name"]).read(inp)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in manifest.metrics_of(bench, ctx.cell_name, traced=False):
            if m["name"] in result.e2e:
                metrics[m["name"]] = {"value": result.e2e[m["name"]], "unit": m["unit"]}
    correct, checks = judge(result.numbers, ctx.cell["limits"])
    on_cuda = getattr(ctx.device, "type", "cpu") == "cuda"
    device = {"platform": "gpu" if on_cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
              "count": 1, "memory_peak_bytes": result.memory_peak_bytes}
    line = {"correct": correct, "attempted": result.attempted, "failed": result.failed,
            "metrics": metrics, "device": device}
    if ctx.trace and result.trace is not None:
        device["busy_s"] = result.trace.busy_s
        device["window_s"] = result.trace.window_s
        line["breakdown"] = result.trace.breakdown()
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} {c['rule']} {c['limit']}", file=sys.stderr)
    print(f"correct: {correct}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
