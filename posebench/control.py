"""Readings that set the limits of a cell's output check.

    python3 -m posebench.control --workload <cell> --seeds <n> ... [--program [--fault F]]

Without ``--program``: the control, the reference computed one precision
below the configuration's (``--precision``, default fp8) in the program's
place. With ``--program``: the program's own answers through the timed
entry at the cell's batch and depth, on the batches a run of the seed
samples, without a measured window; with ``--fault half_batch`` as well,
the program answers every other image of a batch with nobody (the fault
that ``short_images`` has to catch). One JSON line per seed; many seeds
share one process, so the set-up of the process is paid once.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--precision", default="fp8")
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--fault", choices=("half_batch",), default=None)
    args = ap.parse_args(argv)

    import torch

    from posebench import manifest
    from posebench.run import Context, keep_tensorflow_out

    keep_tensorflow_out()
    if not torch.cuda.is_available():
        print("posebench.control: no CUDA device", file=sys.stderr)
        return 2
    if args.fault:
        from posebench import port

        port.empty_every_other_image()
    cell = manifest.workload(args.workload)
    config = manifest.config(cell["config"])
    driver = manifest.traffic(cell["traffic"]["kind"])
    for seed in args.seeds:
        ctx = Context(args.workload, cell, config, seed, 0.0, False, torch.device("cuda", 0),
                      time.perf_counter())
        numbers = driver.program_readings(ctx) if args.program else driver.control(
            ctx, args.precision)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": ("program" if args.program else args.precision)
                          + (f"+{args.fault}" if args.fault else ""),
                          "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
