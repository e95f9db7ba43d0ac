"""Runs cells several times in one call, each run a process of its own.

    python3 -m posebench.series [--out FILE] CELL:SEED:SECONDS:TRACE ...

Prints, per run, its exit code, wall seconds, the last line of its
standard output and the last lines of its standard error (the checks),
and appends one JSON object per run to ``--out``. The card's name and
power limit come first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=float, default=1200)
    ap.add_argument("runs", nargs="+", help="CELL:SEED:SECONDS:TRACE")
    args = ap.parse_args(argv)
    print(f"card: {card()}", flush=True)
    worst = 0
    for spec in args.runs:
        cell, seed, seconds, trace = spec.split(":")
        cmd = [sys.executable, "-m", "posebench.run", "--workload", cell, "--seed", seed,
               "--seconds", seconds, "--trace", trace]
        t = time.perf_counter()
        try:
            p = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout)
            rc, out, err = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = 124, e.stdout or "", e.stderr or ""
            out = out.decode() if isinstance(out, bytes) else out
            err = err.decode() if isinstance(err, bytes) else err
        wall = time.perf_counter() - t
        lines = out.strip().splitlines()
        last = lines[-1] if lines else ""
        tail = err.strip().splitlines()[-12:]
        print(f"== {spec} rc={rc} wall={wall:.1f}s", flush=True)
        print(last, flush=True)
        for line in tail:
            print(f"   {line}", flush=True)
        if args.out:
            try:
                parsed = json.loads(last)
            except json.JSONDecodeError:
                parsed = None
            with open(args.out, "a") as f:
                f.write(json.dumps({"spec": spec, "rc": rc, "wall_s": wall, "result": parsed,
                                    "stderr_tail": err[-4000:]}) + "\n")
        worst = max(worst, rc)
    return worst


if __name__ == "__main__":
    sys.exit(main())
