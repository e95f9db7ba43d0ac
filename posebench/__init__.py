"""posebench: the benchmark of ``tpupose_torch`` on one NVIDIA H100.

One command runs one cell once and prints one JSON line:

    python3 -m posebench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: ``configs/<config>.json``,
``workloads/<cell>.json`` (the traffic mix and the limits of its output
check), ``traffic/<kind>.py`` (the generator and driver of a kind of
traffic) and ``metrics/<metric>.py`` (the reader of a per-layer metric).
``reference/`` is the plain PyTorch reference that decides ``correct``; it
imports nothing of the program.
"""
