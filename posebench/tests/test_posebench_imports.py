"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program; top-level module names are
compared whole (``tpupose_torch`` is not ``tpupose``)."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from posebench import manifest
from posebench.run import FORBIDDEN

SOURCES = sorted(
    os.path.join(d, f) for d, _, files in os.walk(manifest.HERE) for f in files
    if f.endswith(".py") and os.sep + "tests" not in d)
REFERENCE = [p for p in SOURCES if os.sep + "reference" + os.sep in p
             or os.path.basename(p) in ("flops.py", "scenes.py", "weights.py", "classes.py")]


def _top_level_imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, manifest.ROOT))
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = {n.split(".")[0] for n in _top_level_imports(path)}
    assert not tops & set(FORBIDDEN)


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: os.path.relpath(p, manifest.ROOT))
def test_reference_imports_nothing_of_the_program(path):
    names = _top_level_imports(path)
    assert not {n for n in names if n.split(".")[0] == "tpupose_torch"}
    assert "posebench.port" not in names


def test_a_run_process_loads_no_jax():
    code = ("import sys, posebench.run, posebench.traffic.stream, posebench.traffic.train, "
            "tpupose_torch.infer, tpupose_torch.training.loop, tpupose_torch.data.pipeline\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & set(%r)))" % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=manifest.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=manifest.ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
