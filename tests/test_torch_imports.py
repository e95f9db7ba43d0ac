"""The port stands alone: it imports nothing of the JAX package nor of
jax/flax/optax/orbax, and its own copies of the reference's numpy-only
modules (config, topology, drawing) cannot drift from them.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

import tpupose.config as jconfig
import tpupose.topology as jtopology
import tpupose.utils.drawing as jdrawing
import tpupose_torch.config as tconfig
import tpupose_torch.topology as ttopology
import tpupose_torch.utils.drawing as tdrawing
from tpupose_torch.ops import block1 as block1_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"tpupose", "jax", "jaxlib", "flax", "optax", "orbax"}


def port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for folder, _, names in os.walk(os.path.join(ROOT, "tpupose_torch")):
        files += [os.path.join(folder, n) for n in names if n.endswith(".py")]
    return sorted(files)


def imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_of_the_port_imports_the_reference_or_jax():
    files = port_sources()
    assert len(files) > 30 and any(f.endswith("training/loop.py") for f in files)
    assert {"buckets.py", "tracking.py", "decode_np.py", "peaks.py"} <= {
        os.path.basename(f) for f in files}
    bad = {os.path.relpath(f, ROOT): sorted(imported_roots(f) & FORBIDDEN) for f in files}
    assert {f: b for f, b in bad.items() if b} == {}


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import tpupose_torch, tpupose_torch.infer, tpupose_torch.testing\n"
        "import tpupose_torch.training.loop, tpupose_torch.data.pipeline\n"
        "import tpupose_torch.gt, tpupose_torch.ops, tpupose_torch.utils.drawing\n"
        "import tpupose_torch.buckets, tpupose_torch.tracking, tpupose_torch.reference_impl\n"
        "from tpupose_torch.decode import decode_maps, decode_maps_batch, to_people\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "print('LOADED', bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def describe(cls):
    return [(f.name, str(f.type), f.default, f.default_factory is dataclasses.MISSING)
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["ModelConfig", "InferenceConfig", "AugmentConfig",
                                  "TrainConfig"])
def test_config_copy_equals_the_reference_field_for_field(name):
    tcls, jcls = getattr(tconfig, name), getattr(jconfig, name)
    assert describe(tcls) == describe(jcls)
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())


def test_config_bundle_and_helpers_equal_the_reference():
    assert [f.name for f in dataclasses.fields(tconfig.PoseConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.PoseConfig)]
    assert dataclasses.asdict(tconfig.DEFAULT) == dataclasses.asdict(jconfig.DEFAULT)
    assert tconfig.DEFAULT.model.label_size == jconfig.DEFAULT.model.label_size == 46
    assert tconfig.DEFAULT.inference.num_scales == jconfig.DEFAULT.inference.num_scales
    assert dataclasses.asdict(tconfig.TrainConfig().frozen_vgg()) == \
        dataclasses.asdict(jconfig.TrainConfig().frozen_vgg())
    assert dataclasses.asdict(tconfig.single_scale()) == dataclasses.asdict(jconfig.single_scale())
    assert dataclasses.asdict(tconfig.with_scales([1.0, 1.5])) == \
        dataclasses.asdict(jconfig.with_scales([1.0, 1.5]))
    with pytest.raises(dataclasses.FrozenInstanceError):
        tconfig.DEFAULT.model.boxsize = 1


def public_values(module):
    return {k: v for k, v in vars(module).items()
            if not k.startswith("__") and not callable(v) and not isinstance(v, type(os))}


def test_topology_copy_equals_the_reference_table_for_table():
    t, j = public_values(ttopology), public_values(jtopology)
    assert set(t) == set(j) and len(t) > 15
    for name in j:
        assert t[name] == j[name], name
    for a, b in zip(ttopology.decode_limb_tables(), jtopology.decode_limb_tables()):
        assert a.dtype == b.dtype and (a == b).all()
    assert tdrawing._DRAW_LIMBS == jdrawing._DRAW_LIMBS


def test_block1_refuses_a_gradient_on_the_kernel_route():
    x = torch.zeros(1, 4, 4, 3)
    k1 = torch.zeros(3, 3, 3, 64, requires_grad=True)
    rest = (torch.zeros(64), torch.zeros(3, 3, 64, 64), torch.zeros(64))
    with pytest.raises(RuntimeError, match="inference-only"):
        block1_mod.refuse_grad(x, k1, *rest)
    with pytest.raises(RuntimeError, match="inference-only"):
        block1_mod.refuse_grad(x.requires_grad_(), k1.detach(), *rest)
    with torch.no_grad():
        block1_mod.refuse_grad(x, k1, *rest)            # no graph is recorded: allowed
    block1_mod.refuse_grad(x.detach(), k1.detach(), *rest)
    # the CPU route is the two convs, and autograd goes through it
    y = block1_mod.block1(x.detach(), k1, *rest)
    assert y.requires_grad and y.shape == (1, 2, 2, 64)


def test_trainer_model_keeps_block1_on_the_convs():
    from tpupose_torch.infer import PoseEstimator
    from tpupose_torch.models import OpenPose

    assert OpenPose(num_stages=1).vgg.pallas_block1 is False
    est = PoseEstimator(dataclasses.replace(
        tconfig.DEFAULT, model=tconfig.ModelConfig(num_stages=1)), device="cpu")
    assert est.model.vgg.pallas_block1 is True
