"""Preemption recovery of the port's trainer, the counterpart of
tests/test_preemption.py: a training process killed with SIGKILL mid-run
resumes from the last COMMITTED checkpoint on restart.

The port writes a checkpoint as ``step_<n>.npz`` through a temporary file
that is renamed into place (``training/checkpoint.py``), so a kill leaves
either the whole file or a ``*.tmp`` beside the committed steps; the
loop's restore-latest must read only committed steps, and junk left by a
kill must not break it.
"""

import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np

from tpupose_torch.config import AugmentConfig, ModelConfig, PoseConfig, TrainConfig
from tpupose_torch.data import pipeline
from tpupose_torch.testing import limit_threads
from tpupose_torch.training import checkpoint as ckpt_lib
from tpupose_torch.training import loop

limit_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, {root!r})
    # torch.utils.tensorboard loads tensorflow where it is installed (slow);
    # its writer needs only the tensorboard package
    sys.modules["tensorflow"] = None
    import torch
    torch.set_num_threads(2)
    from tpupose_torch.config import AugmentConfig, ModelConfig, PoseConfig, TrainConfig
    from tpupose_torch.data import pipeline
    from tpupose_torch.training import loop

    cfg = PoseConfig(
        model=ModelConfig(boxsize=64, num_stages=1, compute_dtype="float32"),
        augment=AugmentConfig(max_persons=2),
        train=TrainConfig(batch_size=2, log_every=1, checkpoint_every=2),
    )
    batches = pipeline.synthetic_batches(cfg, target_h=64, target_w=64, n_batches=200)
    loop.train(cfg, batches, workdir={workdir!r}, max_steps=200, device="cpu")
    """
)


def small_cfg():
    return PoseConfig(
        model=ModelConfig(boxsize=64, num_stages=1, compute_dtype="float32"),
        augment=AugmentConfig(max_persons=2),
        train=TrainConfig(batch_size=2, log_every=1, checkpoint_every=2),
    )


def test_sigkill_mid_training_resumes_from_committed_step(tmp_path):
    workdir = str(tmp_path / "run")
    ckpt_dir = os.path.join(workdir, "checkpoints")
    proc = subprocess.Popen(
        [sys.executable, "-c", WORKER.format(root=ROOT, workdir=workdir)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
    )
    try:
        deadline = time.time() + 300
        latest = None
        while time.time() < deadline:
            latest = ckpt_lib.latest_step(ckpt_dir)
            if latest is not None and latest >= 2:
                break
            if proc.poll() is not None:
                raise AssertionError(f"worker exited (rc={proc.returncode}) with no "
                                     f"checkpoint: {proc.stderr.read().decode()[-2000:]}")
            time.sleep(0.2)
        assert latest is not None and latest >= 2, "no committed checkpoint"
        # preempt: SIGKILL, no cleanup, possibly in the middle of a later write
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stderr.close()
    assert proc.returncode == -signal.SIGKILL

    committed = ckpt_lib.latest_step(ckpt_dir)
    assert committed is not None and committed >= 2
    assert committed % 2 == 0  # only checkpoint_every multiples commit
    # junk beside the committed steps: the temporary file of a half-written
    # later step and a non-numeric entry; restore must ignore both
    half = os.path.join(ckpt_dir, f"step_{committed + 2:09d}.npz.4242.1.tmp")
    with open(half, "wb") as f:
        f.write(b"PK\x03\x04 half a zip archive")
    os.makedirs(os.path.join(ckpt_dir, "not-a-step"), exist_ok=True)
    with open(os.path.join(ckpt_dir, "step_latest.npz"), "wb") as f:
        f.write(b"not a checkpoint")
    assert ckpt_lib.latest_step(ckpt_dir) == committed
    with np.load(os.path.join(ckpt_dir, f"step_{committed:09d}.npz")) as saved:
        assert int(saved["step"]) == committed

    cfg = small_cfg()
    more = pipeline.synthetic_batches(cfg, target_h=64, target_w=64, seed=7, n_batches=2)
    out = loop.train(cfg, more, workdir=workdir, max_steps=committed + 2, device="cpu")
    assert out["state"]["step"] == committed + 2
    assert out["steps"] == 2  # resumed, not restarted from zero
    assert ckpt_lib.latest_step(ckpt_dir) == committed + 2
