"""The program's spans and counters (``tpupose_torch.utils.profiling``) on
the CPU.

Without a profiler a span records nothing; inside ``profiling.trace`` nested
spans give their count, total and self time, per thread; the inference
path's spans (``infer.enqueue`` holding ``decode.overflow_switch``, then
``infer.finish``) reach the Chrome file, and a training step's
(``train.step`` over ``train.upload``, ``train.targets``, ``train.update``)
the store; the peak tables count the order they took; ``counters()``
carries the kernels' launch counts; and an exported program holds no span
and counts nothing. Small: one stage, f32, scale 0.5.
"""

import glob
import json
import threading
import time

import numpy as np
import pytest
import torch

from tpupose_torch import ops
from tpupose_torch.config import (AugmentConfig, InferenceConfig, ModelConfig, PoseConfig,
                                  TrainConfig)
from tpupose_torch.decode.peaks import peak_tables
from tpupose_torch.infer import PoseEstimator
from tpupose_torch.testing import limit_threads
from tpupose_torch.utils import profiling

limit_threads()

CFG = PoseConfig(model=ModelConfig(boxsize=64, num_stages=1, compute_dtype="float32"),
                 inference=InferenceConfig(scale_search=(0.5,), max_peaks=16, max_people=16,
                                           pair_tiers=(8,), peak_compact_tiers=(8,)))
INFER_SPANS = ("infer.enqueue", "decode.overflow_switch", "infer.finish")


@pytest.fixture(autouse=True)
def fresh_store():
    profiling.reset_spans()
    profiling.reset_counters()
    yield
    profiling.reset_spans()
    profiling.reset_counters()


@pytest.fixture(scope="module")
def est():
    return PoseEstimator(CFG, seed=0, device="cpu")


def _images(n=2):
    return np.random.default_rng(0).integers(0, 255, (n, 64, 64, 3)).astype(np.uint8)


def _chrome(logdir) -> list[dict]:
    files = glob.glob(str(logdir / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def test_without_a_profiler_a_span_records_nothing(est):
    with profiling.annotate("idle", 3) as got:
        est.process_batch(_images())
    assert got is None and profiling.annotate("idle") is profiling.annotate("other")
    assert profiling.span_totals() == {}


def test_nested_spans_give_count_total_and_self_per_thread(tmp_path):
    def worker():
        with profiling.annotate("worker"):
            time.sleep(0.01)

    with profiling.trace(str(tmp_path)):
        for _ in range(2):
            with profiling.annotate("outer"):
                time.sleep(0.01)
                for _ in range(2):
                    with profiling.annotate("inner"):
                        time.sleep(0.01)
                t = threading.Thread(target=worker)
                t.start()
                t.join(10.0)
                assert not t.is_alive()
    got = profiling.span_totals()
    assert {k: v["count"] for k, v in got.items()} == {"outer": 2, "inner": 4, "worker": 2}
    inner, outer, other = got["inner"], got["outer"], got["worker"]
    assert inner["total_s"] >= 0.04 and inner["self_s"] == inner["total_s"]
    # another thread's span is no child: the outer span's self time holds it
    assert outer["self_s"] == pytest.approx(outer["total_s"] - inner["total_s"], abs=1e-9)
    assert outer["self_s"] >= 0.02 + other["total_s"]
    profiling.reset_spans()
    assert profiling.span_totals() == {}


def test_inference_spans_reach_the_chrome_file_joined_by_the_batch(est, tmp_path):
    n, tables = est.process_batch_async(_images())
    with profiling.trace(str(tmp_path)):
        people = est.process_batch(_images())
    assert len(people) == 2 and est.process_batch_async(_images())[1].seq == tables.seq + 2
    got = profiling.span_totals()
    assert {k: got[k]["count"] for k in INFER_SPANS} == dict.fromkeys(INFER_SPANS, 1)
    marks = {e["name"]: e for e in _chrome(tmp_path) if e.get("name") in INFER_SPANS}
    assert set(marks) == set(INFER_SPANS)
    enq, switch, fin = (marks[k] for k in INFER_SPANS)
    assert enq["ts"] <= switch["ts"] and switch["ts"] + switch["dur"] <= enq["ts"] + enq["dur"]
    assert fin["ts"] >= enq["ts"] + enq["dur"]
    assert got["infer.enqueue"]["self_s"] < got["infer.enqueue"]["total_s"]


def test_a_train_step_records_its_three_children(est, tmp_path, monkeypatch):
    from tpupose_torch.data.pipeline import synthetic_batches
    from tpupose_torch.training import loop

    # TensorBoard's import (TensorFlow where installed) is not under test
    monkeypatch.setattr(loop, "TBLogger", lambda logdir: loop._NoLog())
    cfg = PoseConfig(model=ModelConfig(boxsize=64, num_stages=1, compute_dtype="float32"),
                     augment=AugmentConfig(max_persons=2),
                     train=TrainConfig(batch_size=2, log_every=1, checkpoint_every=100))
    with profiling.trace(str(tmp_path / "trace")):
        out = loop.train(cfg, synthetic_batches(cfg, 64, 64, n_batches=1),
                         params=est.model.state_dict(), workdir=str(tmp_path), max_steps=1,
                         seed=0, device="cpu")
    assert out["steps"] == 1
    got = profiling.span_totals()
    parts = ("train.upload", "train.targets", "train.update")
    assert {k: got[k]["count"] for k in ("train.step", *parts)} == dict.fromkeys(
        ("train.step", *parts), 1)
    step = got["train.step"]
    assert step["self_s"] == pytest.approx(step["total_s"] - sum(got[k]["total_s"] for k in parts),
                                           abs=1e-9)
    assert 0 < step["self_s"] < step["total_s"]


@pytest.mark.parametrize("peaks,overflow,order", [(20, None, "sorted"), (5, None, "scan"),
                                                  (5, True, "sorted"), (20, False, "scan")])
def test_peak_tables_count_the_order_they_take(peaks, overflow, order):
    flat = torch.full((3, 64), -torch.inf)
    flat[1, :peaks] = torch.arange(peaks, dtype=torch.float32)
    peak_tables(flat, 8, 16, overflow)
    peak_tables(flat, 8, 16, overflow)
    got = {k: v for k, v in profiling.counters().items() if k.startswith("decode.")}
    assert got == {f"decode.tables.{order}": 2}


def test_counters_carry_the_launch_counts(monkeypatch):
    kernel = ops.KERNELS[0]
    monkeypatch.setattr(kernel, "launches", 5)
    profiling.count("decode.tables.scan", 2)
    got = profiling.counters()
    assert {k[len("launch."):]: v for k, v in got.items() if k.startswith("launch.")} == \
        ops.launch_counts()
    assert got[f"launch.{kernel.name}"] == 5 and got["decode.tables.scan"] == 2
    profiling.reset_counters()
    assert set(profiling.counters().values()) == {0} and kernel.launches == 0


def test_an_exported_program_holds_no_span_and_counts_nothing(est, tmp_path):
    import io

    from tpupose_torch.deploy import export_program

    with profiling.trace(str(tmp_path)):
        blob = export_program(est, 1, 32, 32)
    assert profiling.span_totals() == {}
    assert not any(k.startswith("decode.") for k in profiling.counters())
    ep = torch.export.load(io.BytesIO(blob))
    targets = {str(node.target) for node in ep.graph.nodes}
    assert not [t for t in targets if "profiler" in t or "record_function" in t]
