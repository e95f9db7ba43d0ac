"""OpenPose BODY_25 in the port against its plain reference, on the CPU.

``models/body25.OpenPoseBody25``, ``ops/dense_epilogue``'s plain version,
the decode over ``skeletons.BODY25`` and ``PoseEstimator(arch="body25")``
against ``reference_impl/body25_ref.py`` (plain torch; nothing of the
port's ops or kernels, no JAX), on seeded weights, at tiny sizes. The
kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``).

Tolerances, each against the largest magnitude of the reference's output:

  * f32 network: 1e-5. Both run the same f32 convs on this CPU; only the
    convolutions' summation order may differ (NCHW against channels_last).
  * bf16 network: 1e-3. The same bf16 recipe (bf16 conv, f32 bias and
    PReLU, one rounding) on this CPU; a different summation order rounds a
    conv output to the neighbouring bf16 value at most (2^-8 relative),
    which the later convs average down. The reference in fp8 (e4m3) inputs,
    one precision lower, is held to miss it (it misses by 2^-8 and more).
  * the estimator end to end: the same people, part for part at the same
    pixel, and each keypoint's score within 1e-5 of the reference's: the
    program reads the scale-space average of the low-res maps where the
    reference upsamples and averages them, the same sum in another order.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpupose_torch import topology
from tpupose_torch.config import DEFAULT
from tpupose_torch.decode import assemble as tasm
from tpupose_torch.decode import paf as tpaf
from tpupose_torch.decode.api import to_people
from tpupose_torch.infer import PoseEstimator
from tpupose_torch.models import weights as weights_lib
from tpupose_torch.models.body25 import OpenPoseBody25
from tpupose_torch.ops.dense_epilogue import dense_epilogue, dense_epilogue_plain
from tpupose_torch.reference_impl import body25_ref as ref
from tpupose_torch.skeletons import BODY25, COCO18
from tpupose_torch.testing import limit_threads

limit_threads()

CFG = dict(thre1=0.05, thre2=0.05, connect_min_ratio=0.95, min_subset_cnt=3,
           min_subset_score=0.4, mid_num=10, peak_sigma=3.0, max_peaks=16)


def _params(seed: int, perturb: bool = True) -> dict[str, torch.Tensor]:
    """The port's seeded init; with ``perturb``, slopes in [0, 0.5) and
    biases N(0, 0.05) so that neither is at its init value."""
    model = OpenPoseBody25(dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if perturb:
        g = torch.Generator().manual_seed(seed + 1)
        for k, v in sd.items():
            if k.endswith(".slope"):
                v.copy_(0.5 * torch.rand(v.shape, generator=g))
            elif k.endswith(".bias"):
                v.copy_(0.05 * torch.randn(v.shape, generator=g))
    return sd


def _port(sd, dtype):
    model = OpenPoseBody25(dtype=dtype, pallas_block1=True)
    model.load_state_dict(sd)
    return model.to(memory_format=torch.channels_last).eval()


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_network_against_the_reference(precision):
    sd = _params(1)
    x = torch.rand(2, 64, 96, 3, generator=torch.Generator().manual_seed(2)) - 0.5
    with torch.no_grad():
        (paf, heat), = _port(sd, getattr(torch, precision))(x)
        want_paf, want_heat = ref.Net(sd, precision)(x)
    assert paf.shape == (2, 8, 12, 52) and heat.shape == (2, 8, 12, 26)
    assert paf.dtype == heat.dtype == torch.float32
    tol = 1e-5 if precision == "float32" else 1e-3
    for got, want in ((paf, want_paf), (heat, want_heat)):
        scale = want.abs().max().item()
        assert scale > 0
        assert (got - want).abs().max().item() <= tol * scale
    if precision == "bfloat16":
        with torch.no_grad():
            low_paf, low_heat = ref.Net(sd, "fp8")(x)
        assert max((low_paf - want_paf).abs().max().item() / want_paf.abs().max().item(),
                   (low_heat - want_heat).abs().max().item() / want_heat.abs().max().item()) > tol


# (w, buffer width, offset) of every epilogue of the network: the dense
# blocks' thirds, then prelu4_2, the CPM convs and Mconv6 at full width
@pytest.mark.parametrize("w,width,off", [(96, 288, 0), (96, 288, 96), (96, 288, 192),
                                         (128, 384, 0), (128, 384, 128), (128, 384, 256),
                                         (512, 512, 0), (256, 256, 0), (128, 128, 0)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dense_epilogue_plain_is_bias_prelu_and_cat(w, width, off, dtype):
    """The operator on the CPU writes bias + PReLU into its slice of the
    buffer and nothing else, and with ``keep`` over its input too, bit for
    bit as a separate bias add, PReLU (``torch.where``) and ``cat``."""
    g = torch.Generator().manual_seed(w + off)
    y = torch.randn(2, 3, 5, w, generator=g).to(dtype)       # 30 pixels: not a multiple of 8
    bias, slope = torch.randn(w, generator=g), torch.rand(w, generator=g)
    out = torch.full((2, 3, 5, width), float("nan"), dtype=dtype)
    before = out.clone()
    kept = y.clone()
    dense_epilogue(kept, bias, slope, out, off, keep=True)
    v = y.float() + bias
    want = torch.where(v > 0, v, slope * v).to(dtype)
    assert torch.equal(out[..., off:off + w], want)
    assert torch.equal(kept, want)
    rest = torch.cat([out[..., :off], out[..., off + w:]], -1)
    assert torch.isnan(rest.float()).all() and rest.shape[-1] == width - w
    assert torch.equal(dense_epilogue_plain(y, bias, slope), want)
    untouched = y.clone()
    dense_epilogue(untouched, bias, slope, before, off, keep=False)
    assert torch.equal(untouched, y)


def test_dense_epilogue_refuses_what_it_cannot_write():
    y = torch.zeros(1, 2, 2, 8)
    with pytest.raises(ValueError):
        dense_epilogue(y, torch.zeros(8), torch.zeros(8), torch.zeros(1, 2, 2, 12), off=8)
    with pytest.raises(ValueError):
        dense_epilogue(y, torch.zeros(8), torch.zeros(8), torch.zeros(1, 2, 2, 16,
                                                                      dtype=torch.bfloat16))


def _calibrated(seed: int, frame: np.ndarray, box: int) -> dict[str, torch.Tensor]:
    """Seeded weights whose last PAF and heat heads are recentred and scaled
    on the reference's maps of ``frame`` at scale 1.0 (0.99 quantile of the
    magnitudes 0.8), so that the decode finds people."""
    sd = _params(seed, perturb=False)
    (rh, rw, ph, pw), = ref.scale_sizes(*frame.shape[:2], (1.0,), box, 8)
    x = ref.resize(ref.normalize(torch.from_numpy(frame[None])), rh, rw)
    x = torch.nn.functional.pad(x, (0, 0, 0, pw - rw, 0, ph - rh))
    with torch.no_grad():
        paf, heat = ref.Net(sd, "float32")(x)
    for scope, maps, used in (("stage1_L1", heat, slice(0, -1)), ("stage3_L2", paf, slice(None))):
        flat = maps.reshape(-1, maps.shape[-1])
        shift = flat.median(dim=0).values
        f = float(0.8 / torch.quantile((flat - shift)[:, used].abs().flatten(), 0.99))
        sd[f"{scope}.Mconv7_{scope}.weight"].mul_(f)
        sd[f"{scope}.Mconv7_{scope}.bias"].sub_(shift).mul_(f)
    return sd


def _layout(people):
    return sorted(tuple(sorted((n, k["x"], k["y"]) for n, k in p["keypoints"].items()))
                  for p in people)


def test_estimator_end_to_end_against_the_reference():
    frames = np.random.default_rng(5).integers(0, 256, (2, 96, 128, 3)).astype(np.uint8)
    box, scales = 96, (0.5, 1.0)
    sd = _calibrated(3, frames[0], box)
    cfg = dataclasses.replace(
        DEFAULT, model=dataclasses.replace(DEFAULT.model, boxsize=box, compute_dtype="float32"),
        inference=dataclasses.replace(DEFAULT.inference, scale_search=scales, **CFG))
    est = PoseEstimator(cfg, params=weights_lib.to_flax(sd), device="cpu", arch="body25")
    got = est.process_batch(frames)
    streamed = list(est.stream(iter([frames[:1], frames[1:]]), depth=1))
    with torch.no_grad():
        heat, paf = ref.averaged_maps(ref.Net(sd, "float32"), torch.from_numpy(frames), scales,
                                      box, 8)
        want = ref.decode_batch(heat, paf, CFG)
    assert sum(len(p) for p in want) >= 10
    for g, s, w in zip(got, [b[0] for b in streamed], want):
        assert _layout(g) == _layout(w) == _layout(s)
        scores = {tuple(sorted((n, k["x"], k["y"]) for n, k in p["keypoints"].items())):
                  [k["score"] for _, k in sorted(p["keypoints"].items())] for p in w}
        for p in g:
            key = tuple(sorted((n, k["x"], k["y"]) for n, k in p["keypoints"].items()))
            mine = [k["score"] for _, k in sorted(p["keypoints"].items())]
            assert np.allclose(mine, scores[key], rtol=0, atol=1e-5)
        assert all(set(p["keypoints"]) <= set(BODY25.parts) for p in g)


def test_body25_tables_are_openpose_s():
    assert BODY25.parts == (
        "Nose", "Neck", "RShoulder", "RElbow", "RWrist", "LShoulder", "LElbow", "LWrist",
        "MidHip", "RHip", "RKnee", "RAnkle", "LHip", "LKnee", "LAnkle", "REye", "LEye",
        "REar", "LEar", "LBigToe", "LSmallToe", "LHeel", "RBigToe", "RSmallToe", "RHeel")
    assert BODY25.pairs == (
        (1, 8), (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (8, 9), (9, 10), (10, 11),
        (8, 12), (12, 13), (13, 14), (1, 0), (0, 15), (15, 17), (0, 16), (16, 18), (2, 17),
        (5, 18), (14, 19), (19, 20), (14, 21), (11, 22), (22, 23), (11, 24))
    assert BODY25.paf == tuple((2 * k, 2 * k + 1) for k in range(26))
    assert BODY25.seeds == frozenset(range(26)) - {18, 19}
    assert (BODY25.num_parts, BODY25.num_limbs, BODY25.heat_channels,
            BODY25.paf_channels) == (25, 26, 26, 52)
    flip = BODY25.flip
    assert sorted(flip) == list(range(25)) and all(flip[flip[i]] == i for i in range(25))
    for a, b in (("RShoulder", "LShoulder"), ("RHeel", "LHeel"), ("RBigToe", "LBigToe")):
        assert flip[BODY25.parts.index(a)] == BODY25.parts.index(b)
    assert flip[BODY25.parts.index("MidHip")] == BODY25.parts.index("MidHip")
    assert len(BODY25.colors) == 25
    assert (BODY25.parts, BODY25.pairs, BODY25.paf) == (ref.PARTS, ref.PAIRS, ref.PAF)


def test_coco18_is_topology_table_for_table():
    pairs, chans = COCO18.limb_tables()
    want_pairs, want_chans = topology.decode_limb_tables()
    assert np.array_equal(pairs, want_pairs) and np.array_equal(chans, want_chans)
    assert pairs.dtype == want_pairs.dtype and chans.dtype == want_chans.dtype
    assert COCO18.parts == topology.PARTS and COCO18.flip == topology.FLIP_PERMUTATION
    assert COCO18.colors == topology.DRAW_COLORS
    assert COCO18.seeds == frozenset(range(17))
    assert (COCO18.num_parts, COCO18.num_limbs, COCO18.heat_channels,
            COCO18.paf_channels) == (topology.NUM_PARTS, topology.NUM_LIMBS,
                                     topology.NUM_HEAT_CHANNELS, topology.NUM_PAF_CHANNELS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assembly_at_25_parts_against_the_reference(seed):
    """Seeded candidate tables through the port's greedy accept, then the
    port's plain assembly and cull against the reference's assembly of the
    same connections: the same people in the same order, the same parts
    and counts, scores within f32's rounding of the reference's f64 sums."""
    rng = np.random.default_rng(seed)
    k, b = 12, 2
    xs = torch.from_numpy(rng.integers(0, 200, (b, 25, k)).astype(np.int32))
    ys = torch.from_numpy(rng.integers(0, 100, (b, 25, k)).astype(np.int32))
    n_peaks = rng.integers(2, k + 1, (b, 25))
    valid = torch.from_numpy(np.arange(k)[None, None, :] < n_peaks[..., None])
    scores = torch.from_numpy(rng.random((b, 25, k)).astype(np.float32)) * valid
    prior = torch.from_numpy(rng.normal(0.3, 0.5, (b, 26, k, k)).astype(np.float32))
    pairs = torch.as_tensor(BODY25.limb_tables()[0], dtype=torch.int64)
    ok = (valid[:, pairs[:, 0], :, None] & valid[:, pairs[:, 1], None, :]
          & torch.from_numpy(rng.random((b, 26, k, k)) < 0.35) & (prior > 0))
    ts, ta, tb, sa, sb = tpaf.candidates(prior, ok, scores, k * k, BODY25)
    limits = torch.minimum(valid[:, pairs[:, 0]].sum(-1), valid[:, pairs[:, 1]].sum(-1))
    conns = tpaf.greedy_accept(ts, ta, tb, sa, sb, limits, k, k, BODY25)
    raw = tasm.assemble(conns, 64, BODY25)
    people = tasm.cull_and_compact(raw["rows"], raw["score"], raw["cnt"], raw["active"],
                                   raw["stamp"], CFG["min_subset_cnt"], CFG["min_subset_score"])
    for i in range(b):
        tables = {key: v[i].numpy() for key, v in people.items()}
        tables.update(peak_xs=xs[i].numpy(), peak_ys=ys[i].numpy(), peak_scores=scores[i].numpy())
        got = to_people(tables, BODY25)
        peaks = [(xs[i, p, :n_peaks[i, p]].numpy(), ys[i, p, :n_peaks[i, p]].numpy(),
                  scores[i, p, :n_peaks[i, p]].double().numpy()) for p in range(25)]
        connections = []
        for l, (pa, pb) in enumerate(BODY25.pairs):
            n = int(conns["n_valid"][i, l])
            rows = [(int(conns["pa"][i, l, q]) - pa * k, int(conns["pb"][i, l, q]) - pb * k,
                     float(conns["cs"][i, l, q])) for q in range(n)]
            connections.append(np.asarray(rows, np.float64).reshape(-1, 3))
        want = ref.assemble(peaks, connections, CFG)
        assert len(want) >= 2
        assert [sorted(p["keypoints"]) for p in got] == [sorted(p["keypoints"]) for p in want]
        assert [p["num_parts"] for p in got] == [p["num_parts"] for p in want]
        for g, w in zip(got, want):
            assert abs(g["score"] - w["score"]) <= 1e-5 * max(1.0, abs(w["score"]))
            for name, kp in g["keypoints"].items():
                assert (kp["x"], kp["y"]) == (w["keypoints"][name]["x"], w["keypoints"][name]["y"])


# --- the stage loop's CUDA graphs: the engagement rule, on the CPU -------------------------


@pytest.fixture(scope="module")
def tiny_net():
    """The f32 network (full width) on 16 x 16 images: F is 2 x 2."""
    model = OpenPoseBody25(dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(4))
    return model.to(memory_format=torch.channels_last).eval()


@pytest.mark.parametrize("case", ["cpu", "grad", "params", "export"])
def test_stage_graphs_run_op_by_op_unless_every_rule_holds(tiny_net, case, monkeypatch):
    """Each case breaks one rule of ``StageGraphs.refusal`` (the rules are
    checked in the order grad, export, params, device, so each case names
    its own) and runs the stage loop op by op: counted ``net.stages.eager``
    (under ``torch.export``, where counters stay off, the program holds the
    loop's 96 epilogues and the front's 3 as its own nodes), never a graph."""
    from tpupose_torch.models import stage_graph
    from tpupose_torch.utils import profiling

    said = []
    refusal = stage_graph.StageGraphs.refusal

    def spy(self, x, tensors):
        said.append(refusal(self, x, tensors))
        return said[-1]

    monkeypatch.setattr(stage_graph.StageGraphs, "refusal", spy)
    x = torch.rand(1, 16, 16, 3, generator=torch.Generator().manual_seed(6))
    before = profiling.counters()
    if case == "export":
        with torch.no_grad():
            ep = torch.export.export(tiny_net, (x,))
        nodes = [n for n in ep.graph.nodes if "dense_epilogue" in str(n.target)]
        assert len(nodes) == 99
    elif case == "grad":
        tiny_net(x)
    else:
        with torch.no_grad():
            if case == "params":
                other = {k: v.clone() for k, v in tiny_net.state_dict().items()}
                torch.func.functional_call(tiny_net, other, (x,))
            else:
                tiny_net(x)
    after = profiling.counters()
    assert said == [{"cpu": "device"}.get(case, case)]
    eager = after.get("net.stages.eager", 0) - before.get("net.stages.eager", 0)
    assert eager == (0 if case == "export" else 1)
    assert after.get("net.stages.graph", 0) == before.get("net.stages.graph", 0)
    assert not tiny_net.stage_graphs._keys


def test_stage_graphs_of_a_copy_read_the_copy_s_parameters(tiny_net):
    """A replica (``copy.deepcopy``, as ``parallel.sharding.replicate_module``
    makes one) starts with no graphs, its own parameters the copy's."""
    import copy

    rep = copy.deepcopy(tiny_net)
    own = rep.stage_graphs.own
    assert len(own) == len(tiny_net.stage_graphs.own) == 300
    assert all(a is b for a, b in zip(own, rep.stage_tensors()))
    assert not any(a is b for a, b in zip(own, tiny_net.stage_tensors()))
    assert rep.stage_graphs._lock is not tiny_net.stage_graphs._lock and not rep.stage_graphs._keys


def test_add_counts_adds_counters_and_launches():
    """``profiling.add_counts``: a replay's share of the counters, the
    kernels' launch counts among them."""
    from tpupose_torch import ops
    from tpupose_torch.utils import profiling

    before = profiling.counters()
    profiling.add_counts({"launch.dense_epilogue": 96, "net.dense_epilogue": 96})
    after = profiling.counters()
    assert after["launch.dense_epilogue"] - before["launch.dense_epilogue"] == 96
    assert after["net.dense_epilogue"] - before.get("net.dense_epilogue", 0) == 96
    assert ops.launch_counts()["dense_epilogue"] == after["launch.dense_epilogue"]
