"""The port's parallel/ against the JAX package on its 8-device virtual mesh
(tests/conftest.py), on the CPU.

The port's meshes in these tests are grids of 8 (or fewer) entries that all name the
CPU: each entry runs its own replica of the network, so the programs split,
pad and gather exactly as over 8 cards. Sizes: 2 stages (1 for the large
image), boxsize 64, f32 unless stated, the random network's last heads
scaled up so that it decodes people. People: the same parts at the same
pixels, scores within 1e-4; maps within 1e-5 of the map's scale.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpupose.parallel.pyramid as jpyramid
from tpupose.config import InferenceConfig as JInf, ModelConfig as JModel, PoseConfig as JPose
from tpupose.infer import PoseEstimator as JaxEstimator
from tpupose.models import OpenPose as JaxOpenPose
from tpupose.parallel import inference as jinference
from tpupose.parallel import sharding as jsharding
from tpupose.parallel import spatial as jspatial
from tpupose_torch.config import InferenceConfig, ModelConfig, PoseConfig
from tpupose_torch.decode.api import to_people
from tpupose_torch.infer import PoseEstimator
from tpupose_torch.models import OpenPose, weights
from tpupose_torch.parallel import inference, pyramid, sharding, spatial
from tpupose_torch.parallel.sharding import Mesh
from tpupose_torch.testing import limit_threads

limit_threads()

CPU = torch.device("cpu")
SCALES = (0.5, 1.0)


def cpus(n):
    return [CPU] * n


def configs(scales=SCALES, max_peaks=16):
    inf = dict(scale_search=scales, max_peaks=max_peaks, peak_compact_tiers=(8,))
    return (JPose(model=JModel(boxsize=64, num_stages=2, compute_dtype="float32"),
                  inference=JInf(**inf)),
            PoseConfig(model=ModelConfig(boxsize=64, num_stages=2, compute_dtype="float32"),
                       inference=InferenceConfig(**inf)))


@lru_cache(maxsize=1)
def _params():
    """Seeded flax init with the last heads scaled up, so the random network
    emits peaks and limbs."""
    params = JaxOpenPose(num_stages=2, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"]
    params = jax.tree.map(np.asarray, params)
    for branch in ("stage2_L1", "stage2_L2"):
        params[branch]["out"]["kernel"] = params[branch]["out"]["kernel"] * 3000.0
    return params


def estimators(scales=SCALES, max_peaks=16):
    jcfg, tcfg = configs(scales, max_peaks)
    params = _params()
    return (JaxEstimator(jcfg, params=jax.tree.map(jnp.asarray, params)),
            PoseEstimator(tcfg, params=params, device="cpu"))


def images(n, h=64, w=80, seed=0):
    return (np.random.default_rng(seed).random((n, h, w, 3)) * 255).astype(np.uint8)


def assert_same_people(got, want, px=0, score_tol=1e-4):
    assert len(got) == len(want)
    for pg, pw in zip(got, want):
        assert len(pg) == len(pw)
        for a, b in zip(pg, pw):
            assert a["num_parts"] == b["num_parts"]
            assert sorted(a["keypoints"]) == sorted(b["keypoints"])
            assert abs(a["score"] - b["score"]) <= score_tol
            for name, kp in a["keypoints"].items():
                other = b["keypoints"][name]
                assert abs(kp["x"] - other["x"]) <= px and abs(kp["y"] - other["y"]) <= px
                assert abs(kp["score"] - other["score"]) <= score_tol


# --- sharding ---------------------------------------------------------------------------


@pytest.mark.parametrize("n, multiple, weighted", [(10, 8, False), (10, 4, True), (5, 4, False),
                                                   (8, 8, False), (3, 2, True)])
def test_pad_batch_equals_the_reference(n, multiple, weighted):
    rng = np.random.default_rng(n)
    batch = {"images": rng.integers(0, 255, (n, 8, 8, 3)).astype(np.uint8),
             "masks": rng.integers(0, 255, (n, 8, 8)).astype(np.uint8),
             "joints": rng.normal(size=(n, 2, 18, 3)).astype(np.float32),
             "centers": rng.normal(size=(n, 2)).astype(np.float32),
             "scales": rng.uniform(size=(n,)).astype(np.float32)}
    if weighted:
        batch["weight"] = rng.uniform(size=(n,)).astype(np.float32)
    got, n_got = sharding.pad_batch(batch, multiple)
    want, n_want = jsharding.pad_batch(batch, multiple)
    assert n_got == n_want == n
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert sharding.pad_to_multiple(n, multiple) == jsharding.pad_to_multiple(n, multiple)


def test_mesh_sizes_equal_the_reference():
    for b in range(1, 13):
        assert (sharding.data_mesh_for_batch(b, devices=cpus(8)).size
                == jsharding.data_mesh_for_batch(b).devices.size), b
    for s in (1, 2, 3, 4, 5, 8):
        assert pyramid.scale_mesh(s, devices=cpus(8)).size == jpyramid.scale_mesh(s).devices.size
        assert (pyramid.default_data_scale_mesh(s, devices=cpus(8)).shape
                == dict(jpyramid.default_data_scale_mesh(s).shape))
    assert pyramid.data_scale_mesh(4, cpus(8)).shape == {"data": 2, "scale": 4}
    with pytest.raises(ValueError, match="do not split"):
        pyramid.data_scale_mesh(3, cpus(8))
    assert spatial.spatial_mesh(4, cpus(8)).shape == {"spatial": 4}
    assert sharding.make_mesh(3, devices=cpus(8)).size == 3


def test_shard_batch_and_replicate_place_rows_in_mesh_order():
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    pieces = sharding.shard_batch(Mesh(cpus(4), ("data",)), {"x": x})["x"]
    assert pieces.shape == (4,)
    assert all(np.array_equal(p.numpy(), x[2 * i:2 * i + 2]) for i, p in enumerate(pieces))
    grid = pyramid.data_scale_mesh(2, cpus(4))                 # ('data', 'scale') = (2, 2)
    by_data = sharding.shard_batch(grid, {"x": x})["x"]
    assert np.array_equal(by_data[1, 0].numpy(), x[4:]) and np.array_equal(by_data[1, 1], x[4:])
    by_scale = sharding.Sharding(grid, "scale").place(x)
    assert np.array_equal(by_scale[1, 0].numpy(), x[:4]) and np.array_equal(by_scale[0, 1], x[4:])
    assert sharding.batch_sharding(grid) == sharding.Sharding(grid, "data")
    rep = sharding.replicate_tree(grid, {"x": x, "s": np.float32(2.0)})
    assert all(np.array_equal(p.numpy(), x) for p in rep["x"].flat)
    assert all(p.item() == 2.0 for p in rep["s"].flat)
    with pytest.raises(ValueError, match="does not split"):
        sharding.shard_batch(Mesh(cpus(3), ("data",)), {"x": x})


def test_resolve_dp_errors_are_the_reference():
    devs = cpus(4)
    assert inference.resolve_dp("auto", devs) == jinference.resolve_dp("auto", devs) == 4
    assert inference.resolve_dp("2", devs) == 2
    for spec in ("5", "0", "many", "-1"):
        with pytest.raises(ValueError) as want:
            jinference.resolve_dp(spec, devs)
        with pytest.raises(ValueError) as got:
            inference.resolve_dp(spec, devs)
        assert str(got.value) == str(want.value)
    # without a list: the visible CUDA devices (none on a host without CUDA)
    with pytest.raises(ValueError, match="exceeds the 0 visible"):
        inference.resolve_dp("1")
    est = object()
    assert inference.wrap_dp(est, "1", devs) == (est, 1)
    wrapped, n = inference.wrap_dp(PoseEstimator(configs()[1], params=_params(), device="cpu"),
                                   "3", devs)
    assert n == 3 and isinstance(wrapped, inference.DataParallelEstimator)


def test_kernels_launch_with_their_tensors_device_current(monkeypatch):
    """A replica, canvas chunk or tile on another card than the current one:
    each kernel's C launcher runs with that card made current and gets that
    card's stream, and the current card is restored after it (the CUDA
    runtime is stood in for, so this runs without a card)."""
    from tpupose_torch import ops

    current = [torch.device("cuda", 0)]
    seen = []

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            self.prev, current[0] = current[0], self.device

        def __exit__(self, *exc):
            current[0] = self.prev

    def launcher(*args):
        seen.append((current[0], args))
        return 0

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("Stream", (), {"cuda_stream": 1000 + d.index})())
    for k in ops.KERNELS:
        monkeypatch.setattr(k, "build", lambda: launcher)
        monkeypatch.setattr(k, "launches", 0)
        k.launch(torch.device("cuda", 1), 7, 8)
        assert seen.pop() == (torch.device("cuda", 1), (7, 8, 1001)), k.name
        assert current == [torch.device("cuda", 0)] and k.launches == 1
        with pytest.raises(ValueError, match="not a CUDA device"):
            k.launch(CPU, 7, 8)
        assert not seen and k.launches == 1


# --- the data-parallel estimator ---------------------------------------------------------


def test_dp_estimator_matches_the_reference_with_padding_and_valid_hw():
    jest, est = estimators()
    imgs = images(5)
    valid = np.asarray([[64, 80]] * 5, np.int32)
    valid[3] = (40, 48)
    want = jinference.DataParallelEstimator(jest, jsharding.make_mesh(8)).process_batch(
        imgs, valid_hw=valid)
    dp = inference.DataParallelEstimator(est, Mesh(cpus(8), ("data",)))
    assert dp.pretrained == est.pretrained and dp.cfg is est.cfg       # delegation
    assert len(dp._replicas) == 8 and dp._replicas[1].model is not est.model
    got = dp.process_batch(imgs, valid_hw=valid)
    assert sum(map(len, want)) >= 10
    assert_same_people(got, want)
    assert_same_people(got, est.process_batch(imgs, valid_hw=valid))
    n, tables = dp.process_batch_async(imgs)
    assert n == 8 and tables["rows"].shape[0] == 8
    assert_same_people(dp._finish(n, tables)[:5], est.process_batch(imgs))
    assert_same_people(inference.dp_process_batch(est, imgs, Mesh(cpus(2), ("data",))),
                       est.process_batch(imgs))


def test_dp_overflow_switch_is_decided_over_the_whole_batch():
    """Image 1 of this batch holds 20 peaks in one part channel, the others
    at most 15: at max_peaks 16 every image's tables turn to score order,
    in the reference's one program and in the port's chunks alike. (The
    seed is one whose maps hold no NMS near-tie that the two frameworks'
    f32 blurs break differently: on such a tie, one ulp apart, the two
    keep different pixels, ``ROADMAP.md`` queue 3.)"""
    jest, est = estimators()
    imgs = images(8, seed=40)
    flats, _, _ = est._scores(imgs, None, None)
    counts = torch.isfinite(flats).sum(-1).amax(-1)
    assert (counts > 16).tolist() == [i == 1 for i in range(8)]
    mesh = Mesh(cpus(4), ("data",))
    dp = inference.DataParallelEstimator(est, mesh)
    n, tables = dp.process_batch_async(imgs)
    whole = est._run(imgs, None, None)
    for k in whole:
        assert torch.equal(tables[k], whole[k]), k
    # a chunk deciding alone would keep scan order: other tables
    alone = est._run(imgs[2:4], None, None)
    assert not torch.equal(alone["peak_xs"], whole["peak_xs"][2:4])
    want = jinference.DataParallelEstimator(jest, jsharding.make_mesh(4)).process_batch(imgs)
    assert_same_people(dp._finish(n, tables), want)


def test_dp_estimator_drives_the_bucketed_runner():
    from tpupose_torch.buckets import BucketedRunner

    _, est = estimators(scales=(1.0,))
    rng = np.random.default_rng(4)
    imgs = [(rng.random((48 + 8 * i, 64, 3)) * 255).astype(np.uint8) for i in range(5)]
    want = BucketedRunner(est, ((64, 64),), batch_size=4).process_many(imgs)
    dp = inference.DataParallelEstimator(est, Mesh(cpus(4), ("data",)))
    got = BucketedRunner(dp, ((64, 64),), batch_size=4).process_many(imgs)
    assert_same_people(got, want)


# --- the scale-sharded pyramid ------------------------------------------------------------


def reference_maps(monkeypatch, build, *args):
    """The reference's sharded program with its decode replaced by the
    identity: the averaged maps it would decode."""
    monkeypatch.setattr(jpyramid, "decode_impl", lambda h, p, cfg: {"heat": h, "paf": p})
    monkeypatch.setattr(jpyramid, "decode_impl_batch", lambda h, p, cfg: {"heat": h, "paf": p})
    out = jax.device_get(build(*args))
    monkeypatch.undo()
    return out


def assert_maps_close(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * scale)


def test_sharded_process_matches_the_reference_over_8_entries(monkeypatch):
    scales = (0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0, 1.125)
    jest, est = estimators(scales=scales)
    img = images(1, seed=3)[0]
    jfn = jpyramid.build_sharded_pyramid_fn(jest.model, jest.cfg, jsharding.make_mesh(8), 64, 80)
    want = reference_maps(monkeypatch, jfn, jest.params, jnp.asarray(img))
    mesh = Mesh(cpus(8), ("data",))
    heat, paf = pyramid.sharded_maps(sharding.replicate_module(est.model, mesh), cpus(8),
                                     est.cfg, img[None])
    assert_maps_close(heat[0], want["heat"])
    assert_maps_close(paf[0], want["paf"])
    people = pyramid.sharded_process(est, img, mesh)["people"]
    assert len(people) > 0
    assert_same_people([people], [jpyramid.sharded_process(jest, img, jsharding.make_mesh(8))
                                  ["people"]])
    tables = pyramid.build_sharded_pyramid_fn(est.model, est.cfg, mesh)(img)
    assert tables["rows"].dim() == 2


def test_sharded_process_batch_matches_the_reference_over_a_2x4_mesh(monkeypatch):
    scales = (0.5, 0.75, 1.0, 1.25)
    jest, est = estimators(scales=scales)
    imgs = images(2, seed=5)
    jmesh = jpyramid.data_scale_mesh(4)
    jfn = jpyramid.build_sharded_pyramid_batch_fn(jest.model, jest.cfg, jmesh, 2, 64, 80)
    want = reference_maps(monkeypatch, jfn, jest.params, jnp.asarray(imgs))
    mesh = pyramid.data_scale_mesh(4, cpus(8))
    heat, paf = pyramid.sharded_maps(sharding.replicate_module(est.model, mesh), cpus(8),
                                     est.cfg, imgs)
    assert_maps_close(heat, want["heat"])
    assert_maps_close(paf, want["paf"])
    got = pyramid.sharded_process_batch(est, imgs[:1], mesh)     # padded to the data axis
    assert len(got) == 1
    ref = jpyramid.sharded_process_batch(jest, imgs, jmesh)
    assert_same_people([p["people"] for p in pyramid.sharded_process_batch(est, imgs, mesh)],
                       [p["people"] for p in ref])
    assert_same_people([got[0]["people"]], [ref[0]["people"]])
    tables = pyramid.build_sharded_pyramid_batch_fn(est.model, est.cfg, mesh)(imgs)
    assert_same_people([to_people({k: v[i].numpy() for k, v in tables.items()}) for i in range(2)],
                       [p["people"] for p in ref])


def test_sharded_pyramid_is_invariant_to_the_device_count():
    _, est = estimators()
    imgs = images(2, seed=9)
    one = pyramid.sharded_process_batch(est, imgs, pyramid.data_scale_mesh(1, cpus(1)))
    many = pyramid.sharded_process_batch(est, imgs, pyramid.data_scale_mesh(2, cpus(4)))
    assert sum(len(p["people"]) for p in one) > 0
    assert_same_people([p["people"] for p in many], [p["people"] for p in one], score_tol=1e-5)
    single = pyramid.sharded_process(est, imgs[0], Mesh(cpus(2), ("data",)))
    assert_same_people([single["people"]], [one[0]["people"]], score_tol=1e-5)


# --- spatial tiles --------------------------------------------------------------------------


@pytest.mark.parametrize("h", [64, 88])
def test_spatial_forward_matches_the_reference_over_8_tiles(h):
    """88 rows: 11 output rows over 8 tiles, uneven; at 64, one output row
    a tile, so a 7x7 conv's halo reaches three tiles away."""
    jmodel = JaxOpenPose(num_stages=2, dtype=jnp.float32)
    x = np.random.default_rng(1).normal(size=(1, h, 64, 3)).astype(np.float32)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    want = jspatial.build_spatial_forward(jmodel, jspatial.spatial_mesh(8))(params, jnp.asarray(x))
    model = OpenPose(num_stages=2, dtype=torch.float32)
    model.load_state_dict(weights.from_flax(params))
    model = model.to(memory_format=torch.channels_last)
    fwd = spatial.build_spatial_forward(model, spatial.spatial_mesh(8, cpus(8)))
    got = fwd(torch.from_numpy(x))
    assert spatial.tile_bounds(h // 8, 8) == [(h // 8) * t // 8 for t in range(9)]
    for g, w in zip(got, want):
        assert tuple(g.shape) == (1, h // 8, 8, w.shape[-1])
        assert_maps_close(g, w)
    for n in (1, 2, 3):
        for g, w in zip(spatial.build_spatial_forward(model, spatial.spatial_mesh(n, cpus(8)))(
                torch.from_numpy(x)), got):
            assert_maps_close(g, w.numpy())


def test_spatial_block1_tiles_with_their_halo_equal_the_whole_image():
    """bf16 with pallas_block1: each tile's block 1 runs on the tile and a
    2-row halo (the kernel's route on the card, its plain version on the CPU), and
    the cropped rows give the whole image's block 1 bit for bit."""
    model = OpenPose(num_stages=1, dtype=torch.bfloat16, pallas_block1=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(2).uniform(-0.5, 0.5, (1, 3, 88, 64))
                         .astype(np.float32))
    with torch.no_grad():
        whole = model.vgg.block1(x)
        bounds = [0, 24, 48, 88]
        tiles = spatial._Tiles([x[:, :, a:b] for a, b in zip(bounds, bounds[1:])], bounds,
                               cpus(3))
        got = spatial._block1(tiles, [model] * 3)
    assert got.bounds == [b // 2 for b in bounds]
    assert torch.equal(got.gather(), whole)
    fwd = spatial.build_spatial_forward(model.eval(), spatial.spatial_mesh(8, cpus(8)))
    paf, heat = fwd(x.permute(0, 2, 3, 1))
    with torch.no_grad():
        want_paf, want_heat = model(x.permute(0, 2, 3, 1))[-1]
    assert paf.dtype == torch.float32
    torch.testing.assert_close(heat, want_heat, rtol=0.05, atol=0.05)


def test_spatial_estimator_matches_the_serial_process_on_a_large_image(request):
    """The reference's own test (``tests/test_spatial.py``) at a quarter of
    its area, so that it stays within its time: a 552x552 image at scales
    (0.5, 1.0) of boxsize 184 (the 1104x1104 image at boxsize 368, halved in
    each dimension; 1104 took 45 s on an 8-core CPU shared by the suite's
    workers), 1 stage at full width, over 8
    tiles: 12 and 23 output rows, uneven; the same people as the serial
    ``process``. The card runs 1104x1104 (``chip_smoke.py`` phase j).

    One intra-op thread: the two programs' maps agree within 3e-6 relative
    at any thread count, but at 2 and 4 threads the CPU convolutions round
    so that a near-tie in this noisy random scene flips one part of one of
    its 52 people, so the comparison of the decoded people is made where
    it does not depend on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    request.addfinalizer(lambda: torch.set_num_threads(threads))
    cfg = PoseConfig(model=ModelConfig(boxsize=184, num_stages=1, compute_dtype="float32"),
                     inference=InferenceConfig(scale_search=(0.5, 1.0)))
    est = PoseEstimator(cfg, device="cpu")
    with torch.no_grad():
        for branch in (est.model.stage1_L1, est.model.stage1_L2):
            branch.out.weight.mul_(3000.0)
    sp = spatial.SpatialPoseEstimator(est, spatial.spatial_mesh(8, cpus(8)))
    img = (np.random.default_rng(7).random((552, 552, 3)) * 255).astype(np.uint8)
    want = est.process(img)["people"]
    got = sp.process(img)["people"]
    assert len(want) > 0
    assert_same_people([got], [want], px=1, score_tol=1e-3)
    for p in got:
        assert all(0 <= kp["x"] < 552 and 0 <= kp["y"] < 552 for kp in p["keypoints"].values())
