"""The port's host-side modules around the estimator against the JAX
package's: shape buckets (``buckets.py``), the tracker (``tracking.py``)
and the numpy decode twin (``reference_impl/decode_np.py``).

These are numpy / pure-Python modules, so the port's copies are held to
the originals value for value; the ``BucketedRunner``s run over the two
packages' small estimators (boxsize 64, 2 stages, f32, the same bridged
parameters) on images of mixed shapes and must choose the same buckets,
hand their estimators the same canvases and ``valid_hw`` in the same
order, and return the same people (coordinates equal, scores within
1e-4, the tolerance of tests/test_torch_infer.py).
"""

import sys
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpupose.buckets as jbuckets
import tpupose.tracking as jtracking
import tpupose_torch.buckets as tbuckets
import tpupose_torch.tracking as ttracking
from tpupose.config import InferenceConfig, ModelConfig, PoseConfig
from tpupose.infer import PoseEstimator as JaxEstimator
from tpupose.models import OpenPose as JaxOpenPose
from tpupose.ops.image import scale_sizes
from tpupose.reference_impl import decode_np as jdecode_np
from tpupose_torch.infer import PoseEstimator
from tpupose_torch.ops import image as timage
from tpupose_torch.reference_impl import decode_np as tdecode_np
from tpupose_torch.testing import limit_threads, planted_scene

limit_threads()

SHAPES = [(368, 368), (300, 400), (480, 640), (640, 480), (1080, 1920), (200, 900), (37, 41),
          (656, 496), (700, 100)]


def test_bucket_ladder_and_parsing_equal_the_reference():
    assert tbuckets.DEFAULT_BUCKETS == jbuckets.DEFAULT_BUCKETS
    assert tbuckets.GRAY_PAD == jbuckets.GRAY_PAD == 128
    for spec in ("368x368,368x496", " 64X96 , 96x64,", "8x8"):
        assert tbuckets.parse_buckets(spec) == jbuckets.parse_buckets(spec)
    for spec in (None, "", "default", "368x368"):
        assert tbuckets.resolve_buckets(spec) == jbuckets.resolve_buckets(spec)
    for bad in ("", "368", "3x4x5", " , "):
        with pytest.raises(ValueError):
            tbuckets.parse_buckets(bad)
        with pytest.raises(ValueError):
            jbuckets.parse_buckets(bad)


@pytest.mark.parametrize("hw", SHAPES)
def test_choose_bucket_equals_the_reference(hw):
    for ladder in (jbuckets.DEFAULT_BUCKETS, ((64, 64), (64, 96), (96, 64))):
        assert tbuckets.choose_bucket(*hw, ladder) == jbuckets.choose_bucket(*hw, ladder)


@pytest.mark.parametrize("use_cv2", [True, False])
def test_to_bucket_equals_the_reference(use_cv2, monkeypatch):
    """With cv2 and with the numpy 2-tap kernel (cv2 made unimportable)."""
    if not use_cv2:
        monkeypatch.setitem(sys.modules, "cv2", None)
    rng = np.random.default_rng(0)
    for h, w in ((300, 400), (368, 368), (700, 500), (90, 1000)):
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        bh, bw, s = jbuckets.choose_bucket(h, w, jbuckets.DEFAULT_BUCKETS)
        want = jbuckets.to_bucket(img, bh, bw, s)
        got = tbuckets.to_bucket(img, bh, bw, s)
        assert got[1:] == want[1:]
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].shape == (bh, bw, 3) and (got[0][got[1]:] == 128).all()
    small = rng.integers(0, 256, (40, 60, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tbuckets._resize_host(small, 23, 31),
                                  jbuckets._resize_host(small, 23, 31))


def test_unscale_people_equals_the_reference():
    people = [{"keypoints": {"nose": {"x": 10.0, "y": 20.0, "score": 0.5},
                             "neck": {"x": 3.0, "y": 7.0, "score": 0.25}},
               "score": 1.5, "num_parts": 2}]
    for scale in (1.0, 0.5, 0.8203125):
        assert tbuckets.unscale_people(people, scale) == jbuckets.unscale_people(people, scale)
    assert tbuckets.unscale_people(people, 0.5)[0]["keypoints"]["nose"]["x"] == 20.0


# --- the runners over the two estimators -----------------------------------------------

CFG = PoseConfig(model=ModelConfig(boxsize=64, num_stages=2, compute_dtype="float32"),
                 inference=InferenceConfig(max_peaks=16, peak_compact_tiers=(8,)))
LADDER = ((64, 64), (64, 96))


@lru_cache(maxsize=1)
def _params():
    params = JaxOpenPose(num_stages=2, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"]
    params = jax.tree.map(np.asarray, params)
    for branch in ("stage2_L1", "stage2_L2"):
        params[branch]["out"]["kernel"] = params[branch]["out"]["kernel"] * 3000.0
    return params


class _Spy:
    """An estimator that records what the runner hands it."""

    def __init__(self, est):
        self._est = est
        self.calls = []

    def process_batch_async(self, imgs, scales=None, valid_hw=None):
        self.calls.append((np.array(imgs), scales, np.array(valid_hw)))
        return self._est.process_batch_async(imgs, scales=scales, valid_hw=valid_hw)

    def _finish(self, n, tables):
        return self._est._finish(n, tables)


def test_bucketed_runner_matches_reference_runner():
    rng = np.random.default_rng(1)
    shapes = [(64, 64), (50, 90), (120, 100), (40, 96), (64, 60)]
    images = [rng.integers(0, 256, (*hw, 3)).astype(np.uint8) for hw in shapes]
    jspy = _Spy(JaxEstimator(CFG, params=jax.tree.map(jnp.asarray, _params())))
    tspy = _Spy(PoseEstimator(CFG, params=_params(), device="cpu"))
    kw = dict(buckets=LADDER, scales=(1.0,), batch_size=2, depth=1)
    want = jbuckets.BucketedRunner(jspy, **kw).process_many(images)
    runner = tbuckets.BucketedRunner(tspy, **kw)
    got = runner.process_many(images)

    assert len(jspy.calls) == len(tspy.calls) == 3      # (64,64) x2, (64,96) x2, a padded rest
    for (ji, js, jv), (ti, ts, tv) in zip(jspy.calls, tspy.calls):
        assert js == ts == (1.0,)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tv, jv)
        assert ti.shape[0] == 2 and ti.dtype == np.uint8 and tv.dtype == np.int32
    assert len(got) == len(want) == len(images)
    assert sum(len(p) for p in want) >= 3
    for pg, pw in zip(got, want):
        assert len(pg) == len(pw)
        for a, b in zip(pg, pw):
            assert a["num_parts"] == b["num_parts"]
            assert sorted(a["keypoints"]) == sorted(b["keypoints"])
            np.testing.assert_allclose(a["score"], b["score"], rtol=1e-5, atol=1e-4)
            for name, kp in a["keypoints"].items():
                assert (kp["x"], kp["y"]) == (b["keypoints"][name]["x"], b["keypoints"][name]["y"])
                np.testing.assert_allclose(kp["score"], b["keypoints"][name]["score"],
                                           rtol=1e-5, atol=1e-4)
    # the 120x100 image was downscaled by 64/120: its keypoints come back in
    # its own pixels, whole canvas pixels times 120/64
    assert jbuckets.choose_bucket(120, 100, LADDER) == (64, 64, 64 / 120)
    on_canvas = [kp["x"] * 64 / 120 for p in got[2] for kp in p["keypoints"].values()]
    assert all(abs(x - round(x)) < 1e-9 for x in on_canvas)
    assert on_canvas
    # a finished runner starts afresh
    again = runner.process_many(images[:1])
    assert len(again) == 1 and len(again[0]) == len(got[0])


# --- tracker -------------------------------------------------------------------------

def _person(cx, cy, names=("nose", "neck", "Rsho", "Lsho"), score=1.0):
    offsets = {"nose": (0, -30), "neck": (0, 0), "Rsho": (-20, 0), "Lsho": (20, 0)}
    return {"keypoints": {n: {"x": cx + offsets[n][0], "y": cy + offsets[n][1], "score": 0.9}
                          for n in names},
            "score": score, "num_parts": len(names)}


def _script():
    """Two people walking, one of them hidden for a while, a newcomer, a
    sparse detection, an empty frame."""
    frames = []
    for t in range(12):
        people = [_person(100 + 4 * t, 200 + t)]
        if not 3 <= t <= 7:
            people.append(_person(300 - 3 * t, 180))
        if t >= 9:
            people.append(_person(500, 90 + 2 * t, names=("nose", "neck")))
        if t == 5:
            people = []
        if t == 10:
            people.append({"keypoints": {}, "score": 0.0, "num_parts": 0})
        frames.append(people[::-1] if t % 2 else people)
    return frames


@pytest.mark.parametrize("kw", [{}, {"smoothing": 0.5}, {"max_missed": 2},
                                {"max_cost": 0.05, "min_diag": 8.0}])
def test_pose_tracker_equals_the_reference(kw):
    want_tr, got_tr = jtracking.PoseTracker(**kw), ttracking.PoseTracker(**kw)
    ids = []
    for people in _script():
        want = want_tr.update(people)
        got = got_tr.update(people)
        assert got == want
        ids.append([p["track_id"] for p in got])
    assert ids[0] == [0, 1] and len({i for frame in ids for i in frame}) >= 3
    if kw.get("max_missed") == 2:
        assert 1 not in ids[8]       # hidden for 5 frames: retired, a new id on return
    with pytest.raises(ValueError):
        ttracking.PoseTracker(smoothing=1.0)


# --- the numpy twin ------------------------------------------------------------------

def _code(module):
    with open(module.__file__) as f:
        src = f.read()
    return src[src.index("def find_peaks_np"):]


def test_decode_np_copy_equals_the_original():
    assert _code(tdecode_np) == _code(jdecode_np)
    sizes = scale_sizes(368, 368, (0.5, 1.0, 1.5, 2.0), 368, 8)
    heats, pafs = planted_scene(sizes)

    heat = timage.average_upsampled(heats, sizes, 368, 368, 8)[0].numpy()
    paf = timage.average_upsampled(pafs, sizes, 368, 368, 8)[0].numpy()
    want = jdecode_np.decode_np(heat, paf)
    got = tdecode_np.decode_np(heat, paf)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    people = tdecode_np.people_json(*got)
    assert people == jdecode_np.people_json(*want)
    assert len(people) == 2 and all(p["num_parts"] == 18 for p in people)
