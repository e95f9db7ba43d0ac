"""The port's data path (``tpupose_torch/data/``) against the JAX
package's (``tpupose/data/``), on the CPU, from the same seeded inputs.

Every comparison here is exact (``==``, ``np.array_equal``, equal file
bytes): the port's modules are copies of the reference's numpy code and
its host libraries are built from copies of the reference's C sources, so
nothing may differ. The cases: the OKS evaluator on the golden cases of
tests/test_coco_eval_golden.py and on a random scene; the RLE codec
(native, reference, the port's numpy twins); HDF5 files written by one
package and read by the other, and ``pad_sample``; ``.tpr`` files across
packages, ``read_batch_into`` against the plain ``_PyReader``, crc
corruption; ``coco_prep`` on one synthetic COCO set (a polygon crowd, an
RLE crowd, an under-annotated person, an unannotated image); the batches
of every feed, in order; the ``TprBatches`` state after a resume; the
feed position in a checkpoint, and the asynchronous saver.
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from tests import test_coco_eval_golden as golden
import tpupose.data as jdata
from tpupose.config import AugmentConfig as JAug, PoseConfig as JPose, TrainConfig as JTrain
from tpupose.data import coco_eval as jeval
from tpupose.data import coco_prep as jprep
from tpupose.data import hdf5 as jhdf5
from tpupose.data import pipeline as jpipe
from tpupose.data import rle as jrle
from tpupose.data import tpr as jtpr
import tpupose_torch.data as tdata
from tpupose_torch.config import AugmentConfig, PoseConfig, TrainConfig
from tpupose_torch.data import _native
from tpupose_torch.data import coco_eval as teval
from tpupose_torch.data import coco_prep as tprep
from tpupose_torch.data import hdf5 as thdf5
from tpupose_torch.data import pack_tpr
from tpupose_torch.data import pipeline as tpipe
from tpupose_torch.data import rle as trle
from tpupose_torch.data import tpr as ttpr
from tpupose_torch.models import OpenPose
from tpupose_torch.testing import coco_keypoint_set, limit_threads
from tpupose_torch.training import checkpoint, create_state

limit_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J_CFG = JPose(augment=JAug(max_persons=3), train=JTrain(batch_size=2))
T_CFG = PoseConfig(augment=AugmentConfig(max_persons=3), train=TrainConfig(batch_size=2))
GEOM = dict(target_h=64, target_w=64)


def assert_same(a, b, path="") -> None:
    """Exact equality of nested dicts / lists of arrays and scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)) and not isinstance(b, np.ndarray):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (path, a, b)


# --- COCO OKS evaluation ------------------------------------------------------


def _random_scene(seed=0):
    """8 images: 0-5 GT persons each (some keypoints absent, areas across
    the small/medium/large ranges, some crowd and keypointless ignore GT),
    jittered detections, false positives, and one image with 25 detections
    (past the 20-detection cap)."""
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for img in range(8):
        gt, dets = [], []
        for _ in range(int(rng.integers(0, 6))):
            kp = np.zeros((18, 3))
            kp[:, 0] = rng.uniform(0, 400, 18)
            kp[:, 1] = rng.uniform(0, 300, 18)
            kp[:, 2] = rng.choice([0.0, 1.0, 2.0], 18, p=[0.6, 0.2, 0.2])
            gt.append({"keypoints": kp, "area": float(rng.choice([400.0, 3000.0, 20000.0]))})
            jitter = rng.normal(0, rng.choice([1.0, 6.0, 30.0]), (18, 2))
            dets.append(golden.as_pred(kp + np.pad(jitter, ((0, 0), (0, 1))),
                                       float(rng.uniform(0.1, 1.0))))
        if img % 3 == 1:
            gt.append({"keypoints": golden.unlabelled_kps(), "area": 9000.0,
                       "iscrowd": int(img % 2), "num_keypoints": 0,
                       "bbox": [50.0, 60.0, 90.0, 80.0]})
        n_fp = 25 if img == 5 else int(rng.integers(0, 3))
        for _ in range(n_fp):
            kp = np.zeros((18, 3))
            kp[:, 0] = rng.uniform(0, 400, 18)
            kp[:, 1] = rng.uniform(0, 300, 18)
            dets.append(golden.as_pred(kp, float(rng.uniform(0.0, 1.0))))
        preds.append(dets)
        gts.append(gt)
    return preds, gts


def _eval_cases():
    gt1, gt2 = golden.person_kps(0.0), golden.person_kps(150.0)
    far = golden.person_kps(300.0)
    two = [{"keypoints": gt1, "area": 5000.0}, {"keypoints": gt2, "area": 5000.0}]
    return {
        "perfect": ([[golden.as_pred(gt1, 0.9), golden.as_pred(gt2, 0.8)]], [two]),
        "partial": ([[golden.as_pred(gt1, 0.9, dx=4.0), golden.as_pred(gt2, 0.7, dx=15.0)]],
                    [two]),
        "false positive": ([[golden.as_pred(far, 0.95), golden.as_pred(gt1, 0.9)]], [two]),
        "crowd": golden._crowd_scene(1),
        "keypointless": golden._crowd_scene(0),
        "num_keypoints 0": ([[golden.as_pred(gt1, 0.9)]],
                            [[two[0], {**two[1], "num_keypoints": 0}]]),
        "random": _random_scene(),
    }


@pytest.mark.parametrize("case", list(_eval_cases()))
def test_evaluate_equals_the_reference(case):
    preds, gts = _eval_cases()[case]
    got = teval.evaluate(preds, gts)
    assert_same(got, jeval.evaluate(preds, gts))
    assert got["AP"] >= 0.0


def test_oks_and_bootstrap_equal_the_reference():
    rng = np.random.default_rng(1)
    for _ in range(50):
        pred, gt = rng.uniform(0, 200, (18, 3)), rng.uniform(0, 200, (18, 3))
        gt[:, 2] = rng.choice([0.0, 1.0, 2.0], 18)
        bbox = rng.uniform(0, 100, 4) if rng.random() < 0.5 else None
        if rng.random() < 0.3:
            gt[:, 2] = 2.0                       # the bbox fallback of ignore GT
        area = float(rng.uniform(10, 5000))
        assert teval.oks(pred, gt, area, bbox=bbox) == jeval.oks(pred, gt, area, bbox=bbox)
    preds, gts = _random_scene(2)
    worse = [p[::2] for p in preds]
    sets = {"all": preds, "half": worse}
    got = teval.bootstrap(sets, gts, n_boot=50, seed=3)
    assert_same(got, jeval.bootstrap(sets, gts, n_boot=50, seed=3))


# --- RLE ----------------------------------------------------------------------


def _masks():
    rng = np.random.default_rng(11)
    blob = np.zeros((64, 48), np.uint8)
    blob[10:40, 5:30] = 1
    return [(rng.uniform(size=(37, 53)) > 0.6).astype(np.uint8), np.zeros((16, 16), np.uint8),
            np.ones((16, 16), np.uint8), blob, (rng.uniform(size=(300, 200)) > 0.97).astype(np.uint8)]


@pytest.mark.parametrize("i", range(len(_masks())))
def test_rle_native_equals_the_reference_and_the_numpy_twins(i):
    m = _masks()[i]
    other = _masks()[(i + 1) % 5][: m.shape[0], : m.shape[1]]
    counts = trle.encode(m)
    assert_same(counts, jrle.encode(m))
    assert_same(counts, trle.encode_np(m))
    s = trle.to_string(counts)
    assert s == jrle.to_string(counts) == trle.to_string_np(counts)
    for back in (trle.from_string(s), trle.from_string_np(s), trle.from_string(s.decode())):
        assert_same(back, counts)
    for dec in (trle.decode(counts, *m.shape), trle.decode_np(counts, *m.shape)):
        assert_same(dec, jrle.decode(counts, *m.shape))
        assert np.array_equal(dec, m)
    for obj in ({"size": list(m.shape), "counts": s.decode()},
                {"size": list(m.shape), "counts": counts.tolist()}):
        assert_same(trle.decode_coco(obj), jrle.decode_coco(obj))
    assert trle.area(counts) == trle.area_np(counts) == jrle.area(counts) == int(m.sum())
    if other.shape == m.shape:
        assert_same(trle.merge([m, other]), jrle.merge([m, other]))


def test_rle_malformed_input_raises():
    for decode in (trle.decode, trle.decode_np):
        with pytest.raises(ValueError, match="malformed"):
            decode(np.asarray([3, 4], np.uint32), 4, 4)
    for from_string in (trle.from_string, trle.from_string_np):
        with pytest.raises(ValueError, match="malformed"):
            from_string(b"P")                        # a continuation byte with nothing after


def test_host_libraries_build_into_the_port_and_a_failed_build_raises(tmp_path, monkeypatch):
    assert trle.native_available() and ttpr.native_available()
    for lib in (trle._load(), ttpr._load()):
        assert os.path.dirname(lib._name) == _native.BUILD_DIR
        assert _native.BUILD_DIR == os.path.join(REPO, "tpupose_torch", "_build")
    (tmp_path / "broken.c").write_text("int f( {\n")
    monkeypatch.setattr(_native, "NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="broken.c failed") as err:
        _native.load("broken", "broken.c", ["cc", "-O2", "-shared", "-fPIC"])
    assert "error" in str(err.value)
    assert not os.listdir(tmp_path / "build")
    with pytest.raises(RuntimeError, match="not found"):
        _native.load("broken", "broken.c", [str(tmp_path / "no-such-cc")])


# --- HDF5 and pad_sample ---------------------------------------------------------


def _samples(n=6, seed=0, shapes=((96, 112), (40, 50), (130, 70))):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        p = int(rng.integers(1, 5))
        joints = rng.uniform(-10, max(h, w) + 10, (p, 18, 3)).astype(np.float32)
        joints[:, :, 2] = rng.choice([0.0, 1.0, 2.0], (p, 18))
        s = {
            "image": rng.integers(0, 255, (h, w, 3), dtype=np.uint8),
            "mask": rng.integers(0, 255, (h, w), dtype=np.uint8),
            "joints": joints,
            "center": rng.uniform(0, w, 2).astype(np.float32),
            "scale_provided": np.float32(rng.uniform(0.4, 1.2)),
            "areas": rng.uniform(50, 500, p).astype(np.float32),
            "image_id": 500 + i,
        }
        if i % 2:
            s["ignore_regions"] = [[1.0, 2.0, 30.0, 20.0, 400.0]]
        out.append(s)
    return out


def _write_h5(mod, path, samples):
    with mod.SampleWriter(path) as w:
        for s in samples:
            w.add(s["image"], s["mask"], s["joints"], s["center"], s["scale_provided"],
                  areas=s["areas"], image_id=s["image_id"],
                  ignore_regions=s.get("ignore_regions"))


def _write_upstream_h5(path):
    import h5py

    rng = np.random.default_rng(4)
    h, w = 96, 80
    packed = np.concatenate([rng.integers(0, 255, (h, w, 3)), np.full((h, w, 1), 255)], axis=2)

    def coco_kps(offset):
        return [[20.0 + 2 * i + offset, 30.0 + i, 2.0 if i % 3 else 1.0] for i in range(17)]

    meta = {"objpos": [40.0, 48.0], "scale_provided": 0.75, "joint_self": coco_kps(0.0),
            "joint_others": [coco_kps(15.0)], "segment_area": 1234.0,
            "segment_area_other": [777.0]}
    with h5py.File(path, "w") as f:
        ds = f.create_group("datum").create_dataset("0000000", data=packed.astype(np.uint8))
        ds.attrs["meta"] = json.dumps(meta)


@pytest.mark.parametrize("writer", ["reference", "port", "upstream layout"])
def test_hdf5_round_trip_across_packages(tmp_path, writer):
    path = str(tmp_path / "ds.h5")
    if writer == "upstream layout":
        _write_upstream_h5(path)
    else:
        _write_h5(jhdf5 if writer == "reference" else thdf5, path, _samples())
    for seed in (None, 3):
        got = list(thdf5.read_samples(path, shuffle_seed=seed))
        assert_same(got, list(jhdf5.read_samples(path, shuffle_seed=seed)))
    assert thdf5.num_samples(path) == jhdf5.num_samples(path) == len(got)
    assert_same(list(tdata.read_samples(path, shuffle_seed=3)), got)
    if writer == "port":
        assert_same([s["image_id"] for s in thdf5.read_samples(path)],
                    [s["image_id"] for s in _samples()])


@pytest.mark.parametrize("shape, persons, max_persons, float_mask", [
    ((500, 200), 6, 4, False),       # taller than the target: fit-downscaled
    ((100, 80), 2, 4, False),        # smaller: letterboxed
    ((720, 1280), 3, 24, True),      # a 720p frame, a [0, 1] float mask
    ((368, 368), 0, 4, False),       # exactly the target, nobody in it
])
def test_pad_sample_bit_equal(shape, persons, max_persons, float_mask):
    rng = np.random.default_rng(sum(shape) + persons)
    s = _samples(1, seed=persons, shapes=(shape,))[0]
    s["joints"] = rng.uniform(-20, max(shape) + 20, (persons, 18, 3)).astype(np.float32)
    s["areas"] = rng.uniform(100, 900, persons).astype(np.float32)
    if float_mask:
        s["mask"] = rng.uniform(0, 1, shape).astype(np.float32)
    got = thdf5.pad_sample(s, 368, 368, max_persons)
    assert_same(got, jhdf5.pad_sample(s, 368, 368, max_persons))
    assert got["image"].shape == (368, 368, 3) and got["joints"].shape == (max_persons, 18, 3)


# --- .tpr ---------------------------------------------------------------------------


@pytest.mark.parametrize("compression", ["zlib", "none"])
def test_tpr_bytes_and_records_across_packages(tmp_path, compression):
    samples = _samples(8)
    ref, port = str(tmp_path / "ref.tpr"), str(tmp_path / "port.tpr")
    assert jtpr.write_samples(ref, samples, compression=compression) == 8
    assert ttpr.write_samples(port, samples, compression=compression) == 8
    with open(ref, "rb") as a, open(port, "rb") as b:
        assert a.read() == b.read()
    assert ttpr.num_samples(ref) == 8
    for seed in (None, 5):
        assert_same(list(ttpr.read_samples(ref, shuffle_seed=seed)),
                    list(jtpr.read_samples(port, shuffle_seed=seed)))
    assert_same(list(tdata.read_samples(ref)), list(jtpr.read_samples(ref)))
    idx = [5, 0, 3]
    with ttpr.TprReader(ref) as r, jtpr.TprReader(ref) as j:
        twin = ttpr._PyReader(ref)
        assert (r.count, r.flags, r.static_shapes) == (j.count, j.flags, j.static_shapes)
        for i in range(8):
            assert r.dims(i) == j.dims(i) == twin.dims(i)
            assert r.meta(i) == j.meta(i) == json.loads(twin.meta_bytes(i))
        h, w = r.dims(0)
        imgs = np.zeros((3, h * w * 3 + 17), np.uint8)       # rows longer than a record
        masks = np.zeros((3, h * w + 5), np.uint8)
        r.read_batch_into(idx, imgs, masks, threads=3)
        for k, i in enumerate(idx):
            hi, wi = r.dims(i)
            want_img, want_mask = np.zeros(imgs.shape[1], np.uint8), np.zeros(masks.shape[1], np.uint8)
            twin.read_into(i, want_img, want_mask)
            assert np.array_equal(imgs[k], want_img) and np.array_equal(masks[k], want_mask)
            img, mask = r.read(i)
            assert np.array_equal(imgs[k, : hi * wi * 3], img.reshape(-1))
            assert np.array_equal(img, samples[i]["image"])
        twin.close()
    r.close()
    with pytest.raises(ValueError, match="closed"):
        r.read(0)


@pytest.mark.parametrize("compression", ["zlib", "none"])
def test_tpr_payload_corruption_raises(tmp_path, compression):
    path = str(tmp_path / "c.tpr")
    samples = _samples(4, seed=3)
    ttpr.write_samples(path, samples, compression=compression)
    with open(path, "rb") as f:
        good = f.read()
    _, flags, _, count, index_off = ttpr.HEADER.unpack_from(good, 0)
    entries = [ttpr.ENTRY.unpack_from(good, index_off + i * ttpr.ENTRY.size) for i in range(count)]
    rng = np.random.default_rng(0)
    for i, e in enumerate(entries):
        for off, csize in ((e[0], e[1]), (e[3], e[4])):      # image, mask payloads
            raw = bytearray(good)
            raw[off + int(rng.integers(0, csize))] ^= 0xFF
            with open(path, "wb") as f:
                f.write(bytes(raw))
            with ttpr.TprReader(path) as r:
                with pytest.raises(ValueError, match="crc32|inflate|malformed"):
                    r.read(i)
            twin = ttpr._PyReader(path)
            h, w = twin.dims(i)
            with pytest.raises(ValueError, match="crc32|inflate|malformed"):
                twin.read_into(i, np.zeros(h * w * 3, np.uint8), np.zeros(h * w, np.uint8))
            twin.close()
    with open(path, "wb") as f:
        f.write(b"TPRECv01" + b"\0" * 8)
    with pytest.raises(ValueError, match="cannot open"):
        ttpr.TprReader(path)


# --- coco_prep --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def coco_set(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("coco"))
    shapes = [(96, 128), (120, 90), (100, 100), (96, 128), (140, 200), (64, 80)]
    return coco_keypoint_set(d, shapes, seed=5)


def test_coco_prep_records_and_eval_images_equal_the_reference(coco_set):
    ann, images = coco_set
    got = list(tprep.iter_records(ann, images, boxsize=368))
    assert len(got) >= 5
    assert_same(got, list(jprep.iter_records(ann, images, boxsize=368)))
    evals = list(tprep.iter_eval_images(ann, images))
    assert_same(evals, list(jprep.iter_eval_images(ann, images)))
    by_id = {r["image_id"]: r for r in evals}
    assert len(by_id) == 6 and by_id[1005]["gt"] == [] and by_id[1005]["ignore_regions"] == []
    # the polygon crowd (image 1) and the RLE crowd (image 2): ignore GT, and
    # zeroed in the miss-mask of every record of their image
    with open(ann) as f:
        crowds = {a["image_id"]: a for a in json.load(f)["annotations"] if a["iscrowd"]}
    assert isinstance(crowds[1001]["segmentation"], list)
    assert isinstance(crowds[1002]["segmentation"]["counts"], str)
    for image_id, crowd in crowds.items():
        x, y, w, h = (int(v) for v in crowd["bbox"])
        assert by_id[image_id]["ignore_regions"] == [[float(v) for v in crowd["bbox"]]
                                                     + [float(crowd["area"])]]
        recs = [r for r in got if r["image_id"] == image_id]
        assert recs and all((r["mask"][y + 1:y + h - 1, x + 1:x + w - 1] == 0).all()
                            and r["mask"].max() == 255 for r in recs)


def test_coco_prep_helpers_equal_the_reference():
    rng = np.random.default_rng(2)
    for _ in range(20):
        kps = np.stack([rng.uniform(0, 300, 17), rng.uniform(0, 300, 17),
                        rng.choice([0, 1, 2], 17)], axis=1).reshape(-1).tolist()
        assert_same(tprep.coco_joints_to_parts(kps), jprep.coco_joints_to_parts(kps))
    people = [golden.as_pred(golden.person_kps(10.0 * i), 0.5 + 0.1 * i) for i in range(3)]
    people[1]["keypoints"].pop("nose")
    assert tprep.people_to_coco_results(people, 7) == jprep.people_to_coco_results(people, 7)
    h, w = 50, 60
    anns = [{"iscrowd": 1, "segmentation": [[5, 5, 30, 5, 30, 40, 5, 40]]},
            {"num_keypoints": 2, "segmentation": {"size": [h, w], "counts": "0" * 3}},
            {"num_keypoints": 9, "segmentation": [[0, 0, 9, 0, 9, 9]]}]
    mask = trle.decode_np(np.asarray([700, 900, 1400], np.uint32), h, w)
    anns[1]["segmentation"]["counts"] = trle.to_string_np(trle.encode_np(mask)).decode()
    assert_same(tprep.miss_mask_for_image(anns, h, w), jprep.miss_mask_for_image(anns, h, w))


@pytest.mark.parametrize("ext", [".tpr", ".h5"])
def test_pack_equals_the_reference(tmp_path, coco_set, ext):
    ann, images = coco_set
    ref, port = str(tmp_path / f"ref{ext}"), str(tmp_path / f"port{ext}")
    n = tprep.pack(ann, images, port)
    assert n == jprep.pack(ann, images, ref) >= 5
    if ext == ".tpr":
        with open(ref, "rb") as a, open(port, "rb") as b:
            assert a.read() == b.read()
    got = list(tdata.read_samples(port))
    assert [r["image_id"] for r in got] == [r["image_id"] for r in tprep.iter_records(ann, images)]
    assert_same(got, list(jdata.read_samples(ref)))
    assert_same(list(tdata.read_samples(ref)), got)


# --- the feeds -----------------------------------------------------------------------


def _reference_pack_tool():
    spec = importlib.util.spec_from_file_location("reference_pack_tpr",
                                                  os.path.join(REPO, "tools", "pack_tpr.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def feed_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("feeds")
    samples = _samples(11, seed=8)
    files = {"h5": str(d / "ds.h5"), "tpr": str(d / "ds.tpr"), "fast": str(d / "fast.tpr"),
             "fast_ref": str(d / "fast_ref.tpr")}
    _write_h5(jhdf5, files["h5"], samples)
    jtpr.write_samples(files["tpr"], samples)
    args = ["--input", files["h5"], "--pre-pad", "64", "64", "--max-persons", "3"]
    assert pack_tpr.main([*args, "--output", files["fast"]]) == 0
    assert _reference_pack_tool().main([*args, "--output", files["fast_ref"]]) == 0
    return files


def test_pack_tpr_writes_the_reference_tools_bytes(feed_files, capsys):
    with open(feed_files["fast"], "rb") as a, open(feed_files["fast_ref"], "rb") as b:
        assert a.read() == b.read()
    with ttpr.TprReader(feed_files["fast"]) as r:
        assert r.static_shapes and r.count == 11 and r.dims(0) == (64, 64)
        assert r.meta(0)["prepadded"] == {"max_persons": 3}


def _take(feed, n=None):
    out = list(feed) if n is None else [next(feed) for _ in range(n)]
    if hasattr(feed, "close"):
        feed.close()
    return out


@pytest.mark.parametrize("shard, workers", [(None, 1), (None, 4), ((0, 2), 4), ((1, 2), 1),
                                            ((1, 3), 4)])
def test_hdf5_batches_equal_the_reference(feed_files, shard, workers):
    kw = dict(GEOM, epochs=2, shuffle_seed=0, num_workers=workers, shard=shard)
    got = _take(tpipe.hdf5_batches(feed_files["h5"], T_CFG, **kw))
    # the epochs run on into each other; each shard reads 11 // count a epoch
    assert len(got) == 2 * (11 // (shard[1] if shard else 1)) // 2
    assert_same(got, _take(jpipe.hdf5_batches(feed_files["h5"], J_CFG, **kw)))


@pytest.mark.parametrize("path, shard, workers", [
    ("fast", None, 1), ("fast", (1, 2), 1), ("generic", None, 1), ("generic", None, 4),
    ("generic", (0, 2), 4)])
def test_tpr_batches_equal_the_reference(feed_files, path, shard, workers):
    f = feed_files["fast" if path == "fast" else "tpr"]
    kw = dict(GEOM, epochs=2, shuffle_seed=1, num_workers=workers, shard=shard, threads=3)
    feed = tpipe.tpr_batches(f, T_CFG, **kw)
    assert isinstance(feed, tpipe.TprBatches) == (path == "fast")
    assert tpipe.is_checkpointable(feed) == (path == "fast")
    got = _take(feed)
    per_epoch = 11 // (shard[1] if shard else 1)
    # TprBatches batches each epoch apart; the generic path runs them on
    assert len(got) == (2 * (per_epoch // 2) if path == "fast" else 2 * per_epoch // 2)
    assert_same(got, _take(jpipe.tpr_batches(f, J_CFG, **kw)))
    assert_same(_take(tpipe.dataset_batches(f, T_CFG, **kw)), got)


def test_tpr_batches_state_resumes_as_the_reference(feed_files):
    def feeds():
        kw = dict(GEOM, epochs=3, shuffle_seed=4)
        return (tpipe.dataset_batches(feed_files["fast"], T_CFG, **kw),
                jpipe.dataset_batches(feed_files["fast"], J_CFG, **kw))

    port, ref = feeds()
    whole = _take(ref, 15)                                   # uninterrupted
    head = [next(port) for _ in range(7)]
    state = port.get_state()
    port.close()
    port, ref = feeds()
    ref_head = [next(ref) for _ in range(7)]
    assert ref.get_state() == state                          # the same bytes
    tail_ref = _take(ref, 8)
    port.set_state(state)
    tail = _take(port, 8)
    assert_same(head + tail, whole)
    assert_same(ref_head + tail_ref, whole)
    assert json.loads(state) == {"epoch": 1, "offset": 4, "version": 1}   # mid-epoch
    assert not tpipe.is_checkpointable(iter(whole))


def test_shard_auto_reads_the_process_group(feed_files, monkeypatch):
    assert tpipe.process_shard() == (0, 1)
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 3)
    assert tpipe.process_shard() == (1, 3)
    kw = dict(GEOM, epochs=1, shuffle_seed=0)
    for path in ("h5", "fast"):
        got = _take(tpipe.dataset_batches(feed_files[path], T_CFG, shard="auto", **kw))
        assert_same(got, _take(jpipe.dataset_batches(feed_files[path], J_CFG, shard=(1, 3),
                                                     **kw)))


def test_batch_samples_and_prefetch_equal_the_reference():
    samples = _samples(9, seed=6)
    for workers in (1, 4):
        kw = dict(batch_size=2, target_h=64, target_w=64, max_persons=3, num_workers=workers)
        for drop in (True, False):
            got = list(tpipe.batch_samples(iter(samples), drop_remainder=drop, **kw))
            assert len(got) == (4 if drop else 5)
            assert_same(got, list(jpipe.batch_samples(iter(samples), drop_remainder=drop, **kw)))

    def failing():
        yield 1
        raise RuntimeError("boom")

    it = tpipe.prefetch(failing())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


# --- the feed position in a checkpoint, and the asynchronous saver -------------------


def _state_tree(seed=0):
    model = OpenPose(num_stages=1, dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    cfg = dataclasses.replace(T_CFG, model=dataclasses.replace(T_CFG.model, num_stages=1))
    return create_state(cfg, model.state_dict(), device="cpu")[0].tree()


def test_checkpoint_holds_the_feed_position(tmp_path, feed_files):
    d = str(tmp_path / "ckpt")

    def feed():
        return tpipe.dataset_batches(feed_files["fast"], T_CFG, epochs=2, shuffle_seed=2, **GEOM)

    whole = _take(feed(), 6)
    first = feed()
    head = [next(first) for _ in range(3)]
    tree = _state_tree()
    tree["step"] = 3
    assert checkpoint.save(d, tree, data_iter=first) == 3
    first.close()
    with np.load(os.path.join(d, "step_000000003.npz")) as f:
        assert f["data_state"].dtype == np.uint8
        assert json.loads(f["data_state"].tobytes())["offset"] == 6
    again = feed()
    restored = checkpoint.restore(d, _state_tree(seed=1), data_iter=again)
    assert restored["step"] == 3
    for name, p in tree["params"].items():
        assert torch.equal(restored["params"][name], p), name
    assert_same(head + _take(again, 3), whole)
    # a checkpoint without a position restores the model and leaves the feed alone
    tree["step"] = 4
    checkpoint.save(d, tree)
    fresh = feed()
    assert checkpoint.restore(d, _state_tree(), data_iter=fresh)["step"] == 4
    assert_same(_take(fresh, 2), whole[:2])
    assert checkpoint.restore_params(d)["vgg"]["conv1_1"]["kernel"].shape == (3, 3, 3, 64)


def test_async_saver_returns_before_the_write_and_restore_waits(tmp_path, monkeypatch):
    d = str(tmp_path / "ckpt")
    tree = _state_tree()
    started, release = checkpoint.threading.Event(), checkpoint.threading.Event()
    write = checkpoint._write

    def slow_write(*args):
        started.set()
        assert release.wait(timeout=60)
        write(*args)

    monkeypatch.setattr(checkpoint, "_write", slow_write)
    saver = checkpoint.AsyncSaver(d, max_to_keep=2)
    name = "stage1_L1.conv1.bias"
    want = tree["params"][name].clone()
    assert saver.save(tree, step=7) == 7 and saver.last_saved == 7
    assert started.wait(timeout=60)
    tree["params"][name].add_(1.0)          # the live tensors move on; the copy does not
    assert not os.path.exists(os.path.join(d, "step_000000007.npz"))
    release.set()
    assert checkpoint.latest_step(d) == 7   # waits for the pending write
    restored = checkpoint.restore(d, _state_tree(seed=3))
    assert torch.equal(restored["params"][name], want)
    for step in (8, 9):
        saver.save(tree, step=step)
    saver.close()
    assert sorted(os.listdir(d)) == ["step_000000008.npz", "step_000000009.npz"]
    assert not [f for f in os.listdir(d) if "tmp" in f]
    monkeypatch.setattr(checkpoint, "_write", write)
    bad = checkpoint.AsyncSaver(str(tmp_path / "file"))
    (tmp_path / "file").write_text("not a directory")
    bad.save(tree, step=1)
    with pytest.raises(OSError):
        bad.wait()
    bad.close()                              # the error is raised once
