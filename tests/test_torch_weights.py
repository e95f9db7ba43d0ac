"""The port's reference-weight loaders (``tpupose_torch/models/weights.py``,
``models/caffe.py``) and ``PoseEstimator(weights_path=)`` against the JAX
package's, on the same files.

The files are written here from seeded numpy draws: a Keras ``.h5`` (the
``model_weights/<layer>/<layer>/kernel:0`` layout of a Keras save), a
new-style and a legacy ``.caffemodel`` (a small protobuf writer, a
test-side twin of the wire format independent of the parsers), and a torch
``.pth`` keyed by Caffe layer names under a ``state_dict`` wrapper with a
non-conv entry beside them. One set covers the full-width model (weights
only), one a 2-stage model. Each file is loaded by
``tpupose.models.weights.load_reference_weights`` onto the JAX init and by
the port's loader onto the port's tree: the port's tree, through its
``state_dict``, equals the JAX tree bit for bit and the ``missing`` lists
are equal. The estimators are held to each other on one image at
``tests/test_torch_infer.py``'s tolerance (coordinates equal, scores
within rtol 1e-5, atol 1e-4).
"""

import json
import warnings
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupose.config import InferenceConfig, ModelConfig, PoseConfig
from tpupose.infer import PoseEstimator as JaxEstimator
from tpupose.models import OpenPose as JaxOpenPose
from tpupose.models import weights as jweights
from tpupose_torch.infer import PoseEstimator
from tpupose_torch.models import OpenPose
from tpupose_torch.models import weights as tweights
from tpupose_torch.testing import limit_threads

limit_threads()

# the serving tests' small configuration (tests/test_serve.py), with the tier
# ladders below max_peaks as the CLI's --max-peaks builds them: the
# reference's decode equals its full-capacity semantics, which the port
# implements, only for such ladders (with the default ladders at max_peaks
# 16 it assembles other people)
SMALL = dict(model=dict(num_stages=1, compute_dtype="float32"),
             inference=dict(scale_search=(0.5,), max_peaks=16, max_people=16,
                            pair_tiers=(8,), peak_compact_tiers=(8,)))


# --- a tiny protobuf encoder (test-side twin of the wire format) ----------------
def _varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _blob(data: np.ndarray, legacy_shape: bool) -> bytes:
    msg = bytearray()
    if legacy_shape:
        shape4 = list(data.shape) + [1] * (4 - data.ndim)
        for f, d in zip((1, 2, 3, 4), shape4):
            msg += _key(f, 0) + _varint(d)
    else:
        shape_msg = b"".join(_key(1, 0) + _varint(d) for d in data.shape)
        msg += _len_delim(7, shape_msg)
    msg += _len_delim(5, np.asarray(data, "<f4").tobytes())  # packed data
    return bytes(msg)


def _layer(name: str, blobs: list[np.ndarray], legacy: bool) -> bytes:
    if legacy:  # V1LayerParameter: name=4, blobs=6
        msg = _len_delim(4, name.encode())
        for b in blobs:
            msg += _len_delim(6, _blob(b, legacy_shape=True))
        return _len_delim(2, msg)
    msg = _len_delim(1, name.encode())  # LayerParameter: name=1, blobs=7
    for b in blobs:
        msg += _len_delim(7, _blob(b, legacy_shape=False))
    return _len_delim(100, msg)


# --- the files -----------------------------------------------------------------------
@lru_cache(maxsize=None)
def _jax_shapes(num_stages: int):
    return jax.eval_shape(JaxOpenPose(num_stages=num_stages, dtype=jnp.float32).init,
                          jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"]


@lru_cache(maxsize=None)
def _layers(num_stages: int, seed: int, head_gain: float = 1.0) -> dict:
    """{caffe layer name: (HWIO kernel, bias)}, seeded, for every conv of
    the model (lecun-scaled kernels, small biases); the last stage's two
    output convs multiplied by ``head_gain``. Cached: callers copy before
    they change it."""
    rng = np.random.default_rng(seed)
    out = {}
    for scope, layers in sorted(_jax_shapes(num_stages).items()):
        for leaf, p in sorted(layers.items()):
            kh, kw, cin, cout = p["kernel"].shape
            gain = head_gain if (leaf == "out" and scope.startswith(f"stage{num_stages}_")) else 1.0
            kernel = rng.standard_normal((kh, kw, cin, cout), np.float32) * np.float32(
                gain / np.sqrt(kh * kw * cin))
            bias = rng.standard_normal(cout, np.float32) * np.float32(1e-3)
            out[jweights._flax_name_to_keras(scope, leaf)] = (kernel, bias)
    return out


def write_h5(path: str, layers: dict) -> None:
    import h5py

    with h5py.File(path, "w") as f:
        mw = f.create_group("model_weights")
        for name, (kernel, bias) in layers.items():
            g = mw.create_group(name).create_group(name)
            g.create_dataset("kernel:0", data=kernel)
            g.create_dataset("bias:0", data=bias)


def write_caffemodel(path: str, layers: dict, legacy: bool) -> None:
    out = bytearray()
    for name, (kernel, bias) in layers.items():
        blob_k = np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))      # (out, in, kh, kw)
        blob_b = bias.reshape(1, 1, 1, -1) if legacy else bias
        out += _layer(name, [blob_k, blob_b], legacy)
    with open(path, "wb") as f:
        f.write(bytes(out))


def write_pth(path: str, layers: dict) -> None:
    sd = {"model0.bn.running_mean": torch.zeros(4)}     # a non-conv entry, skipped by shape
    for i, (name, (kernel, bias)) in enumerate(layers.items()):
        sd[f"model{i % 3}.{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        sd[f"model{i % 3}.{name}.bias"] = torch.from_numpy(bias)
    torch.save({"state_dict": sd}, path)


FORMATS = {
    "h5": ("weights.h5", write_h5),
    "caffemodel": ("weights.caffemodel", lambda p, la: write_caffemodel(p, la, False)),
    "caffemodel_legacy": ("legacy.caffemodel", lambda p, la: write_caffemodel(p, la, True)),
    "pth": ("weights.pth", write_pth),
}


def _write(tmp_path, fmt: str, layers: dict) -> str:
    name, writer = FORMATS[fmt]
    path = str(tmp_path / name)
    writer(path, layers)
    return path


@lru_cache(maxsize=None)
def _jax_tree(num_stages: int) -> dict:
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), _jax_shapes(num_stages))


@lru_cache(maxsize=None)
def _port_tree(num_stages: int) -> dict:
    """The port's tree at zero (what the loaders overlay; the values they
    keep are compared nowhere)."""
    sd = OpenPose(num_stages=num_stages, dtype=torch.float32).state_dict()
    return tweights.to_flax({k: torch.zeros_like(v) for k, v in sd.items()})


def _assert_trees_bit_equal(port_tree: dict, jax_tree) -> None:
    want = dict(jax.tree_util.tree_flatten_with_path(jax_tree)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(port_tree)[0])
    assert sorted(map(str, got)) == sorted(map(str, want))
    for path, w in want.items():
        g = got[path]
        assert g.dtype == np.float32 and np.asarray(w).dtype == np.float32
        assert np.array_equal(g.view(np.int32), np.asarray(w).view(np.int32)), path


# --- the loaders ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_full_width_file_loads_bit_equal_to_the_reference(tmp_path, fmt):
    path = _write(tmp_path, fmt, _layers(6, seed=0))
    want, want_missing = jweights.load_reference_weights(path, _jax_tree(6))
    got, got_missing = tweights.load_reference_weights(path, _port_tree(6))
    assert got_missing == want_missing == []
    # through the port's module, as the estimator takes it
    model = OpenPose(num_stages=6, dtype=torch.float32)
    model.load_state_dict(tweights.from_flax(got))
    _assert_trees_bit_equal(tweights.to_flax(model.state_dict()), want)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_two_stage_file_onto_two_and_three_stage_trees(tmp_path, fmt):
    path = _write(tmp_path, fmt, _layers(2, seed=1))
    for stages in (2, 3):
        want, want_missing = jweights.load_reference_weights(path, _jax_tree(stages))
        got, got_missing = tweights.load_reference_weights(path, _port_tree(stages))
        assert got_missing == want_missing
        assert (got_missing == []) == (stages == 2)
        if stages == 3:      # the 14 convs of stage 3, weights and biases, in tree order
            assert len(got_missing) == 28 and got_missing[0] == "stage3_L1/conv1/bias"
            got = {k: v for k, v in got.items() if not k.startswith("stage3")}
            want = {k: v for k, v in want.items() if not k.startswith("stage3")}
        _assert_trees_bit_equal(got, want)


def test_shape_mismatch_raises_in_both(tmp_path):
    layers = dict(_layers(2, seed=2))
    k, b = layers["conv1_2"]
    layers["conv1_2"] = (k[:, :, :32], b)
    path = _write(tmp_path, "h5", layers)
    with pytest.raises(ValueError, match="shape mismatch for conv1_2") as jerr:
        jweights.load_reference_weights(path, _jax_tree(2))
    with pytest.raises(ValueError, match="shape mismatch for conv1_2") as terr:
        tweights.load_reference_weights(path, _port_tree(2))
    assert str(terr.value) == str(jerr.value)


def test_missing_layers_raise_from_maybe_load_pretrained_in_both(tmp_path):
    path = _write(tmp_path, "pth", _layers(2, seed=3))
    with pytest.raises(ValueError, match="missing layers") as jerr:
        jweights.maybe_load_pretrained(_jax_tree(3), path)
    with pytest.raises(ValueError, match="missing layers") as terr:
        tweights.maybe_load_pretrained(_port_tree(3), path)
    assert str(terr.value) == str(jerr.value)


def test_save_keras_h5_round_trips_between_the_packages(tmp_path):
    jax_tree = jweights.load_reference_weights(
        _write(tmp_path, "caffemodel", _layers(2, seed=4)), _jax_tree(2))[0]
    port_out, jax_out = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    names_port = tweights.save_keras_h5(port_out, jax.tree.map(np.asarray, jax_tree))
    names_jax = jweights.save_keras_h5(jax_out, jax_tree)
    assert names_port == names_jax
    back, missing = jweights.load_keras_h5(port_out, _jax_tree(2))
    assert missing == []
    _assert_trees_bit_equal(jax.tree.map(np.asarray, back), jax_tree)
    back, missing = tweights.load_keras_h5(jax_out, _port_tree(2))
    assert missing == []
    _assert_trees_bit_equal(back, jax_tree)
    import h5py

    with h5py.File(port_out) as a, h5py.File(jax_out) as b:
        assert list(a.attrs["layer_names"]) == list(b.attrs["layer_names"])
        for name in names_jax:
            assert list(a[name].attrs["weight_names"]) == list(b[name].attrs["weight_names"])


def test_vgg19_npz_overlay_matches_the_reference(tmp_path, capsys):
    rng = np.random.default_rng(5)
    good = str(tmp_path / "vgg19.npz")
    np.savez(good,
             conv1_1_kernel=rng.standard_normal((3, 3, 3, 64), np.float32),
             conv1_1_bias=rng.standard_normal(64, np.float32),
             conv2_2_kernel=rng.standard_normal((3, 3, 128, 128), np.float32),
             conv3_1_kernel=rng.standard_normal((3, 3, 3, 3), np.float32))    # wrong shape
    want, ok_j = jweights.load_vgg19_imagenet_npz(good, _jax_tree(1))
    said_j = capsys.readouterr().out
    got, ok_t = tweights.load_vgg19_imagenet_npz(good, _port_tree(1))
    said_t = capsys.readouterr().out
    assert ok_j and ok_t and said_t == said_j and "3 arrays applied" in said_t
    for layer, leaf in (("conv1_1", "kernel"), ("conv1_1", "bias"), ("conv2_2", "kernel")):
        assert np.array_equal(got["vgg"][layer][leaf], np.asarray(want["vgg"][layer][leaf]))

    bad = str(tmp_path / "miskeyed.npz")
    np.savez(bad, block1_conv1_W=np.zeros((64, 3, 3, 3), np.float32))
    tree = _port_tree(1)
    for loader, start in ((jweights.load_vgg19_imagenet_npz, _jax_tree(1)),
                          (tweights.load_vgg19_imagenet_npz, tree)):
        with pytest.warns(UserWarning, match="0 of 1 arrays matched"):
            out, ok = loader(bad, start)
        assert ok is False and out is start
    assert tweights.load_vgg19_imagenet_npz(str(tmp_path / "absent.npz"), tree) == (tree, False)


# --- the estimator ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def small_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("small")
    layers = _layers(1, seed=6, head_gain=1000.0)
    return {fmt: _write(d, fmt, layers) for fmt in ("h5", "pth")}


def _small_cfgs():
    jcfg = PoseConfig(model=ModelConfig(**SMALL["model"]),
                      inference=InferenceConfig(**SMALL["inference"]))
    from tpupose_torch import config as tconfig

    tcfg = tconfig.PoseConfig(model=tconfig.ModelConfig(**SMALL["model"]),
                              inference=tconfig.InferenceConfig(**SMALL["inference"]))
    return jcfg, tcfg


def assert_same_people(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["num_parts"] == b["num_parts"]
        assert sorted(a["keypoints"]) == sorted(b["keypoints"])
        np.testing.assert_allclose(a["score"], b["score"], rtol=1e-5, atol=1e-4)
        for name, kp in a["keypoints"].items():
            assert (kp["x"], kp["y"]) == (b["keypoints"][name]["x"], b["keypoints"][name]["y"])
            np.testing.assert_allclose(kp["score"], b["keypoints"][name]["score"],
                                       rtol=1e-5, atol=1e-4)


def test_estimator_from_a_weight_file_gives_the_reference_people(small_files, tmp_path):
    """The JAX estimator takes the JAX loader's tree of the same file as
    ``params`` (its ``weights_path`` route is that tree on a seeded init,
    whose every leaf a full file replaces; that init runs the network at
    368x368 in eager mode, the longest step of this file on the CPU)."""
    jcfg, tcfg = _small_cfgs()
    image = (np.random.default_rng(7).random((160, 200, 3)) * 255).astype(np.uint8)
    jtree, pretrained = jweights.maybe_load_pretrained(_jax_tree(1), small_files["h5"])
    assert pretrained is True
    want = JaxEstimator(jcfg, params=jax.tree.map(jnp.asarray, jtree)).process(image)["people"]
    assert len(want) >= 3
    est = PoseEstimator(tcfg, weights_path=small_files["h5"], device="cpu")
    assert est.pretrained is True
    got = est.process(image)["people"]
    assert_same_people(got, want)
    assert json.loads(json.dumps(got)) == got
    # the .pth of the same layers gives the same module, bit for bit
    from_pth = PoseEstimator(tcfg, weights_path=small_files["pth"], device="cpu")
    assert from_pth.pretrained is True
    for (ka, va), (kb, vb) in zip(est.model.state_dict().items(),
                                  from_pth.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    # a path that does not exist: the seeded init, not pretrained
    absent = str(tmp_path / "absent.h5")
    assert jweights.maybe_load_pretrained(_jax_tree(1), absent)[1] is False
    est = PoseEstimator(tcfg, weights_path=absent, device="cpu")
    seeded = PoseEstimator(tcfg, device="cpu")
    assert est.pretrained is False and seeded.pretrained is False
    for (ka, va), (kb, vb) in zip(est.model.state_dict().items(), seeded.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_estimator_with_params_ignores_weights_path(small_files):
    _, tcfg = _small_cfgs()
    params = tweights.to_flax(PoseEstimator(tcfg, seed=2, device="cpu").model.state_dict())
    est = PoseEstimator(tcfg, params=params, weights_path=small_files["pth"], device="cpu")
    assert est.pretrained is True
    for key, value in tweights.from_flax(params).items():
        assert torch.equal(est.model.state_dict()[key], value)


def test_loaders_warn_nothing_on_a_full_file(small_files):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tree, missing = tweights.load_reference_weights(small_files["pth"], _port_tree(1))
    assert missing == []
