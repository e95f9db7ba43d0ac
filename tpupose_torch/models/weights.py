"""Weight plumbing: the bridge between the reference's flax parameter
tree and the port's ``state_dict``, and the reference weight files —
Keras ``.h5``, Caffe ``.caffemodel``, torch ``.pth`` — onto that tree.

The flax tree (``tpupose/models/openpose.py``) nests
``{scope: {layer: {kernel, bias}}}`` with scopes ``vgg`` (conv1_1 ..
conv4_2), ``cpm`` (conv4_3_CPM, conv4_4_CPM) and ``stage{t}_L{1,2}``
(conv1 .. conv5|6, out). The port's modules carry the same names, so the
state-dict key of ``params[scope][layer]["kernel"]`` is
``{scope}.{layer}.weight``. Kernels are HWIO in flax and OIHW in torch.

The file loaders (counterparts of ``tpupose/models/weights.py``) work on
that flax-layout tree of numpy arrays: each overlays a file's layers onto
it by the Keras/Caffe layer-name contract and returns a new tree, which
``from_flax`` turns into OIHW tensors (the only transpose on that way).
Keras layer names of the lineage:

  vgg:     conv1_1 .. conv4_2
  cpm:     conv4_3_CPM, conv4_4_CPM
  stage 1: conv5_{1..5}_CPM_L{1,2}
  stage t: Mconv{1..7}_stage{t}_L{1,2}   (t = 2..6)

Keras HDF5 kernels are (kh, kw, in, out), as in the flax tree; Caffe blobs
and torch weights are (out, in, kh, kw). Trees are walked in sorted-key
order, the order of the reference's ``tree_flatten_with_path``, so the
``missing`` lists of both packages come out alike. ``h5py`` is imported at
call time: the ``.pth`` and ``.caffemodel`` routes do not need it.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Iterator, Mapping

import numpy as np
import torch


def from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (a flax param tree) -> state_dict."""
    sd = {}
    for scope, layers in params.items():
        for layer, leaves in layers.items():
            for leaf, value in leaves.items():
                arr = np.asarray(value, dtype=np.float32)
                if leaf == "kernel":
                    sd[f"{scope}.{layer}.weight"] = torch.from_numpy(
                        np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
                elif leaf == "bias":
                    sd[f"{scope}.{layer}.bias"] = torch.from_numpy(arr.copy())
                else:
                    raise ValueError(f"unknown leaf {scope}/{layer}/{leaf}")
    return sd


def to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict[str, dict[str, dict[str, np.ndarray]]]:
    """state_dict -> nested dict of numpy arrays in the flax layout."""
    params: dict[str, dict[str, dict[str, np.ndarray]]] = {}
    for key, value in state_dict.items():
        scope, layer, leaf = key.split(".")
        arr = value.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            params.setdefault(scope, {}).setdefault(layer, {})["kernel"] = (
                np.ascontiguousarray(arr.transpose(2, 3, 1, 0)))
        elif leaf == "bias":
            params.setdefault(scope, {}).setdefault(layer, {})["bias"] = arr.copy()
        else:
            raise ValueError(f"unknown state_dict entry {key}")
    return params


# --- optimizer state ---------------------------------------------------------
# The reference's optimizer state is an optax pytree: NamedTuples, tuples and
# dicts in which every momentum accumulator is the ``trace`` field of a
# TraceState — a params-shaped tree whose leaves outside that transform's
# label are field-less ``MaskedNode`` tuples. The two functions below walk
# such a tree by shape alone (no optax import), so a training state can be
# carried between the packages.

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _array_leaves(tree, path=()):
    """(path, array) for every array leaf of a nested dict; skips the
    field-less placeholder tuples of masked-out leaves."""
    if isinstance(tree, Mapping):
        for key, sub in tree.items():
            yield from _array_leaves(sub, (*path, key))
    elif not isinstance(tree, tuple):
        yield path, tree


def momentum_from_optax(opt_state) -> dict[str, torch.Tensor]:
    """Every momentum accumulator of an optax state, merged into one
    state-dict-named mapping (``scope.layer.weight|bias``, OIHW)."""
    found: dict[str, dict[str, dict[str, np.ndarray]]] = {}

    def walk(node):
        if _is_namedtuple(node) and "trace" in node._fields:
            for (scope, layer, leaf), arr in _array_leaves(node.trace):
                found.setdefault(scope, {}).setdefault(layer, {})[leaf] = np.asarray(arr)
        if isinstance(node, Mapping):
            for sub in node.values():
                walk(sub)
        elif isinstance(node, (tuple, list)):
            for sub in node:
                walk(sub)

    walk(opt_state)
    return from_flax(found)


def momentum_into_optax(opt_state, trace: Mapping[str, torch.Tensor]):
    """A copy of the optax state ``opt_state`` whose momentum accumulators
    hold the port's ``trace`` (state-dict names); everything else, the
    step counters included, is kept."""
    flax = to_flax(trace)

    def fill(tree, path=()):
        if isinstance(tree, Mapping):
            return {k: fill(v, (*path, k)) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tree
        scope, layer, leaf = path
        return flax[scope][layer][leaf]

    def walk(node):
        if _is_namedtuple(node):
            fields = {f: (fill(v) if f == "trace" else walk(v))
                      for f, v in zip(node._fields, node)}
            return type(node)(**fields)
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(opt_state)


# --- reference weight files --------------------------------------------------

def _flax_name_to_keras(scope: str, leaf: str) -> str | None:
    """Map 'stage3_L1'/'conv2' style scopes to Keras layer names."""
    if scope == "vgg" or scope == "cpm":
        return leaf  # conv1_1 .. conv4_2, conv4_3_CPM, conv4_4_CPM
    if scope.startswith("stage1_"):
        branch = scope.split("_")[1]  # L1 | L2
        idx = 5 if leaf == "out" else int(leaf.removeprefix("conv"))
        return f"conv5_{idx}_CPM_{branch}"
    if scope.startswith("stage"):
        stage, branch = scope.removeprefix("stage").split("_")
        idx = 7 if leaf == "out" else int(leaf.removeprefix("conv"))
        return f"Mconv{idx}_stage{stage}_{branch}"
    return None


def _leaves(tree: Mapping[str, Any], path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(key path, leaf) of a nested dict, keys in sorted order."""
    for key in sorted(tree):
        sub = tree[key]
        if isinstance(sub, Mapping):
            yield from _leaves(sub, (*path, key))
        else:
            yield (*path, key), sub


def _replace(tree: Mapping[str, Any], updates: Mapping[tuple, Any], path: tuple = ()) -> dict:
    """A copy of ``tree`` with the leaves at the paths of ``updates`` replaced."""
    out = {}
    for key, sub in tree.items():
        at = (*path, key)
        out[key] = (_replace(sub, updates, at) if isinstance(sub, Mapping)
                    else updates.get(at, sub))
    return out


def _h5_layer_weights(h5file) -> dict[str, dict[str, np.ndarray]]:
    """{layer_name: {kernel, bias}} from a Keras weights file."""
    import h5py

    out: dict[str, dict[str, np.ndarray]] = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            parts = name.split("/")
            leaf = parts[-1]
            layer = parts[-2] if len(parts) >= 2 else parts[0]
            if leaf.startswith("kernel"):
                out.setdefault(layer, {})["kernel"] = np.asarray(obj)
            elif leaf.startswith("bias"):
                out.setdefault(layer, {})["bias"] = np.asarray(obj)

    h5file.visititems(visit)
    return out


def load_keras_h5(path: str, params: Mapping[str, Any]) -> tuple[dict, list[str]]:
    """Overlay Keras ``.h5`` weights onto a flax-layout tree.

    Returns (new_params, missing) where ``missing`` lists the tree's convs
    for which no Keras layer was found. Raises on a shape mismatch: that
    means a different architecture, not a naming drift.
    """
    import h5py

    with h5py.File(path, "r") as f:
        layers = _h5_layer_weights(f)
    return _overlay_layers(layers, params)


def load_caffemodel(path: str, params: Mapping[str, Any]) -> tuple[dict, list[str]]:
    """Overlay an original Caffe ``.caffemodel`` (the CMU release format)
    onto a flax-layout tree; the Keras port kept the Caffe layer names, so
    both formats share the name map."""
    from tpupose_torch.models.caffe import caffemodel_layers

    return _overlay_layers(caffemodel_layers(path), params)


def torch_layers(path: str) -> dict[str, dict[str, np.ndarray]]:
    """{caffe_layer_name: {kernel, bias}} from a PyTorch checkpoint.

    The torch ports of this model family build their modules from
    OrderedDicts keyed by the original Caffe layer names, so state dicts
    carry keys like ``model0.conv1_1.weight`` /
    ``model2_1.Mconv1_stage2_L1.bias``: the layer name is the second-to-last
    dotted component and the Keras/Caffe name map applies unchanged. Torch
    conv kernels are (out, in, kh, kw) and become (kh, kw, in, out) here.
    Nested ``state_dict``/``model`` wrappers are unwrapped; non-conv
    entries (BN stats etc.) are skipped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(sd, dict) and isinstance(sd.get(key), dict):
            sd = sd[key]
    layers: dict[str, dict[str, np.ndarray]] = {}
    for k, v in sd.items():
        parts = k.split(".")
        if len(parts) < 2 or parts[-1] not in ("weight", "bias"):
            continue
        layer, wname = parts[-2], parts[-1]
        arr = np.asarray(v.detach().cpu().numpy())
        if wname == "weight":
            if arr.ndim != 4:
                continue
            layers.setdefault(layer, {})["kernel"] = arr.transpose(2, 3, 1, 0)
        else:
            if arr.ndim != 1:
                continue
            layers.setdefault(layer, {})["bias"] = arr
    return layers


def load_torch(path: str, params: Mapping[str, Any]) -> tuple[dict, list[str]]:
    """Overlay a PyTorch-port checkpoint (``.pth``/``.pt``) onto a
    flax-layout tree (see ``torch_layers`` for the naming contract)."""
    return _overlay_layers(torch_layers(path), params)


def save_keras_h5(path: str, params: Mapping[str, Any]) -> list[str]:
    """Export a flax-layout tree to a reference-format Keras weights file.

    The reverse of :func:`load_keras_h5`: one group per layer name holding
    ``<layer>/kernel:0`` / ``<layer>/bias:0`` datasets, with the
    ``layer_names`` / ``weight_names`` attributes Keras' by-name loader
    walks. Returns the exported Keras layer names.
    """
    import h5py

    layers: dict[str, dict[str, np.ndarray]] = {}
    for keys, value in _leaves(params):
        if len(keys) < 3 or keys[-1] not in ("kernel", "bias"):
            continue
        keras_name = _flax_name_to_keras(keys[-3], keys[-2])
        if keras_name is None:
            continue
        layers.setdefault(keras_name, {})[keys[-1]] = np.asarray(value, dtype=np.float32)

    names = sorted(layers)
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.asarray([n.encode() for n in names], dtype="S64")
        f.attrs["backend"] = b"tensorflow"
        for name in names:
            grp = f.create_group(name)
            weight_names = []
            for wname in ("kernel", "bias"):
                if wname in layers[name]:
                    ds = f"{name}/{wname}:0"
                    grp.create_dataset(ds, data=layers[name][wname])
                    weight_names.append(ds.encode())
            grp.attrs["weight_names"] = np.asarray(weight_names, dtype="S96")
    return names


def load_reference_weights(path: str, params: Mapping[str, Any]) -> tuple[dict, list[str]]:
    """Format-dispatching loader: ``.caffemodel``, torch ``.pth``/``.pt``,
    or Keras ``.h5``."""
    if path.endswith(".caffemodel"):
        return load_caffemodel(path, params)
    if path.endswith((".pth", ".pt")):
        return load_torch(path, params)
    return load_keras_h5(path, params)


def _overlay_layers(layers: Mapping[str, Mapping[str, np.ndarray]],
                    params: Mapping[str, Any]) -> tuple[dict, list[str]]:
    missing: list[str] = []
    updates: dict[tuple, np.ndarray] = {}
    for keys, value in _leaves(params):
        # keys like ('vgg', 'conv1_1', 'kernel')
        if len(keys) < 3:
            continue
        scope, leaf, wname = keys[-3], keys[-2], keys[-1]
        keras_name = _flax_name_to_keras(scope, leaf)
        if keras_name is None or keras_name not in layers:
            missing.append("/".join(keys))
            continue
        src = layers[keras_name].get("kernel" if wname == "kernel" else "bias")
        if src is None:
            missing.append("/".join(keys))
            continue
        if src.shape != np.shape(value):
            raise ValueError(
                f"shape mismatch for {keras_name}: h5 {src.shape} vs flax {np.shape(value)}")
        updates[keys] = src.astype(np.float32)
    return _replace(params, updates), missing


def maybe_load_pretrained(params: Mapping[str, Any], path: str | None) -> tuple[Any, bool]:
    """Load reference weights (.h5, .caffemodel, or torch .pth/.pt) if the
    file exists; otherwise return params as they are."""
    if path and os.path.exists(path):
        new_params, missing = load_reference_weights(path, params)
        if missing:
            raise ValueError(f"pretrained file {path} missing layers: {missing[:5]}...")
        return new_params, True
    return params, False


# --- VGG19 ImageNet initialisation (fine-tune from scratch path) -------------

_VGG19_TORCH_ORDER = (
    "conv1_1", "conv1_2", "conv2_1", "conv2_2",
    "conv3_1", "conv3_2", "conv3_3", "conv3_4",
    "conv4_1", "conv4_2",
)


def load_vgg19_imagenet_npz(path: str, params: Mapping[str, Any]) -> tuple[Any, bool]:
    """Overlay VGG19 ImageNet conv weights from an ``.npz`` onto the
    ``vgg`` scope, the reference's ``from_vgg`` name map.

    The npz holds ``{name}_kernel`` (kh, kw, in, out) and ``{name}_bias``
    arrays for the names of the VGG block. Load-if-present; an npz that
    matches nothing warns and leaves the tree as it was.
    """
    if not path or not os.path.exists(path):
        return params, False
    data = np.load(path)
    updates: dict[tuple, np.ndarray] = {}
    for keys, value in _leaves(params):
        if len(keys) >= 3 and keys[-3] == "vgg" and keys[-2] in _VGG19_TORCH_ORDER:
            key = f"{keys[-2]}_{keys[-1]}"
            if key in data and data[key].shape == np.shape(value):
                updates[keys] = np.asarray(data[key], dtype=np.float32)
    if not updates:
        warnings.warn(
            f"VGG19 npz {path}: 0 of {len(data.files)} arrays matched any "
            "vgg conv name+shape — overlay had no effect (expected keys "
            "like 'conv1_1_kernel' with (kh,kw,in,out) layout)",
            stacklevel=2,
        )
        return params, False
    print(f"VGG19 npz overlay: {len(updates)} arrays applied from {path}")
    return _replace(params, updates), True
