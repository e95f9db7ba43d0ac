"""Weight bridge between the reference's flax parameter tree and the
port's ``state_dict``.

The flax tree (``tpupose/models/openpose.py``) nests
``{scope: {layer: {kernel, bias}}}`` with scopes ``vgg`` (conv1_1 ..
conv4_2), ``cpm`` (conv4_3_CPM, conv4_4_CPM) and ``stage{t}_L{1,2}``
(conv1 .. conv5|6, out). The port's modules carry the same names, so the
state-dict key of ``params[scope][layer]["kernel"]`` is
``{scope}.{layer}.weight``. Kernels are HWIO in flax and OIHW in torch.
"""

from __future__ import annotations

from typing import Any, Mapping

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
