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
