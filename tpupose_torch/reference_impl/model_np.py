"""Pure-NumPy forward oracle of ``tpupose_torch.models.OpenPose``.

The port's own copy of ``tpupose/reference_impl/model_np.py`` (held to it
code for code by tests/test_torch_imports.py): float32 im2col matmuls on
the host, written from the architecture (VGG19 conv1_1..conv4_2 + the two
CPM convs; stage 1 3x[3x3,128]+[1x1,512]+[1x1,out]; stages t>=2 5x[7x7,128]
+[1x1,128]+[1x1,out] over concat(paf, heat, feat)). It pins SAME-pad
placement, pool geometry and the concat order, and shares no code with
PyTorch: the card's network is held against it (chip_smoke.py phase n).

It takes the flax-layout parameter tree, (kh, kw, in, out) kernels, which
``models.weights.to_flax`` makes of the port's ``state_dict``.
"""

from __future__ import annotations

import numpy as np


def conv2d_same(x: np.ndarray, kernel: np.ndarray, bias: np.ndarray) -> np.ndarray:
    """stride-1 SAME conv. x (H, W, Cin); kernel (kh, kw, Cin, Cout).

    For odd kernels at stride 1, SAME padding is symmetric (k-1)/2 on
    each side — there is no TF-style asymmetric pad to worry about (that
    only appears at stride > 1); this is exactly what flax/XLA do.
    """
    kh, kw, cin, cout = kernel.shape
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    h, w = x.shape[:2]
    xp = np.pad(x, ((ph, ph), (pw, pw), (0, 0)))
    cols = np.empty((h, w, kh * kw * cin), np.float32)
    for i in range(kh):
        for j in range(kw):
            cols[:, :, (i * kw + j) * cin:(i * kw + j + 1) * cin] = (
                xp[i:i + h, j:j + w]
            )
    out = cols.reshape(h * w, kh * kw * cin) @ kernel.reshape(-1, cout).astype(
        np.float32
    )
    return (out + bias.astype(np.float32)).reshape(h, w, cout)


def max_pool_2x2(x: np.ndarray) -> np.ndarray:
    """2x2/stride-2 VALID max pool (flax nn.max_pool semantics; input
    sizes on this net are always even: 368 -> 184 -> 92 -> 46)."""
    h, w, c = x.shape
    return x[: h - h % 2, : w - w % 2].reshape(
        h // 2, 2, w // 2, 2, c
    ).max(axis=(1, 3))


def _relu(x: np.ndarray) -> np.ndarray:
    return np.maximum(x, 0.0)


def _conv_relu(params: dict, name: str, x: np.ndarray) -> np.ndarray:
    p = params[name]
    return _relu(conv2d_same(x, np.asarray(p["kernel"]), np.asarray(p["bias"])))


def vgg_cpm_np(params: dict, image: np.ndarray) -> np.ndarray:
    """VGG19 conv1_1..conv4_2 + conv4_3_CPM/conv4_4_CPM -> (H/8, W/8, 128)."""
    vgg = params["vgg"]
    x = image.astype(np.float32)
    x = _conv_relu(vgg, "conv1_1", x)
    x = _conv_relu(vgg, "conv1_2", x)
    x = max_pool_2x2(x)
    x = _conv_relu(vgg, "conv2_1", x)
    x = _conv_relu(vgg, "conv2_2", x)
    x = max_pool_2x2(x)
    for name in ("conv3_1", "conv3_2", "conv3_3", "conv3_4"):
        x = _conv_relu(vgg, name, x)
    x = max_pool_2x2(x)
    x = _conv_relu(vgg, "conv4_1", x)
    x = _conv_relu(vgg, "conv4_2", x)
    cpm = params["cpm"]
    x = _conv_relu(cpm, "conv4_3_CPM", x)
    x = _conv_relu(cpm, "conv4_4_CPM", x)
    return x


def stage1_branch_np(params: dict, x: np.ndarray) -> np.ndarray:
    for i in range(1, 4):
        x = _conv_relu(params, f"conv{i}", x)
    x = _conv_relu(params, "conv4", x)
    p = params["out"]
    return conv2d_same(x, np.asarray(p["kernel"]), np.asarray(p["bias"]))


def stageT_branch_np(params: dict, x: np.ndarray) -> np.ndarray:
    for i in range(1, 6):
        x = _conv_relu(params, f"conv{i}", x)
    x = _conv_relu(params, "conv6", x)
    p = params["out"]
    return conv2d_same(x, np.asarray(p["kernel"]), np.asarray(p["bias"]))


def forward_np(
    params: dict, image: np.ndarray, num_stages: int | None = None
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Full multi-stage forward: (H, W, 3) image (already normalised) ->
    [(paf, heat)] * num_stages at stride-8 resolution.

    ``params`` is the flax-layout param tree (dicts of kernel/bias leaves),
    e.g. ``models.weights.to_flax(model.state_dict())``.
    """
    if num_stages is None:
        num_stages = 1 + sum(
            1 for k in params if k.startswith("stage") and k.endswith("_L1")
            and k != "stage1_L1"
        )
    feat = vgg_cpm_np(params, image)
    paf = stage1_branch_np(params["stage1_L1"], feat)
    heat = stage1_branch_np(params["stage1_L2"], feat)
    outputs = [(paf, heat)]
    for t in range(2, num_stages + 1):
        x = np.concatenate([paf, heat, feat], axis=-1)
        paf = stageT_branch_np(params[f"stage{t}_L1"], x)
        heat = stageT_branch_np(params[f"stage{t}_L2"], x)
        outputs.append((paf, heat))
    return outputs
