"""VGG19-frontend 6-stage two-branch CPM/PAF network (PyTorch).

Counterpart of ``tpupose/models/openpose.py``: VGG19 conv1_1..conv4_2 +
two CPM convs give a stride-8 feature F; stage 1 and the refinement
stages each emit a 38-channel PAF branch (L1) and a 19-channel heatmap
branch (L2), stages t >= 2 reading concat(L1_{t-1}, L2_{t-1}, F).

Numerics follow flax ``nn.Conv(dtype=...)`` exactly, with explicit casts
(no autocast): input and kernel are cast to the compute dtype, the
result stays in it and the bias is added in it; the two output convs of
every branch run in f32 on f32-promoted input; the stage concat casts
PAF and heat to the compute dtype. Parameters stay f32. Module names
mirror the flax scopes, so ``models.weights`` maps the trees 1:1.

Public tensors are NHWC as in the reference; inside, activations are
NCHW tensors in channels_last memory format (the same bytes).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpupose import topology
from tpupose_torch.ops.block1 import block1

# flax lecun_normal: truncated normal in [-2, 2] std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


class Conv(nn.Module):
    """Stride-1 'SAME' conv with flax ``nn.Conv`` numerics in ``dtype``."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax defaults: lecun-normal kernel, zero bias."""
        cout, cin, kh, kw = self.weight.shape
        std = math.sqrt(1.0 / (cin * kh * kw)) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        pad = self.weight.shape[-1] // 2
        y = F.conv2d(x.to(dtype), self.weight.to(dtype), padding=pad)
        return y + self.bias.to(dtype)[:, None, None]


def _hwio(conv: Conv) -> torch.Tensor:
    return conv.weight.permute(2, 3, 1, 0)


class VGGBackbone(nn.Module):
    """VGG19 conv1_1..conv4_2 -> stride-8, 512-channel features.

    In bf16 with even H and W, block 1 (conv1_1 + relu + conv1_2 + relu +
    pool) goes through ``ops.block1``: the CUDA kernel for CUDA input, its
    plain version (the same two convs) for CPU input.
    """

    _LAYERS = (("conv1_1", 3, 64), ("conv1_2", 64, 64), ("conv2_1", 64, 128),
               ("conv2_2", 128, 128), ("conv3_1", 128, 256), ("conv3_2", 256, 256),
               ("conv3_3", 256, 256), ("conv3_4", 256, 256), ("conv4_1", 256, 512),
               ("conv4_2", 512, 512))

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        for name, cin, cout in self._LAYERS:
            self.add_module(name, Conv(cin, cout, 3))

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(getattr(self, name)(x, self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        if self.dtype == torch.bfloat16 and h % 2 == 0 and w % 2 == 0:
            y = block1(x.permute(0, 2, 3, 1), _hwio(self.conv1_1), self.conv1_1.bias,
                       _hwio(self.conv1_2), self.conv1_2.bias)
            x = y.permute(0, 3, 1, 2)
        else:
            x = F.max_pool2d(self._conv("conv1_2", self._conv("conv1_1", x)), 2)
        x = F.max_pool2d(self._conv("conv2_2", self._conv("conv2_1", x)), 2)
        for name in ("conv3_1", "conv3_2", "conv3_3", "conv3_4"):
            x = self._conv(name, x)
        x = F.max_pool2d(x, 2)
        return self._conv("conv4_2", self._conv("conv4_1", x))


class CPMFeature(nn.Module):
    """The two CPM reduction convs appended to VGG."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv4_3_CPM = Conv(512, 256, 3)
        self.conv4_4_CPM = Conv(256, 128, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.conv4_3_CPM(x, self.dtype))
        return torch.relu(self.conv4_4_CPM(x, self.dtype))


class Stage1Branch(nn.Module):
    """3x [3x3,128] -> [1x1,512] -> [1x1,out] (the last in ``head_dtype``)."""

    def __init__(self, out_channels: int, dtype: torch.dtype = torch.bfloat16,
                 head_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.head_dtype = dtype, head_dtype
        self.conv1 = Conv(128, 128, 3)
        self.conv2 = Conv(128, 128, 3)
        self.conv3 = Conv(128, 128, 3)
        self.conv4 = Conv(128, 512, 1)
        self.out = Conv(512, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            x = torch.relu(conv(x, self.dtype))
        return self.out(x, self.head_dtype)


class StageTBranch(nn.Module):
    """5x [7x7,128] -> [1x1,128] -> [1x1,out] (the last in ``head_dtype``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.bfloat16,
                 head_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.head_dtype = dtype, head_dtype
        for i in range(5):
            self.add_module(f"conv{i + 1}", Conv(in_channels if i == 0 else 128, 128, 7))
        self.conv6 = Conv(128, 128, 1)
        self.out = Conv(128, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(6):
            x = torch.relu(getattr(self, f"conv{i + 1}")(x, self.dtype))
        return self.out(x, self.head_dtype)


class OpenPose(nn.Module):
    """The full multi-stage network.

    ``forward`` takes a normalised (N, H, W, 3) image and returns the
    per-stage list of (paf, heat) in NHWC — the training contract; the
    inference path keeps the last pair.
    """

    def __init__(self, num_stages: int = 6, dtype: torch.dtype = torch.bfloat16,
                 head_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_stages = num_stages
        self.dtype = dtype
        self.vgg = VGGBackbone(dtype)
        self.cpm = CPMFeature(dtype)
        paf_c, heat_c = topology.NUM_PAF_CHANNELS, topology.NUM_HEAT_CHANNELS
        self.stage1_L1 = Stage1Branch(paf_c, dtype, head_dtype)
        self.stage1_L2 = Stage1Branch(heat_c, dtype, head_dtype)
        for t in range(2, num_stages + 1):
            cin = paf_c + heat_c + 128
            self.add_module(f"stage{t}_L1", StageTBranch(cin, paf_c, dtype, head_dtype))
            self.add_module(f"stage{t}_L2", StageTBranch(cin, heat_c, dtype, head_dtype))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded flax-default init of every conv, in module order."""
        for m in self.modules():
            if isinstance(m, Conv):
                m.reset_parameters(generator)

    def forward(self, image: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
        feat = self.cpm(self.vgg(image.permute(0, 3, 1, 2)))
        paf = self.stage1_L1(feat)
        heat = self.stage1_L2(feat)
        outputs = [(paf, heat)]
        for t in range(2, self.num_stages + 1):
            x = torch.cat([paf.to(self.dtype), heat.to(self.dtype), feat], dim=1)
            paf = getattr(self, f"stage{t}_L1")(x)
            heat = getattr(self, f"stage{t}_L2")(x)
            outputs.append((paf, heat))
        return [(p.permute(0, 2, 3, 1), h.permute(0, 2, 3, 1)) for p, h in outputs]
