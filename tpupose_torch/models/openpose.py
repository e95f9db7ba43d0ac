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

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from tpupose_torch import topology
from tpupose_torch.ops.block1 import block1
from tpupose_torch.utils.profiling import annotate

# ModelConfig.compute_dtype -> torch dtype
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
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

    def product(self, x: torch.Tensor, dtype: torch.dtype, pad_rows: bool = True) -> torch.Tensor:
        """The convolution in ``dtype`` without its bias. ``pad_rows=False``:
        no zero rows above and below (the caller supplies them, as a tile's
        halo does): H shrinks by the kernel size less one."""
        pad = self.weight.shape[-1] // 2
        return F.conv2d(x.to(dtype), self.weight.to(dtype), padding=(pad if pad_rows else 0, pad))

    def forward(self, x: torch.Tensor, dtype: torch.dtype, pad_rows: bool = True) -> torch.Tensor:
        """``product`` plus the bias, added in ``dtype``."""
        return self.product(x, dtype, pad_rows) + self.bias.to(dtype)[:, None, None]


def stage_span():
    """The span ``net.stages`` around the stage loop of an inference forward
    (grad off). A training forward records none, so that a train step's
    spans stay its own layers (``training/loop.py``)."""
    return contextlib.nullcontext() if torch.is_grad_enabled() else annotate("net.stages")


def _hwio(conv: Conv) -> torch.Tensor:
    return conv.weight.permute(2, 3, 1, 0)


class VGGBackbone(nn.Module):
    """VGG19 conv1_1..conv4_2 -> stride-8, 512-channel features.

    ``pallas_block1`` is the reference model's own field (default False):
    when set, in bf16 with even H and W, block 1 (conv1_1 + relu +
    conv1_2 + relu + pool) goes through ``ops.block1`` — the CUDA kernel
    for CUDA input, its plain version (the same two convs) for CPU input.
    That op is inference-only; the estimator sets the flag, the trainer
    leaves it off and block 1 is the two convs and the pool.
    """

    _LAYERS = (("conv1_1", 3, 64), ("conv1_2", 64, 64), ("conv2_1", 64, 128),
               ("conv2_2", 128, 128), ("conv3_1", 128, 256), ("conv3_2", 256, 256),
               ("conv3_3", 256, 256), ("conv3_4", 256, 256), ("conv4_1", 256, 512),
               ("conv4_2", 512, 512))

    def __init__(self, dtype: torch.dtype = torch.bfloat16, pallas_block1: bool = False):
        super().__init__()
        self.dtype = dtype
        self.pallas_block1 = pallas_block1
        for name, cin, cout in self._LAYERS:
            self.add_module(name, Conv(cin, cout, 3))

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(getattr(self, name)(x, self.dtype))

    def fuses_block1(self, h: int, w: int) -> bool:
        """Whether block 1 of an (h, w) input goes through ``ops.block1``."""
        return self.pallas_block1 and self.dtype == torch.bfloat16 and h % 2 == 0 and w % 2 == 0

    def block1(self, x: torch.Tensor) -> torch.Tensor:
        """conv1_1 + ReLU + conv1_2 + ReLU + 2x2 pool of an NCHW input,
        zero-padded at its own edges."""
        if self.fuses_block1(*x.shape[-2:]):
            y = block1(x.permute(0, 2, 3, 1), _hwio(self.conv1_1), self.conv1_1.bias,
                       _hwio(self.conv1_2), self.conv1_2.bias)
            return y.permute(0, 3, 1, 2)
        return F.max_pool2d(self._conv("conv1_2", self._conv("conv1_1", x)), 2)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """Block 1 .. conv4_1 + ReLU: what conv4_2 reads."""
        x = self.block1(x)
        x = F.max_pool2d(self._conv("conv2_2", self._conv("conv2_1", x)), 2)
        for name in ("conv3_1", "conv3_2", "conv3_3", "conv3_4"):
            x = self._conv(name, x)
        x = F.max_pool2d(x, 2)
        return self._conv("conv4_1", x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv("conv4_2", self.trunk(x))


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
    inference path keeps the last pair. Without grad the stages run inside
    the span ``net.stages`` (``stage_span``).

    ``remat`` (the reference model's field): while autograd records, each
    stage branch runs under ``torch.utils.checkpoint`` and is recomputed
    in the backward pass, so the 7x7 convs' activations of every stage are
    not kept alive until then. The same numbers; without grad (inference,
    ``no_grad``) it changes nothing.
    """

    def __init__(self, num_stages: int = 6, dtype: torch.dtype = torch.bfloat16,
                 head_dtype: torch.dtype = torch.float32, pallas_block1: bool = False,
                 remat: bool = False):
        super().__init__()
        self.num_stages = num_stages
        self.remat = remat
        self.dtype = dtype
        self.vgg = VGGBackbone(dtype, pallas_block1)
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

    def _branch(self, name: str, x: torch.Tensor) -> torch.Tensor:
        branch = getattr(self, name)
        if not (self.remat and torch.is_grad_enabled()):
            return branch(x)
        # the parameters go in as arguments: the recomputation must see the
        # tensors of this forward (those a ``functional_call`` swapped in),
        # not whatever the module holds when the backward pass runs
        names, tensors = zip(*branch.named_parameters())

        def run(x, *tensors):
            return functional_call(branch, dict(zip(names, tensors)), (x,))

        return checkpoint(run, x, *tensors, use_reentrant=False)

    def forward(self, image: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
        feat = self.cpm(self.vgg(image.permute(0, 3, 1, 2)))
        with stage_span():
            paf = self._branch("stage1_L1", feat)
            heat = self._branch("stage1_L2", feat)
            outputs = [(paf, heat)]
            for t in range(2, self.num_stages + 1):
                x = torch.cat([paf.to(self.dtype), heat.to(self.dtype), feat], dim=1)
                paf = self._branch(f"stage{t}_L1", x)
                heat = self._branch(f"stage{t}_L2", x)
                outputs.append((paf, heat))
        return [(p.permute(0, 2, 3, 1), h.permute(0, 2, 3, 1)) for p, h in outputs]


def param_group(path) -> str:
    """Map a parameter path (a dotted state-dict key or its parts) to an
    LR group: vgg | cpm | stage1 | stageT — the MultiSGD grouping."""
    top = path.split(".")[0] if isinstance(path, str) else path[0]
    if top == "vgg":
        return "vgg"
    if top == "cpm":
        return "cpm"
    if top.startswith("stage1"):
        return "stage1"
    return "stageT"
