"""OpenPose BODY_25: VGG19 front, PReLU CPM tail and PAF-first dense-block stages.

The network of CMU's OpenPose since v1.3 (Cao, Hidalgo, Simon, Wei,
Sheikh, TPAMI 2019, arXiv:1812.08008; ``models/pose/body_25/
pose_deploy.prototxt``), with phi a PReLU of one learned slope a channel:

  * front: VGG19 conv1_1 .. conv4_1 with ReLU (``VGGBackbone.trunk``, block
    1 through the ``block1`` kernel as in ``OpenPose``), conv4_2 +
    ``prelu4_2``, conv4_3_CPM (512 -> 256) + phi, conv4_4_CPM (256 -> 128) +
    phi: the feature F, 128 channels at stride 8;
  * dense block D(c, w): y0 = phi(conv3(x)), y1 = phi(conv3(y0)), y2 =
    phi(conv3(y1)), out concat(y0, y1, y2), 3w channels;
  * stage S(c, w, h, out): D(c, w), four D(3w, w), Mconv6 (1x1, 3w -> h) +
    phi, Mconv7 (1x1, h -> out);
  * PAF stages first: P_0 = S(128, 96, 256, 52)(F), P_t = S(180, 128, 512,
    52)(concat(F, P_{t-1})); then heat: H_0 = S(180, 96, 256, 26)(concat(F,
    P_last)), H_t = S(206, 128, 512, 26)(concat(F, H_{t-1}, P_last)), with
    the released model's 4 PAF and 2 heat stages (``STAGES``).

Every conv but the heads is followed by its bias and PReLU in one pass of
``ops.dense_epilogue``, which writes a dense block's three outputs straight
into the block's preallocated 3w-channel buffer: a block is three convs and
three epilogues, with no bias, PReLU or concatenation pass of its own.

Numerics, as ``models/openpose.py`` states them for the COCO network: the
convs take input and kernel in the compute dtype (bf16: f32 accumulation,
output rounded to bf16 by cuDNN); the epilogue adds the f32 bias and applies
the f32 slope in f32 and rounds once to the compute dtype; the Mconv7 heads
run in f32 on f32-promoted input; the stage concats cast to the compute
dtype; parameters stay f32. Public tensors are NHWC; inside, NCHW tensors in
channels_last memory (the same bytes).

Parameter names are the prototxt's layer names: scopes ``vgg`` (as in
``OpenPose``), ``cpm`` (``prelu4_2``, ``conv4_3_CPM``, ``prelu4_3_CPM``,
``conv4_4_CPM``, ``prelu4_4_CPM``) and ``stage{t}_L2`` (PAF, t from 0) and
``stage{t}_L1`` (heat), each holding ``Mconv{i}_stage{t}_L{b}_{j}`` /
``Mprelu{i}_stage{t}_L{b}_{j}`` for i in 1..5, j in 0..2, then
``Mconv6``/``Mprelu6``/``Mconv7`` of the stage. A PReLU's parameter is
``slope``.
"""

from __future__ import annotations

import torch
from torch import nn

from tpupose_torch.models.openpose import Conv, VGGBackbone, stage_span
from tpupose_torch.models.stage_graph import StageGraphs
from tpupose_torch.ops.dense_epilogue import dense_epilogue
from tpupose_torch.skeletons import BODY25

FEATURE = 128
SLOPE_INIT = 0.25       # Caffe's PReLU filler
_PAF, _HEAT = BODY25.paf_channels, BODY25.heat_channels
# (scope, cin, w, h, out) of every stage, in the order they run: the released
# model's 4 PAF stages, then its 2 heat stages
STAGES = (
    ("stage0_L2", FEATURE, 96, 256, _PAF),
    ("stage1_L2", FEATURE + _PAF, 128, 512, _PAF),
    ("stage2_L2", FEATURE + _PAF, 128, 512, _PAF),
    ("stage3_L2", FEATURE + _PAF, 128, 512, _PAF),
    ("stage0_L1", FEATURE + _PAF, 96, 256, _HEAT),
    ("stage1_L1", FEATURE + _PAF + _HEAT, 128, 512, _HEAT),
)


class PReLU(nn.Module):
    """One learned slope a channel (applied by ``ops.dense_epilogue``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.slope = nn.Parameter(torch.full((channels,), SLOPE_INIT))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.slope.fill_(SLOPE_INIT)


def conv_prelu(conv: Conv, prelu: PReLU, x: torch.Tensor, dtype: torch.dtype,
               out: torch.Tensor | None = None, off: int = 0, keep: bool = False) -> torch.Tensor:
    """phi(conv(x)) in one epilogue pass: into channels ``off`` .. of
    ``out`` (NCHW, channels_last; a new tensor where None, which is
    returned). With ``keep`` the conv's own output tensor holds the result
    too and is returned instead: the dense input of the next conv."""
    y = conv.product(x, dtype).contiguous(memory_format=torch.channels_last)
    if out is None:
        out = torch.empty_like(y, memory_format=torch.channels_last)
    dense_epilogue(y.permute(0, 2, 3, 1), conv.bias, prelu.slope, out.permute(0, 2, 3, 1),
                   off, keep)
    return y if keep else out


class Stage(nn.Module):
    """S(c, w, h, out): five dense blocks, Mconv6 + phi, the Mconv7 head."""

    def __init__(self, scope: str, cin: int, width: int, hidden: int, out_channels: int,
                 dtype: torch.dtype = torch.bfloat16, head_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scope, self.width = scope, width
        self.dtype, self.head_dtype = dtype, head_dtype
        for i in range(1, 6):
            for j in range(3):
                c = (cin if i == 1 else 3 * width) if j == 0 else width
                self.add_module(f"Mconv{i}_{scope}_{j}", Conv(c, width, 3))
                self.add_module(f"Mprelu{i}_{scope}_{j}", PReLU(width))
        self.add_module(f"Mconv6_{scope}", Conv(3 * width, hidden, 1))
        self.add_module(f"Mprelu6_{scope}", PReLU(hidden))
        self.add_module(f"Mconv7_{scope}", Conv(hidden, out_channels, 1))

    def _layer(self, name: str):
        return getattr(self, name.format(s=self.scope))

    def dense_block(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """D of block ``i`` (1..5): three convs, each epilogue writing its
        third of the block's buffer."""
        n, _, h, w = x.shape
        buf = torch.empty((n, 3 * self.width, h, w), dtype=self.dtype, device=x.device,
                          memory_format=torch.channels_last)
        for j in range(3):
            x = conv_prelu(self._layer(f"Mconv{i}_{{s}}_{j}"), self._layer(f"Mprelu{i}_{{s}}_{j}"),
                           x, self.dtype, buf, j * self.width, keep=j < 2)
        return buf

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, 6):
            x = self.dense_block(i, x)
        x = conv_prelu(self._layer("Mconv6_{s}"), self._layer("Mprelu6_{s}"), x, self.dtype)
        return self._layer("Mconv7_{s}")(x, self.head_dtype)


class Body25Front(nn.Module):
    """prelu4_2 and the two CPM convs, each + phi (scope ``cpm``)."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.prelu4_2 = PReLU(512)
        self.conv4_3_CPM = Conv(512, 256, 3)
        self.prelu4_3_CPM = PReLU(256)
        self.conv4_4_CPM = Conv(256, FEATURE, 3)
        self.prelu4_4_CPM = PReLU(FEATURE)

    def forward(self, vgg: VGGBackbone, x: torch.Tensor) -> torch.Tensor:
        x = conv_prelu(vgg.conv4_2, self.prelu4_2, vgg.trunk(x), self.dtype)
        x = conv_prelu(self.conv4_3_CPM, self.prelu4_3_CPM, x, self.dtype)
        return conv_prelu(self.conv4_4_CPM, self.prelu4_4_CPM, x, self.dtype)


class OpenPoseBody25(nn.Module):
    """The BODY_25 network. ``forward`` takes a normalised (N, H, W, 3)
    image and returns ``[(paf, heat)]``, the last PAF stage's (N, H/8, W/8,
    52) and the last heat stage's (N, H/8, W/8, 26) maps in f32 NHWC: the
    inference contract of ``OpenPose`` (whose list holds every stage's
    pair; the last is read). The stages run inside the span ``net.stages``
    (``openpose.stage_span``): on the card with grad off and the module's
    own parameters, as one CUDA graph a shape (``stage_graph.StageGraphs``),
    else op by op.
    """

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 head_dtype: torch.dtype = torch.float32, pallas_block1: bool = False):
        super().__init__()
        self.dtype = dtype
        self.vgg = VGGBackbone(dtype, pallas_block1)
        self.cpm = Body25Front(dtype)
        for scope, cin, w, h, out in STAGES:
            self.add_module(scope, Stage(scope, cin, w, h, out, dtype, head_dtype))
        self._stage_leaves = [m for scope, *_ in STAGES for m in getattr(self, scope).children()]
        self.stage_graphs = StageGraphs(self.stage_tensors())

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init in module order: lecun-normal kernels and zero biases
        (``Conv.reset_parameters``), every slope 0.25."""
        for m in self.modules():
            if isinstance(m, Conv):
                m.reset_parameters(generator)
            elif isinstance(m, PReLU):
                m.reset_parameters()

    def stage_tensors(self) -> list[torch.Tensor]:
        """The parameters the stage loop reads, as the stages hold them now
        (``functional_call`` swaps them in)."""
        return [t for m in self._stage_leaves for t in m._parameters.values()]

    def stages(self, feat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The stage loop, op by op: F (N, 128, H, W) -> the last PAF and
        heat maps, NCHW in channels_last memory, f32."""
        dt = self.dtype
        paf = heat = None
        for scope, *_ in STAGES:
            stage = getattr(self, scope)
            if scope.endswith("L2"):
                paf = stage(feat if paf is None else torch.cat([feat, paf.to(dt)], dim=1))
            else:
                parts = [feat, paf] if heat is None else [feat, heat, paf]
                heat = stage(torch.cat([t.to(dt) for t in parts], dim=1))
        return paf, heat

    def forward(self, image: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
        feat = self.cpm(self.vgg, image.permute(0, 3, 1, 2))
        with stage_span():
            paf, heat = self.stage_graphs(self.stages, feat, self.stage_tensors())
        return [(paf.permute(0, 2, 3, 1), heat.permute(0, 2, 3, 1))]
