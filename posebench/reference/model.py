"""The OpenPose COCO network in plain ``torch`` operations.

Written from the published architecture (Cao et al., CVPR 2017,
arXiv:1611.08050; CMU's ``pose_deploy.prototxt``): VGG19 conv1_1..conv4_2
with three 2x2 pools, the two CPM convs (256, 128), stage 1 of each branch
3x[3x3,128] + [1x1,512] + [1x1,out], stages 2..6 5x[7x7,128] + [1x1,128] +
[1x1,out] over concat(PAF, heat, feature); 38 PAF and 19 heat channels.
Every conv is stride 1 with SAME zero padding and is followed by ReLU but
the two output convs of each branch.

Parameters are a dict of f32 tensors named ``<scope>.<layer>.weight``
(O, I, kh, kw) and ``.bias``, the scopes as the layer table below lists
them. Activations are NCHW here; images and outputs NHWC.

Precision, as a configuration states it (``compute_dtype``):

  ``"bfloat16"``: every conv but the heads takes its input and kernel in
      bf16 and adds its bias in bf16; the heads run in f32 on f32 input;
      the stage concat casts PAF and heat to bf16. TF32 is off.
  ``"float32"``: everything in f32, TF32 off.
  ``"fp8"``: the control one step below bf16: each body conv's input and
      kernel rounded to float8 e4m3 with one scale per tensor (amax / 448)
      and computed in bf16; the heads in bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from posebench.reference import skeleton

VGG = (("conv1_1", 3, 64), ("conv1_2", 64, 64), "pool", ("conv2_1", 64, 128),
       ("conv2_2", 128, 128), "pool", ("conv3_1", 128, 256), ("conv3_2", 256, 256),
       ("conv3_3", 256, 256), ("conv3_4", 256, 256), "pool", ("conv4_1", 256, 512),
       ("conv4_2", 512, 512))
CPM = (("conv4_3_CPM", 512, 256), ("conv4_4_CPM", 256, 128))
FEATURE = 128
CONCAT = skeleton.NUM_PAF_CHANNELS + skeleton.NUM_HEAT_CHANNELS + FEATURE


def branch_layers(stage: int, out_channels: int) -> tuple[tuple[str, int, int, int], ...]:
    """(layer, cin, cout, k) of one branch of ``stage`` (1-based)."""
    if stage == 1:
        return (("conv1", 128, 128, 3), ("conv2", 128, 128, 3), ("conv3", 128, 128, 3),
                ("conv4", 128, 512, 1), ("out", 512, out_channels, 1))
    convs = [("conv1", CONCAT, 128, 7)] + [(f"conv{i}", 128, 128, 7) for i in range(2, 6)]
    return tuple(convs) + (("conv6", 128, 128, 1), ("out", 128, out_channels, 1))


def layer_table(num_stages: int = 6) -> list[tuple[str, int, int, int]]:
    """Every conv as (state-dict prefix, cin, cout, k), in module order."""
    table = [(f"vgg.{name}", cin, cout, 3) for name, cin, cout in
             (v for v in VGG if v != "pool")]
    table += [(f"cpm.{name}", cin, cout, 3) for name, cin, cout in CPM]
    for t in range(1, num_stages + 1):
        for branch, out_c in (("L1", skeleton.NUM_PAF_CHANNELS), ("L2", skeleton.NUM_HEAT_CHANNELS)):
            table += [(f"stage{t}_{branch}.{name}", cin, cout, k)
                      for name, cin, cout, k in branch_layers(t, out_c)]
    return table


def no_tf32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (amax / 448), back in
    bf16; gradients pass the rounding unchanged."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = amax / 448.0
    q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return (x.float() + (q - x.detach().float())).to(torch.bfloat16)


class Net:
    """The network over a parameter dict, in one precision."""

    def __init__(self, params: dict[str, torch.Tensor], precision: str = "bfloat16",
                 num_stages: int = 6):
        if precision not in ("bfloat16", "float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.p = params
        self.precision = precision
        self.num_stages = num_stages
        self.body = torch.float32 if precision == "float32" else torch.bfloat16
        self.head = torch.bfloat16 if precision == "fp8" else torch.float32

    def conv(self, name: str, x: torch.Tensor, head: bool = False) -> torch.Tensor:
        w, b = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        dtype = self.head if head else self.body
        if self.precision == "fp8" and not head:
            x, w = fp8_round(x), fp8_round(w)
        y = F.conv2d(x.to(dtype), w.to(dtype), padding=w.shape[-1] // 2)
        y = y + b.to(dtype)[:, None, None]
        return y if head else torch.relu(y)

    def feature(self, x: torch.Tensor) -> torch.Tensor:
        for layer in VGG:
            if layer == "pool":
                x = F.max_pool2d(x, 2)
            else:
                x = self.conv(f"vgg.{layer[0]}", x)
        for name, _, _ in CPM:
            x = self.conv(f"cpm.{name}", x)
        return x

    def branch(self, stage: int, name: str, out_c: int, x: torch.Tensor) -> torch.Tensor:
        layers = branch_layers(stage, out_c)
        for layer, _, _, _ in layers[:-1]:
            x = self.conv(f"stage{stage}_{name}.{layer}", x)
        return self.conv(f"stage{stage}_{name}.out", x.to(self.head), head=True)

    def stages(self, image: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """Normalised (N, H, W, 3) image -> every stage's (PAF, heat), NHWC."""
        feat = self.feature(image.permute(0, 3, 1, 2))
        out = []
        x = feat
        for t in range(1, self.num_stages + 1):
            paf = self.branch(t, "L1", skeleton.NUM_PAF_CHANNELS, x)
            heat = self.branch(t, "L2", skeleton.NUM_HEAT_CHANNELS, x)
            out.append((paf, heat))
            x = torch.cat([paf.to(self.body), heat.to(self.body), feat], dim=1)
        return [(p.permute(0, 2, 3, 1), h.permute(0, 2, 3, 1)) for p, h in out]

    def last(self, image: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Normalised (N, H, W, 3) image -> the last stage's (PAF, heat),
        NHWC f32."""
        paf, heat = self.stages(image)[-1]
        return paf.float(), heat.float()


def normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 (N, H, W, 3), in the order the weights expect -> img/256 - 0.5."""
    return images.float() / 256.0 - 0.5


def scale_sizes(h: int, w: int, scales, boxsize: int, stride: int):
    """Per scale (resized h, resized w, padded h, padded w): the height
    resized to scale * boxsize, both sides padded up to the stride."""
    out = []
    for s in scales:
        f = s * boxsize / h
        rh, rw = max(int(round(h * f)), 1), max(int(round(w * f)), 1)
        out.append((rh, rw, -(-rh // stride) * stride, -(-rw // stride) * stride))
    return out


def resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Half-pixel bilinear resize of NHWC, no antialiasing (cv2's INTER_LINEAR)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


def averaged_maps(net: Net, images: torch.Tensor, scales, boxsize: int, stride: int):
    """uint8 (N, H, W, 3) -> the scale-averaged full-resolution (heat (N, H,
    W, 19), PAF (N, H, W, 38)) in f32, as the reference demo builds them:
    per scale, resize the image, pad right and down with gray (0 after
    normalising), run the network, upsample its output x stride, crop the
    pad, resize to the image and add 1/len(scales) of it."""
    n, h, w, _ = images.shape
    x0 = normalize(images)
    heat = paf = None
    sizes = scale_sizes(h, w, scales, boxsize, stride)
    for rh, rw, ph, pw in sizes:
        x = resize(x0, rh, rw)
        x = F.pad(x, (0, 0, 0, pw - rw, 0, ph - rh))
        p, q = net.last(x)
        parts = []
        for m in (q, p):
            up = resize(m, ph, pw)[:, :rh, :rw]
            parts.append(resize(up, h, w) / len(sizes))
        heat = parts[0] if heat is None else heat + parts[0]
        paf = parts[1] if paf is None else paf + parts[1]
    return heat, paf
