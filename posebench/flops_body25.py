"""Operations and bytes of OpenPose BODY_25: the yardstick of ``mfu.body25``
and ``dense_epilogue_roofline``.

Multiply-add FLOPs (2 * H * W * Cin * Cout * k^2 per SAME conv) of VGG19 to
conv4_2 (``flops.vgg_flops``), the two CPM convs and the 4 PAF and 2 heat
dense-block stages (``reference/body25.py``'s layer equations); PReLU,
pool, concatenation and resize work is not counted. About 38.6 MFLOP an
output pixel for the front and 37.6 for the stages.

The epilogue's bound counts, for every epilogue of a forward, its bf16
input read once and its bf16 output written once (2 + 2 bytes a channel
and output pixel), at the memory bandwidth.
"""

from __future__ import annotations

from posebench.flops import PEAK_BYTES_PER_S, scale_sizes, vgg_flops

PAF_CHANNELS, HEAT_CHANNELS, FEATURE = 52, 26, 128
CPM = ((512, 256), (256, FEATURE))

# (cin, w, h, out) of every stage, in the order they run: 4 PAF, 2 heat
STAGES = (
    (FEATURE, 96, 256, PAF_CHANNELS),
    (FEATURE + PAF_CHANNELS, 128, 512, PAF_CHANNELS),
    (FEATURE + PAF_CHANNELS, 128, 512, PAF_CHANNELS),
    (FEATURE + PAF_CHANNELS, 128, 512, PAF_CHANNELS),
    (FEATURE + PAF_CHANNELS, 96, 256, HEAT_CHANNELS),
    (FEATURE + PAF_CHANNELS + HEAT_CHANNELS, 128, 512, HEAT_CHANNELS),
)


def _stage_macs(cin: int, w: int, h: int, out: int) -> int:
    """Multiply-adds a pixel of S(cin, w, h, out): D(cin, w), four D(3w, w)
    (each three 3x3 convs), Mconv6 and Mconv7."""
    def block(c: int) -> int:
        return 9 * (c * w + 2 * w * w)

    return block(cin) + 4 * block(3 * w) + 3 * w * h + h * out


def head_flops(in_h: int, in_w: int) -> int:
    """The CPM convs and every stage at (in_h, in_w) input."""
    pixels = (in_h // 8) * (in_w // 8)
    macs = sum(9 * cin * cout for cin, cout in CPM)
    macs += sum(_stage_macs(*spec) for spec in STAGES)
    return 2 * pixels * macs


def forward_flops(in_h: int, in_w: int) -> int:
    return vgg_flops(in_h, in_w) + head_flops(in_h, in_w)


def pyramid_flops(in_h: int, in_w: int, scales, boxsize: int = 368, stride: int = 8) -> int:
    """FLOPs of one image through the pyramid, at the padded sizes."""
    return sum(forward_flops(ph, pw) for _, _, ph, pw in scale_sizes(in_h, in_w, scales,
                                                                     boxsize, stride))


def epilogue_channels() -> list[int]:
    """The channels of every epilogue of one forward: prelu4_2, the two CPM
    convs, then per stage 15 dense-block convs and Mconv6."""
    out = [512] + [cout for _, cout in CPM]
    for _, w, h, _ in STAGES:
        out += [w] * 15 + [h]
    return out


def dense_epilogue_bound_s(n: int, sizes) -> float:
    """Least time of every epilogue of n images through the pyramid of
    ``sizes`` (``flops.scale_sizes``): bf16 in once and out once."""
    pixels = sum(n * (ph // 8) * (pw // 8) for _, _, ph, pw in sizes)
    return 4 * pixels * sum(epilogue_channels()) / PEAK_BYTES_PER_S
