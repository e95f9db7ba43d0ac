"""Frozen configuration dataclasses.

The port's own copy of the reference's ``tpupose/config.py``: the same
dataclasses, field names and defaults (``tests/test_torch_imports.py``
holds the two equal field for field), so a configuration written for one
package reads the same in the other. Field names keep the original
vocabulary (thre1, sigma, paf_thre, target_dist, ...).

Some fields tune mechanisms that exist only in the reference's compiled
decode (``pair_tiers``, ``peak_compact_tiers``, ``decode_groups``,
``decode_group_adaptive``); the port carries them so configurations stay
interchangeable and reads only the ones its modules use.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Geometry of the network."""

    boxsize: int = 368          # training / canonical inference input size
    stride: int = 8             # output stride -> 46x46 maps at 368 input
    pad_value: int = 128        # gray padding for right/down pad
    input_channels: int = 3
    num_stages: int = 6         # CPM/PAF refinement stages
    # "bgr" matches cv2-fed pretrained weights; use "rgb" for new models.
    channel_order: str = "bgr"
    # Compute dtype for the conv stack; params stay float32.
    compute_dtype: str = "bfloat16"

    @property
    def label_size(self) -> int:
        return self.boxsize // self.stride   # 46


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Decode hyperparameters."""

    scale_search: tuple[float, ...] = (0.5, 1.0, 1.5, 2.0)
    thre1: float = 0.1          # heatmap peak threshold
    thre2: float = 0.05         # PAF midpoint threshold
    mid_num: int = 10           # samples along each candidate limb segment
    peak_sigma: float = 3.0     # gaussian smoothing before NMS
    connect_min_ratio: float = 0.8   # fraction of midpoints above thre2
    min_subset_cnt: int = 4     # drop skeletons with fewer parts
    min_subset_score: float = 0.4    # drop skeletons with score/cnt below

    # Static capacities of the decode's tables.
    max_peaks: int = 96         # per part channel
    max_people: int = 96        # subset rows returned by the decode
    # Working capacity of the assembly: concurrent PARTIAL people (most
    # are culled by min_subset_cnt at the end) can far exceed the final
    # count. When the table is full, further seeds are dropped.
    scan_people_capacity: int = 256
    # Capacity ladder of the reference's pair scoring and assembly.
    pair_tiers: tuple[int, ...] = (8, 16, 32, 64)
    # Capacity ladder of the reference's peak compaction.
    peak_compact_tiers: tuple[int, ...] = (16,)
    # How the decode reads PAF values at the line-integral sample points:
    # "scalespace" evaluates the scale-averaged bilinear pyramid directly
    # on the per-scale low-res network outputs, "fullres" samples the
    # materialised averaged map. Same sample points, same interpolant.
    paf_readout: str = "scalespace"
    # Greedy acceptance packs valid connections into the leading slots, so
    # capping the per-limb table truncates only beyond this many people.
    max_connections: int = 96   # per limb, bounds the assembly
    # Batched-decode grouping of the reference (density-sorted sub-batches).
    decode_groups: int = 1
    decode_group_adaptive: bool = True

    @property
    def num_scales(self) -> int:
        return len(self.scale_search)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Training augmentation."""

    target_dist: float = 0.6
    scale_min: float = 0.5
    scale_max: float = 1.1
    max_rotate_degree: float = 40.0
    center_perturb_max: float = 40.0
    flip_prob: float = 0.5
    sigma: float = 7.0          # GT heatmap gaussian (368-space pixels)
    paf_thre: float = 8.0       # GT PAF band half-width (368-space pixels)
    # Maximum persons rasterised per sample (static shape of the GT path).
    max_persons: int = 24
    # Image-warp formulation: "twopass" = two 1-D linear resampling passes
    # (sub-pixel different from cv2), "exact" = 4-corner bilinear
    # (parity with cv2.warpAffine).
    warp_method: str = "twopass"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training loop and the MultiSGD optimizer."""

    batch_size: int = 10
    base_lr: float = 4e-5
    momentum: float = 0.9
    weight_decay: float = 5e-4
    # global-norm gradient clipping; None is the original recipe
    clip_norm: float | None = None
    # gradient accumulation: effective batch = batch_size * accum_steps
    accum_steps: int = 1
    lr_gamma: float = 0.333
    lr_step: int = 136106       # iterations per LR step
    max_steps: int = 600000
    # Per-group LR multipliers, the MultiSGD contract:
    # {vgg: 1 (or 0 == frozen for domain adaptation), cpm: (1w, 2b),
    #  stage1: (1w, 2b), stageT: (4w, 8b)}.
    vgg_lr_mult: float = 1.0
    cpm_w_mult: float = 1.0
    cpm_b_mult: float = 2.0
    stage1_w_mult: float = 1.0
    stage1_b_mult: float = 2.0
    stageT_w_mult: float = 4.0
    stageT_b_mult: float = 8.0
    checkpoint_every: int = 2000
    checkpoint_dir: str = "checkpoints"
    log_every: int = 50

    def frozen_vgg(self) -> "TrainConfig":
        """Domain-adaptation variant: VGG base frozen."""
        return dataclasses.replace(self, vgg_lr_mult=0.0)


@dataclasses.dataclass(frozen=True)
class PoseConfig:
    """Top-level bundle handed to every entry point."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    inference: InferenceConfig = dataclasses.field(default_factory=InferenceConfig)
    augment: AugmentConfig = dataclasses.field(default_factory=AugmentConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


DEFAULT = PoseConfig()


def single_scale(cfg: PoseConfig | None = None) -> PoseConfig:
    """Convenience: realtime-style single-scale inference."""
    cfg = cfg or DEFAULT
    return dataclasses.replace(
        cfg, inference=dataclasses.replace(cfg.inference, scale_search=(1.0,))
    )


def with_scales(scales: Sequence[float], cfg: PoseConfig | None = None) -> PoseConfig:
    cfg = cfg or DEFAULT
    return dataclasses.replace(
        cfg, inference=dataclasses.replace(cfg.inference, scale_search=tuple(scales))
    )
