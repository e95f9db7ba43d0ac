"""Batched on-device augmentation (rot / scale / flip / crop).

Counterpart of ``tpupose/gt/augment.py``. One 2x3 affine per sample is
composed from random draws and applied on the device, so augmentation
rides the training step. Every function here takes a leading batch axis
(the reference writes them per sample and ``vmap``s).

Semantics (AugmentConfig):
  * scale = (target_dist / scale_provided) * U(scale_min, scale_max)
  * rotation U(-max_rotate_degree, +max_rotate_degree)
  * crop to boxsize^2 about the person centre + U(-center_perturb_max,
    +center_perturb_max)^2 perturbation
  * horizontal flip with p = flip_prob, including the L/R part-label
    swap on the joints
  * constant gray border (pad_value) outside the source image

Random draws come from an explicit ``torch.Generator`` and cannot
reproduce ``jax.random``; ``augment_batch`` therefore also takes the
draws themselves (a dict of batched tensors), which is how the parity
tests feed both packages the same augmentation.
"""

from __future__ import annotations

from typing import Mapping

import torch

from tpupose_torch import topology
from tpupose_torch.config import AugmentConfig, ModelConfig

Params = Mapping[str, torch.Tensor]
_MASK63 = (1 << 63) - 1


def sample_params(generator: torch.Generator, aug: AugmentConfig) -> dict[str, torch.Tensor]:
    """Random augmentation draws for one sample (CPU tensors)."""

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator)

    return {
        "scale_mult": uniform((), aug.scale_min, aug.scale_max),
        "degrees": uniform((), -aug.max_rotate_degree, aug.max_rotate_degree),
        "perturb": uniform((2,), -aug.center_perturb_max, aug.center_perturb_max),
        "flip": torch.rand((), generator=generator) < aug.flip_prob,
    }


def identity_params() -> dict[str, torch.Tensor]:
    """Deterministic no-op draws."""
    return {
        "scale_mult": torch.tensor(1.0),
        "degrees": torch.tensor(0.0),
        "perturb": torch.zeros(2),
        "flip": torch.tensor(False),
    }


def batch_params(generator: torch.Generator, aug: AugmentConfig, n: int) -> dict[str, torch.Tensor]:
    """Draws for ``n`` samples, stacked. One seed is taken from
    ``generator``; sample i's draws depend only on (that seed, i), never
    on ``n`` — a padded batch augments its real samples as the unpadded
    one does."""
    seed = int(torch.randint(0, _MASK63, (), generator=generator, dtype=torch.int64))
    rows = []
    for i in range(n):
        g = torch.Generator().manual_seed((seed + 0x9E3779B97F4A7C15 * (i + 1)) & _MASK63)
        rows.append(sample_params(g, aug))
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def affine_matrix(center: torch.Tensor, scale_provided: torch.Tensor, params: Params,
                  aug: AugmentConfig, out_size: int) -> torch.Tensor:
    """(..., 2, 3) source->output affines. center (..., 2) person centre
    in source pixels, scale_provided (...,) person height / boxsize,
    params with matching leading shape."""
    scale = aug.target_dist / torch.clamp(scale_provided, min=1e-6) * params["scale_mult"]
    t = torch.deg2rad(params["degrees"])
    c, s = torch.cos(t), torch.sin(t)
    flip = params["flip"]
    f = torch.where(flip, -1.0, 1.0).to(scale.dtype)

    cx = center[..., 0] + params["perturb"][..., 0]
    cy = center[..., 1] + params["perturb"][..., 1]
    half = out_size / 2.0

    # full = T(out/2) @ Flip @ Rot @ Scale @ T(-center); the flip mirrors
    # about x = (out-1)/2 (x' = out-1-x), hence the extra -1 in tx.
    a00 = f * c * scale
    a01 = f * (-s) * scale
    a10 = s * scale
    a11 = c * scale
    tx = -(a00 * cx + a01 * cy) + half - torch.where(flip, 1.0, 0.0).to(scale.dtype)
    ty = -(a10 * cx + a11 * cy) + half
    return torch.stack([torch.stack([a00, a01, tx], -1), torch.stack([a10, a11, ty], -1)], -2)


def _invert_affine(m: torch.Tensor) -> torch.Tensor:
    det = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    inv00 = m[..., 1, 1] / det
    inv01 = -m[..., 0, 1] / det
    inv10 = -m[..., 1, 0] / det
    inv11 = m[..., 0, 0] / det
    tx = -(inv00 * m[..., 0, 2] + inv01 * m[..., 1, 2])
    ty = -(inv10 * m[..., 0, 2] + inv11 * m[..., 1, 2])
    return torch.stack([torch.stack([inv00, inv01, tx], -1),
                        torch.stack([inv10, inv11, ty], -1)], -2)


def _take(src: torch.Tensor, dim: int, idx: torch.Tensor, border_value: float) -> torch.Tensor:
    """``src`` gathered along ``dim`` (1 or 2 of (N, A, B, C)) at integer
    ``idx`` (N, A', B'); taps outside the axis read ``border_value``."""
    size = src.shape[dim]
    inside = (idx >= 0) & (idx < size)
    index = idx.clamp(0, size - 1)[..., None].expand(*idx.shape, src.shape[-1])
    return torch.where(inside[..., None], torch.gather(src, dim, index), border_value)


def warp_image(img: torch.Tensor, affine: torch.Tensor, out_size: int,
               border_value: float) -> torch.Tensor:
    """Bilinear inverse-mapped warp with constant border: (N, H, W, C)
    images, (N, 2, 3) affines -> (N, out, out, C) f32. Equivalent to
    cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT)."""
    inv = _invert_affine(affine)[:, :, :, None, None]            # (N, 2, 3, 1, 1)
    idx = torch.arange(out_size, dtype=torch.float32, device=img.device)
    xs, ys = idx[None, None, :], idx[None, :, None]
    src_x = inv[:, 0, 0] * xs + inv[:, 0, 1] * ys + inv[:, 0, 2]  # (N, O, O)
    src_y = inv[:, 1, 0] * xs + inv[:, 1, 1] * ys + inv[:, 1, 2]

    n, h, w, c = img.shape
    x0 = torch.floor(src_x)
    y0 = torch.floor(src_y)
    fx = (src_x - x0)[..., None]
    fy = (src_y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = img.to(torch.float32).reshape(n, h * w, c)

    def gather(yy, xx):
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        pix = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(n, -1, 1)
        vals = torch.gather(flat, 1, pix.expand(-1, -1, c)).reshape(n, out_size, out_size, c)
        return torch.where(inside[..., None], vals, border_value)

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def _lerp_axis(src: torch.Tensor, dim: int, pos: torch.Tensor, border_value: float) -> torch.Tensor:
    """2-tap linear interpolation of ``src`` along ``dim`` at ``pos``;
    an out-of-range tap reads ``border_value``. Equal to the hat sum
    ``sum_w max(0, 1-|pos-w|) * src[w] + border * (1 - sum_w hat)``."""
    p0 = torch.floor(pos)
    f = (pos - p0)[..., None]
    i0 = p0.to(torch.int64)
    return (_take(src, dim, i0, border_value) * (1 - f)
            + _take(src, dim, i0 + 1, border_value) * f)


def warp_image_twopass(img: torch.Tensor, affine: torch.Tensor, out_size: int,
                       border_value: float) -> torch.Tensor:
    """Bilinear warp as two 1-D linear resampling passes.

    Pass 1 resamples each *source row* ``v`` horizontally at
    ``q(x, v) = qa*x + qb*v + qc`` (the source column where output column
    ``x``'s inverse-mapped ray crosses row ``v``); pass 2 resamples the
    intermediate vertically at ``r(y, x)``. The composition samples the
    bilinear surface along the correct slanted line; it differs from the
    4-corner bilinear of ``warp_image`` only sub-pixel (identical on
    locally-linear images). Constant-border semantics are
    cv2.BORDER_CONSTANT's. The reference evaluates the same two passes
    as dense hat-weight contractions; a pass is a 2-tap gather here.
    """
    inv = _invert_affine(affine)
    i00, i01, i02 = (inv[:, 0, k, None, None] for k in range(3))   # (N, 1, 1)
    i10, i11, i12 = (inv[:, 1, k, None, None] for k in range(3))
    sh = img.shape[1]
    # i11 = cos(rot)/scale never vanishes for |rot| <= 40deg (AugmentConfig)
    qa = (i00 * i11 - i01 * i10) / i11
    qb = i01 / i11
    qc = i02 - i01 * i12 / i11
    v = torch.arange(sh, dtype=torch.float32, device=img.device)
    x = torch.arange(out_size, dtype=torch.float32, device=img.device)
    q = qa * x[None, None, :] + qb * v[None, :, None] + qc          # (N, sh, O)
    i1 = _lerp_axis(img.to(torch.float32), 2, q, border_value)      # (N, sh, O, C)
    r = i10 * x[None, None, :] + i11 * x[None, :, None] + i12       # (N, O, O)
    return _lerp_axis(i1, 1, r, border_value)


def sample_mask_at_label_grid(msk: torch.Tensor, affine: torch.Tensor, label_size: int,
                              stride: int) -> torch.Tensor:
    """Warp (N, H, W) miss-masks directly onto the stride-N label grid:
    bilinear samples of the source mask at the inverse-mapped label-grid
    centres. Outside-source points read 1.0 (keep loss).

    Composes the affine with the label->image grid map
    (q -> stride*q + stride/2 - 0.5) and reuses ``warp_image``."""
    off = stride / 2.0 - 0.5
    m2 = torch.stack([affine[..., 0] / stride, affine[..., 1] / stride,
                      (affine[..., 2] - off) / stride], -1)
    return warp_image(msk[..., None], m2, label_size, 1.0)[..., 0]


def transform_joints(joints: torch.Tensor, affine: torch.Tensor, flip: torch.Tensor,
                     out_size: int) -> torch.Tensor:
    """Affine on (N, P, 18, 3) joints; L/R label swap on flip; joints
    that leave the frame are marked absent (v = 2)."""
    a = affine[:, :, :, None, None]                                  # (N, 2, 3, 1, 1)
    x = joints[..., 0]
    y = joints[..., 1]
    nx = a[:, 0, 0] * x + a[:, 0, 1] * y + a[:, 0, 2]
    ny = a[:, 1, 0] * x + a[:, 1, 1] * y + a[:, 1, 2]
    out = torch.stack([nx, ny, joints[..., 2]], -1)

    perm = torch.as_tensor(topology.FLIP_PERMUTATION, device=joints.device)
    out = torch.where(flip[:, None, None, None], out[:, :, perm, :], out)

    off = (out[..., 0] < 0) | (out[..., 0] >= out_size) | (out[..., 1] < 0) | (out[..., 1] >= out_size)
    v = torch.where(off, 2.0, out[..., 2])
    return torch.cat([out[..., :2], v[..., None]], -1)


def augment_batch(rng: torch.Generator | Params, images: torch.Tensor, masks: torch.Tensor,
                  joints: torch.Tensor, centers: torch.Tensor, scales: torch.Tensor,
                  model: ModelConfig, aug: AugmentConfig, training: bool = True):
    """Augment a whole batch on the device of ``images``.

    images (N, H, W, 3) float (uint8-valued), masks (N, H, W) in [0, 1],
    joints (N, P, 18, 3), centers (N, 2), scales (N,). ``rng`` is a
    ``torch.Generator`` (see ``batch_params``) or the draws themselves:
    {"scale_mult" (N,), "degrees" (N,), "perturb" (N, 2), "flip" (N,)
    bool}. With ``training=False`` the draws are the identity.

    Returns (aug_images (N, box, box, 3), label_masks (N, L, L),
    aug_joints (N, P, 18, 3)). The mask is sampled directly at the
    inverse-mapped label-grid centres (``sample_mask_at_label_grid``).
    """
    n = images.shape[0]
    box = model.boxsize
    if not training:
        params = {k: v.expand(n, *v.shape) for k, v in identity_params().items()}
    elif isinstance(rng, torch.Generator):
        params = batch_params(rng, aug, n)
    else:
        params = rng
    params = {k: torch.as_tensor(v).to(images.device) for k, v in params.items()}
    m = affine_matrix(centers, scales, params, aug, box)
    warp = warp_image if aug.warp_method == "exact" else warp_image_twopass
    img_w = warp(images, m, box, float(model.pad_value))
    lbl = sample_mask_at_label_grid(masks, m, model.label_size, model.stride)
    jts_w = transform_joints(joints, m, params["flip"], box)
    return img_w, lbl, jts_w
