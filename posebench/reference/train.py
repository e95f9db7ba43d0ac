"""One training step of the OpenPose recipe in plain ``torch``.

Written from the recipe of the reference trainer (CMU's training
prototxt and data transformer) as the frozen numpy oracle
``tpupose_torch/reference_impl/gt_np.py`` and the configuration state it:

  * draws: per step a generator seeded from (run seed, step index), one
    seed from it per batch, and per sample a generator from (that seed,
    sample index) for scale multiplier, rotation, centre perturbation and
    flip (the program's recipe of random numbers, so that both sides draw
    the same augmentation; the numbers are inputs, as the images are);
  * augmentation: the affine T(out/2) Flip Rot Scale T(-centre); the image
    warped as two 1-D linear passes with a gray border, the miss-mask
    sampled bilinearly at the label grid (outside: keep), joints moved and
    their left/right labels swapped on a flip, joints leaving the crop
    absent;
  * labels on the stride-8 grid: gaussians (sigma, cut below 0.01) max
    over people, clipped, background 1 - max; PAF unit vectors in a band
    of half-width paf_thre, averaged where people overlap; all times the
    mask;
  * loss: per stage and branch sum((mask * pred - gt)^2) / batch / 2;
  * MultiSGD: all gradients clipped together by their global norm, then
    per parameter group g + 2 wd w on kernels, trace = g + momentum *
    trace, p -= lr * mult * trace; a group of multiplier 0 is frozen.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from posebench.reference import model as ref_model
from posebench.reference import skeleton

_MASK63 = (1 << 63) - 1
FLIP_PERMUTATION = (0, 1, 5, 6, 7, 2, 3, 4, 11, 12, 13, 8, 9, 10, 15, 14, 17, 16)
_CUTOFF = 4.6052


def step_generator(seed: int, step: int) -> torch.Generator:
    mixed = ((seed + 1) * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9) & _MASK63
    return torch.Generator().manual_seed(mixed)


def draws(gen: torch.Generator, aug: dict, n: int) -> dict[str, torch.Tensor]:
    seed = int(torch.randint(0, _MASK63, (), generator=gen, dtype=torch.int64))
    rows = []
    for i in range(n):
        g = torch.Generator().manual_seed((seed + 0x9E3779B97F4A7C15 * (i + 1)) & _MASK63)

        def uniform(shape, lo, hi, g=g):
            return lo + (hi - lo) * torch.rand(shape, generator=g)

        rows.append({"scale_mult": uniform((), aug["scale_min"], aug["scale_max"]),
                     "degrees": uniform((), -aug["max_rotate_degree"], aug["max_rotate_degree"]),
                     "perturb": uniform((2,), -aug["center_perturb_max"], aug["center_perturb_max"]),
                     "flip": torch.rand((), generator=g) < aug["flip_prob"]})
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def affine(centers, scales, d, aug: dict, out: int) -> torch.Tensor:
    """(N, 2, 3) source -> crop affines in f32, as the configuration's
    augmentation computes them (a joint at the crop's edge stays on the
    side f32 puts it)."""
    dev = centers.device
    d = {k: v.to(dev) for k, v in d.items()}
    scale = aug["target_dist"] / torch.clamp(scales.float(), min=1e-6) * d["scale_mult"]
    t = torch.deg2rad(d["degrees"])
    c, s = torch.cos(t), torch.sin(t)
    flip = d["flip"]
    f = torch.where(flip, -1.0, 1.0).to(scale.dtype)
    cx = centers[:, 0].float() + d["perturb"][:, 0]
    cy = centers[:, 1].float() + d["perturb"][:, 1]
    a00, a01, a10, a11 = f * c * scale, f * (-s) * scale, s * scale, c * scale
    tx = -(a00 * cx + a01 * cy) + out / 2.0 - torch.where(flip, 1.0, 0.0).to(scale.dtype)
    ty = -(a10 * cx + a11 * cy) + out / 2.0
    return torch.stack([torch.stack([a00, a01, tx], -1), torch.stack([a10, a11, ty], -1)], -2)


def invert(m: torch.Tensor) -> torch.Tensor:
    m = m.double()
    full = torch.cat([m, torch.tensor([[[0.0, 0.0, 1.0]]], dtype=m.dtype,
                                      device=m.device).expand(m.shape[0], 1, 3)], 1)
    return torch.linalg.inv(full)[:, :2]


def _lerp(src: torch.Tensor, dim: int, pos: torch.Tensor, border: float) -> torch.Tensor:
    """Linear interpolation of (N, A, B, C) ``src`` along ``dim`` at
    ``pos``; taps outside read ``border``."""
    p0 = torch.floor(pos)
    f = (pos - p0)[..., None].to(src.dtype)
    out = 0.0
    for k, wgt in ((0, 1 - f), (1, f)):
        i = p0.long() + k
        size = src.shape[dim]
        inside = ((i >= 0) & (i < size))[..., None]
        idx = i.clamp(0, size - 1)[..., None].expand(*i.shape, src.shape[-1])
        out = out + wgt * torch.where(inside, torch.gather(src, dim, idx),
                                      torch.full_like(wgt, border))
    return out


def warp_twopass(img: torch.Tensor, m: torch.Tensor, out: int, border: float) -> torch.Tensor:
    """(N, H, W, C) -> (N, out, out, C): rows resampled along the inverse
    map's slanted lines, then columns."""
    inv = invert(m)
    i00, i01, i02 = (inv[:, 0, k, None, None] for k in range(3))
    i10, i11, i12 = (inv[:, 1, k, None, None] for k in range(3))
    sh = img.shape[1]
    qa = (i00 * i11 - i01 * i10) / i11
    qb = i01 / i11
    qc = i02 - i01 * i12 / i11
    v = torch.arange(sh, dtype=torch.float64, device=img.device)
    x = torch.arange(out, dtype=torch.float64, device=img.device)
    q = qa * x[None, None, :] + qb * v[None, :, None] + qc
    rows = _lerp(img.double(), 2, q, border)
    r = i10 * x[None, None, :] + i11 * x[None, :, None] + i12
    return _lerp(rows, 1, r, border)


def mask_at_labels(mask: torch.Tensor, m: torch.Tensor, label: int, stride: int) -> torch.Tensor:
    """(N, H, W) mask in [0, 1] bilinearly sampled at the inverse-mapped
    label-grid centres (stride * q + stride / 2 - 0.5); outside reads 1."""
    inv = invert(m)
    g = torch.arange(label, dtype=torch.float64, device=mask.device) * stride + stride / 2 - 0.5
    xs, ys = g[None, None, :], g[None, :, None]
    sx = inv[:, 0, 0, None, None] * xs + inv[:, 0, 1, None, None] * ys + inv[:, 0, 2, None, None]
    sy = inv[:, 1, 0, None, None] * xs + inv[:, 1, 1, None, None] * ys + inv[:, 1, 2, None, None]
    n, h, w = mask.shape
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    flat = mask.double().reshape(n, h * w)

    def at(yy, xx):
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        pix = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(n, -1)
        vals = torch.gather(flat, 1, pix).reshape(yy.shape)
        return torch.where(inside, vals, torch.ones_like(vals))

    x0, y0 = x0.long(), y0.long()
    top = at(y0, x0) * (1 - fx) + at(y0, x0 + 1) * fx
    bot = at(y0 + 1, x0) * (1 - fx) + at(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def move_joints(joints: torch.Tensor, m: torch.Tensor, flip: torch.Tensor, out: int) -> torch.Tensor:
    j = joints.float()
    a = m[:, :, :, None, None]
    nx = a[:, 0, 0] * j[..., 0] + a[:, 0, 1] * j[..., 1] + a[:, 0, 2]
    ny = a[:, 1, 0] * j[..., 0] + a[:, 1, 1] * j[..., 1] + a[:, 1, 2]
    moved = torch.stack([nx, ny, j[..., 2]], -1)
    perm = torch.as_tensor(FLIP_PERMUTATION, device=joints.device)
    moved = torch.where(flip.to(joints.device)[:, None, None, None], moved[:, :, perm], moved)
    off = (moved[..., 0] < 0) | (moved[..., 0] >= out) | (moved[..., 1] < 0) | (moved[..., 1] >= out)
    v = torch.where(off, torch.full_like(moved[..., 2], 2.0), moved[..., 2])
    return torch.cat([moved[..., :2], v[..., None]], -1).double()


def labels(joints: torch.Tensor, mask: torch.Tensor, label: int, stride: int, sigma: float,
           paf_thre: float):
    """(N, P, 18, 3) joints in crop pixels and the (N, L, L) label mask ->
    (PAF (N, L, L, 38), heat (N, L, L, 19)), times the mask, in f64."""
    dev = joints.device
    g = torch.arange(label, dtype=torch.float64, device=dev) * stride + stride / 2 - 0.5
    gx, gy = g[None, :], g[:, None]
    x, y, v = joints[..., 0], joints[..., 1], joints[..., 2]            # (N, P, 18)
    d2 = (gx - x[..., None, None]) ** 2 + (gy - y[..., None, None]) ** 2  # (N, P, 18, L, L)
    e = d2 / (2 * sigma * sigma)
    val = torch.where(e > _CUTOFF, torch.zeros_like(e), torch.exp(-e))
    val = torch.where((v < 2)[..., None, None], val, torch.zeros_like(val))
    parts = val.amax(1).clamp(0, 1)                                      # (N, 18, L, L)
    heat = torch.cat([parts, (1 - parts.amax(1, keepdim=True))], 1).permute(0, 2, 3, 1)
    lg = torch.arange(label, dtype=torch.float64, device=dev)
    lx, ly = lg[None, None, None, :], lg[None, None, :, None]
    thre = paf_thre / stride
    pafs = []
    for pa, pb in skeleton.LIMBS:
        ja, jb = joints[:, :, pa], joints[:, :, pb]                       # (N, P, 3)
        ok = (ja[..., 2] < 2) & (jb[..., 2] < 2)
        ax, ay = (ja[..., 0] + 0.5) / stride - 0.5, (ja[..., 1] + 0.5) / stride - 0.5
        bx, by = (jb[..., 0] + 0.5) / stride - 0.5, (jb[..., 1] + 0.5) / stride - 0.5
        dx, dy = bx - ax, by - ay
        norm = torch.sqrt(dx * dx + dy * dy)
        ok = ok & (norm >= 1e-8)
        ux, uy = dx / norm.clamp(min=1e-8), dy / norm.clamp(min=1e-8)
        px, py = lx - ax[..., None, None], ly - ay[..., None, None]
        along = px * ux[..., None, None] + py * uy[..., None, None]
        perp = (px * uy[..., None, None] - py * ux[..., None, None]).abs()
        band = ((perp <= thre) & (along >= 0) & (along <= norm[..., None, None])
                & ok[..., None, None]).double()                          # (N, P, L, L)
        count = band.sum(1)
        sx = (band * ux[..., None, None]).sum(1)
        sy = (band * uy[..., None, None]).sum(1)
        c = count.clamp(min=1)
        pafs += [torch.where(count > 0, sx / c, sx), torch.where(count > 0, sy / c, sy)]
    paf = torch.stack(pafs, -1)
    return paf * mask[..., None], heat * mask[..., None]


def losses(outputs, paf_gt, heat_gt, mask, n: int) -> tuple[torch.Tensor, list[torch.Tensor]]:
    m = mask.float()[..., None]
    heads = []
    for paf, heat in outputs:
        for pred, gt in ((paf, paf_gt), (heat, heat_gt)):
            heads.append(torch.sum(torch.square(pred.float() * m - gt.float())) / n / 2.0)
    return sum(heads), heads


def prepare(batch: dict, d: dict, config: dict) -> tuple:
    """A raw batch (device tensors) and its draws -> (normalised crops,
    PAF labels, heat labels, label mask)."""
    m_cfg, aug = config["model"], config["augment"]
    box, stride = m_cfg["boxsize"], m_cfg["stride"]
    label = box // stride
    mask = batch["masks"].double() / 255.0
    a = affine(batch["centers"], batch["scales"], d, aug, box)
    img = warp_twopass(batch["images"].double(), a, box, float(m_cfg["pad_value"]))
    lmask = mask_at_labels(mask, a, label, stride)
    jts = move_joints(batch["joints"], a, d["flip"], box)
    paf, heat = labels(jts, lmask, label, stride, aug["sigma"], aug["paf_thre"])
    return (img.float() / 256.0 - 0.5), paf.float(), heat.float(), lmask.float()


def group(name: str) -> str:
    top = name.split(".")[0]
    if top in ("vgg", "cpm"):
        return top
    return "stage1" if top.startswith("stage1") else "stageT"


def multiplier(name: str, tcfg: dict) -> float:
    vgg = tcfg["vgg_lr_mult"]
    w = name.endswith(".weight")
    table = {"vgg": (vgg, 2.0 * vgg), "cpm": (1.0, 2.0), "stage1": (1.0, 2.0), "stageT": (4.0, 8.0)}
    return table[group(name)][0 if w else 1]


class Trainer:
    """Parameters, momentum and the step count of the reference run."""

    def __init__(self, params: dict[str, torch.Tensor], config: dict, precision: str | None = None):
        self.config = config
        self.t = config["train"]
        self.p = {k: v.detach().clone().float() for k, v in params.items()}
        self.trace = {k: torch.zeros_like(v) for k, v in self.p.items()
                      if multiplier(k, self.t) != 0.0}
        self.count = 0
        self.precision = precision or config["model"]["compute_dtype"]

    def step(self, batch: dict, d: dict) -> tuple[float, dict, dict]:
        """One step; returns (loss, the gradient as the optimizer got it:
        clipped, with weight decay, of the trained parameters, and the
        norm of every parameter's raw gradient)."""
        ref_model.no_tf32()
        x, paf_gt, heat_gt, lmask = prepare(batch, d, self.config)
        leaves = {k: v.clone().requires_grad_() for k, v in self.p.items()}
        net = ref_model.Net(leaves, self.precision, self.config["model"]["num_stages"])
        total, _ = losses(net.stages(x), paf_gt, heat_gt, lmask, x.shape[0])
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(total, [leaves[k] for k in names])))
        with torch.no_grad():
            raw = {k: float(g.double().norm()) for k, g in grads.items()}
            clip = self.t.get("clip_norm")
            scale = 1.0
            if clip is not None:
                norm = math.sqrt(sum(r * r for r in raw.values()))
                scale = 1.0 if norm < clip else clip / norm
            lr = self.t["base_lr"] * self.t["lr_gamma"] ** math.floor(self.count / self.t["lr_step"])
            got = {}
            for k in self.trace:
                g = grads[k] * scale
                if k.endswith(".weight"):
                    g = g + 2.0 * self.t["weight_decay"] * self.p[k]
                self.trace[k] = self.t["momentum"] * self.trace[k] + g
                self.p[k] = self.p[k] - lr * multiplier(k, self.t) * self.trace[k]
                got[k] = g
        self.count += 1
        return float(total.detach()), got, raw


def leaf_gap(got: dict[str, torch.Tensor], want: dict[str, torch.Tensor],
             keep: list[str]) -> tuple[float, str]:
    """The worst leaf of | |got| - |want| | over max(|want leaf|, the
    median leaf's |want|), over the leaves ``keep``."""
    norms = {k: float(want[k].double().norm()) for k in keep}
    median = float(np.median(list(norms.values()))) if norms else 0.0
    worst, at = 0.0, ""
    for k in keep:
        g = abs(float(got[k].double().norm()) - norms[k]) / max(norms[k], median, 1e-30)
        if not math.isfinite(g):
            return math.inf, k
        if g > worst:
            worst, at = g, k
    return worst, at
