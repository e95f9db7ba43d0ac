"""NumPy ground-truth rasterisation and augmentation oracle of the port.

The port's own copy of ``tpupose/reference_impl/gt_np.py`` (held to it
code for code by tests/test_torch_imports.py), over the port's
``topology`` and ``config``: gaussian part heatmaps max-combined across
persons with a background channel, PAF unit-vector bands count-averaged
across persons, on the stride-8 label grid with half-pixel grid centres;
the augmentation's affine, its exact and two-pass bilinear warps and the
joints' transform. It shares no code with ``gt/`` or ``ops/gt.py``, which
are held against it (chip_smoke.py phase n on the card).

Joint convention: ``joints`` is (P, 18, 3) float — (x, y, v) in input-image
(368-space) pixels; v < 2 means the joint is present/usable, v == 2 means
absent.
"""

from __future__ import annotations

import numpy as np

from tpupose_torch import topology
from tpupose_torch.config import AugmentConfig, ModelConfig

_LN100_X2 = 4.6052 * 2.0  # exp cutoff: values below exp(-4.6052) ~= 0.01 -> 0


def _label_grid(model: ModelConfig) -> tuple[np.ndarray, np.ndarray]:
    n = model.label_size
    s = model.stride
    xs = np.arange(n, dtype=np.float64) * s + s / 2.0 - 0.5
    grid_x, grid_y = np.meshgrid(xs, xs)
    return grid_x, grid_y


def put_gaussian_maps_np(
    joints: np.ndarray,
    model: ModelConfig | None = None,
    aug: AugmentConfig | None = None,
) -> np.ndarray:
    """(46, 46, 19) heatmaps: 18 parts (max over persons) + background."""
    model = model or ModelConfig()
    aug = aug or AugmentConfig()
    grid_x, grid_y = _label_grid(model)
    n = model.label_size
    out = np.zeros((n, n, topology.NUM_HEAT_CHANNELS), dtype=np.float64)

    denom = 2.0 * aug.sigma * aug.sigma
    for part in range(topology.NUM_PARTS):
        for person in range(joints.shape[0]):
            x, y, v = joints[person, part]
            if v >= 2:
                continue
            d2 = (grid_x - x) ** 2 + (grid_y - y) ** 2
            exponent = d2 / denom
            val = np.where(exponent > _LN100_X2 / 2.0, 0.0, np.exp(-exponent))
            out[:, :, part] = np.maximum(out[:, :, part], val)
    np.clip(out, 0.0, 1.0, out=out)
    out[:, :, topology.BACKGROUND_CHANNEL] = 1.0 - out[
        :, :, : topology.NUM_PARTS
    ].max(axis=2)
    return out


def put_vector_maps_np(
    joints: np.ndarray,
    model: ModelConfig | None = None,
    aug: AugmentConfig | None = None,
) -> np.ndarray:
    """(46, 46, 38) PAFs: per-limb unit vectors, count-averaged on overlap."""
    model = model or ModelConfig()
    aug = aug or AugmentConfig()
    n = model.label_size
    s = float(model.stride)
    thre = aug.paf_thre / s  # band half-width in label-grid units

    xs = np.arange(n, dtype=np.float64)
    gx, gy = np.meshgrid(xs, xs)

    out = np.zeros((n, n, topology.NUM_PAF_CHANNELS), dtype=np.float64)
    count = np.zeros((n, n, topology.NUM_LIMBS), dtype=np.float64)

    for k, (pa, pb) in enumerate(topology.LIMBS):
        for person in range(joints.shape[0]):
            xa, ya, va = joints[person, pa]
            xb, yb, vb = joints[person, pb]
            if va >= 2 or vb >= 2:
                continue
            # label-grid coordinates (half-pixel grid centres)
            ax, ay = (xa + 0.5) / s - 0.5, (ya + 0.5) / s - 0.5
            bx, by = (xb + 0.5) / s - 0.5, (yb + 0.5) / s - 0.5
            dx, dy = bx - ax, by - ay
            norm = np.sqrt(dx * dx + dy * dy)
            if norm < 1e-8:
                continue
            ux, uy = dx / norm, dy / norm
            # perpendicular distance and along-limb projection
            px, py = gx - ax, gy - ay
            along = px * ux + py * uy
            perp = np.abs(px * uy - py * ux)
            band = (perp <= thre) & (along >= 0.0) & (along <= norm)
            out[:, :, 2 * k] += band * ux
            out[:, :, 2 * k + 1] += band * uy
            count[:, :, k] += band

    nz = count > 0
    for k in range(topology.NUM_LIMBS):
        m = nz[:, :, k]
        out[:, :, 2 * k][m] /= count[:, :, k][m]
        out[:, :, 2 * k + 1][m] /= count[:, :, k][m]
    return out


def create_heatmaps_np(
    joints: np.ndarray,
    mask: np.ndarray | None = None,
    model: ModelConfig | None = None,
    aug: AugmentConfig | None = None,
) -> np.ndarray:
    """(46, 46, 57) = [38 PAF | 19 heat], miss-mask multiplied in.

    ``mask`` is the (46, 46) loss mask in [0, 1] (1 = keep).
    """
    model = model or ModelConfig()
    aug = aug or AugmentConfig()
    paf = put_vector_maps_np(joints, model, aug)
    heat = put_gaussian_maps_np(joints, model, aug)
    labels = np.concatenate([paf, heat], axis=2)
    if mask is not None:
        labels = labels * mask[:, :, None]
    return labels


# --- Augmentation twin -------------------------------------------------------


def affine_matrix_np(
    center: tuple[float, float],
    scale: float,
    degrees: float,
    flip: bool,
    out_size: int,
    perturb: tuple[float, float] = (0.0, 0.0),
) -> np.ndarray:
    """2x3 source->output affine, composed as the reference transformer does:
    move center (+perturb) to origin, scale, rotate, optional
    h-flip, then translate to output centre.
    """
    cx = center[0] + perturb[0]
    cy = center[1] + perturb[1]
    t = np.deg2rad(degrees)
    c, s = np.cos(t), np.sin(t)

    def mat3(m):
        return np.asarray(m, dtype=np.float64)

    center_to_origin = mat3([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]])
    scale_m = mat3([[scale, 0, 0], [0, scale, 0], [0, 0, 1]])
    rot = mat3([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    flip_m = mat3([[-1 if flip else 1, 0, 0], [0, 1, 0], [0, 0, 1]])
    # cv2.flip mirrors about x = (out-1)/2 (x' = out-1-x), hence the -1
    # in the output translation when flipped.
    tx = out_size / 2.0 - (1.0 if flip else 0.0)
    to_out = mat3([[1, 0, tx], [0, 1, out_size / 2.0], [0, 0, 1]])

    full = to_out @ flip_m @ rot @ scale_m @ center_to_origin
    return full[:2]


def warp_image_np(
    img: np.ndarray, affine: np.ndarray, out_size: int, border_value
) -> np.ndarray:
    """Bilinear warp via inverse mapping; constant border fill.

    Equivalent to cv2.warpAffine(img, affine, (out, out), INTER_LINEAR,
    BORDER_CONSTANT, border_value) but dependency-free.
    """
    inv = np.linalg.inv(np.vstack([affine, [0, 0, 1]]))[:2]
    ys, xs = np.mgrid[0:out_size, 0:out_size].astype(np.float64)
    src_x = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    src_y = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]

    h, w = img.shape[:2]
    x0 = np.floor(src_x).astype(np.int64)
    y0 = np.floor(src_y).astype(np.int64)
    fx = src_x - x0
    fy = src_y - y0

    def sample(yy, xx):
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        yc = np.clip(yy, 0, h - 1)
        xc = np.clip(xx, 0, w - 1)
        vals = img[yc, xc].astype(np.float64)
        fill = np.asarray(border_value, dtype=np.float64)
        if img.ndim == 3:
            return np.where(inside[..., None], vals, fill)
        return np.where(inside, vals, float(fill))

    v00 = sample(y0, x0)
    v01 = sample(y0, x0 + 1)
    v10 = sample(y0 + 1, x0)
    v11 = sample(y0 + 1, x0 + 1)
    if img.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def warp_image_twopass_np(
    img: np.ndarray, affine: np.ndarray, out_size: int, border_value
) -> np.ndarray:
    """Two 1-D dense-hat resampling passes (slanted-line bilinear): the
    oracle of ``gt.augment.warp_image_twopass``, which takes each pass as
    a 2-tap gather."""
    inv = np.linalg.inv(np.vstack([affine, [0, 0, 1]]))[:2]
    i00, i01, i02 = inv[0]
    i10, i11, i12 = inv[1]
    sh, sw = img.shape[:2]
    squeeze = img.ndim == 2
    imgf = (img[..., None] if squeeze else img).astype(np.float64)
    c = imgf.shape[2]
    qa = (i00 * i11 - i01 * i10) / i11
    qb = i01 / i11
    qc = i02 - i01 * i12 / i11

    x = np.arange(out_size, dtype=np.float64)
    w = np.arange(sw, dtype=np.float64)
    i1 = np.zeros((sh, out_size, c))
    for vi in range(sh):                                   # pass 1: rows
        q = qa * x + qb * vi + qc                          # (O,)
        hat = np.maximum(0.0, 1.0 - np.abs(q[:, None] - w))  # (O, sw)
        i1[vi] = hat @ imgf[vi] + border_value * (1.0 - hat.sum(1))[:, None]

    y = np.arange(out_size, dtype=np.float64)
    v = np.arange(sh, dtype=np.float64)
    out = np.zeros((out_size, out_size, c))
    for yi in range(out_size):                             # pass 2: columns
        r = i10 * x + i11 * yi + i12                       # (O,)
        hat = np.maximum(0.0, 1.0 - np.abs(r[:, None] - v))  # (O, sh)
        out[yi] = np.einsum("xv,vxc->xc", hat, i1)
        out[yi] += border_value * (1.0 - hat.sum(1))[:, None]
    return out[..., 0] if squeeze else out


def transform_joints_np(
    joints: np.ndarray, affine: np.ndarray, flip: bool, out_size: int
) -> np.ndarray:
    """Apply affine to (P, 18, 3) joints; swap L/R labels on flip; mark
    out-of-frame joints absent (v=2)."""
    out = joints.copy()
    xy = out[:, :, :2]
    ones = np.ones((*xy.shape[:2], 1))
    homog = np.concatenate([xy, ones], axis=2)
    out[:, :, 0] = homog @ affine[0]
    out[:, :, 1] = homog @ affine[1]
    if flip:
        out = out[:, list(topology.FLIP_PERMUTATION), :]
    off = (
        (out[:, :, 0] < 0)
        | (out[:, :, 0] >= out_size)
        | (out[:, :, 1] < 0)
        | (out[:, :, 1] >= out_size)
    )
    out[:, :, 2] = np.where(off, 2.0, out[:, :, 2])
    return out
