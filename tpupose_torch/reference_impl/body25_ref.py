"""The plain reference of OpenPose BODY_25: network and decode in plain ``torch``.

Written from the published description (Cao, Hidalgo, Simon, Wei, Sheikh,
TPAMI 2019, arXiv:1812.08008; CMU OpenPose ``models/pose/body_25/
pose_deploy.prototxt``) and shares no code with the port: it imports
nothing of ``tpupose_torch`` (its tables are written out below) and no JAX.
The port's ``models/body25.py`` and decode are held against it.

Network, phi a PReLU of one slope a channel, ``conv`` stride 1 with SAME
zero padding:

  * VGG19 conv1_1 .. conv4_1 + ReLU (2x2 max pools after conv1_2, conv2_2,
    conv3_4), conv4_2 + phi (``prelu4_2``), conv4_3_CPM 512 -> 256 + phi,
    conv4_4_CPM 256 -> 128 + phi: the feature F;
  * a dense block D(c, w): y0 = phi(conv3(x)), y1 = phi(conv3(y0)), y2 =
    phi(conv3(y1)) -> concat(y0, y1, y2);
  * a stage S(c, w, h, out): D(c, w), D(3w, w) x 4, Mconv6 1x1 3w -> h +
    phi, Mconv7 1x1 h -> out;
  * P_0 = S(128, 96, 256, 52)(F), P_t = S(180, 128, 512, 52)(concat(F,
    P_{t-1})) for t < 4; H_0 = S(180, 96, 256, 26)(concat(F, P_3)), H_1 =
    S(206, 128, 512, 26)(concat(F, H_0, P_3)); the output (P_3, H_1).

Parameters: a dict of f32 tensors ``<scope>.<layer>.weight`` (O, I, kh,
kw), ``.bias`` and ``.slope``, the prototxt's layer names
(``layer_table``). Precisions (``Net(precision=)``):

  ``"float32"``: everything in f32, TF32 off;
  ``"bfloat16"``: the configuration's recipe: every conv but the heads on
      bf16 input and kernel (f32 accumulation, output rounded to bf16);
      VGG's ReLU convs add their bias in bf16; each PReLU conv adds its f32
      bias and applies its f32 slope in f32 and rounds once to bf16; the
      Mconv7 heads in f32 on f32 input; the stage concats in bf16;
  ``"fp8"``: one step below: each body conv's input and kernel rounded to
      float8 e4m3 under one scale a tensor (amax / 448), then as bf16; the
      heads in bf16.

Decode: the multi-person decode of the OpenPose demo on the scale-averaged
full-resolution maps, over BODY_25's 25 parts and 26 limbs in OpenPose's
pair order: peaks (sigma blur, 4-neighbour maxima above ``thre1``, scored
by the unblurred map; where a part of any image of the batch holds more
than ``max_peaks``, every part keeps its strongest, else the scan order),
limb scores (``mid_num`` rounded points, PAF dotted with the unit vector,
mean plus min(0.5 H / length - 1, 0), more than ``connect_min_ratio`` of
the points above ``thre2`` and a positive score; greedy acceptance over the
best min(512, max_peaks^2) candidates), the demo's subset assembly (limbs
18 and 19, the shoulder-ear pairs, never seed a person) and its cull.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

PARTS = (
    "Nose", "Neck", "RShoulder", "RElbow", "RWrist", "LShoulder", "LElbow", "LWrist",
    "MidHip", "RHip", "RKnee", "RAnkle", "LHip", "LKnee", "LAnkle", "REye", "LEye", "REar",
    "LEar", "LBigToe", "LSmallToe", "LHeel", "RBigToe", "RSmallToe", "RHeel",
)
PAIRS = (
    (1, 8), (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (8, 9), (9, 10), (10, 11),
    (8, 12), (12, 13), (13, 14), (1, 0), (0, 15), (15, 17), (0, 16), (16, 18), (2, 17),
    (5, 18), (14, 19), (19, 20), (14, 21), (11, 22), (22, 23), (11, 24),
)
PAF = tuple((2 * k, 2 * k + 1) for k in range(len(PAIRS)))
NO_SEED = (18, 19)
PAF_CHANNELS, HEAT_CHANNELS = 2 * len(PAIRS), len(PARTS) + 1

VGG = (("conv1_1", 3, 64), ("conv1_2", 64, 64), "pool", ("conv2_1", 64, 128),
       ("conv2_2", 128, 128), "pool", ("conv3_1", 128, 256), ("conv3_2", 256, 256),
       ("conv3_3", 256, 256), ("conv3_4", 256, 256), "pool", ("conv4_1", 256, 512))
FEATURE = 128


# (scope, cin, w, h, out) of every stage, in the order they run: the released
# model's 4 PAF stages, then its 2 heat stages
STAGES = (
    ("stage0_L2", FEATURE, 96, 256, PAF_CHANNELS),
    ("stage1_L2", FEATURE + PAF_CHANNELS, 128, 512, PAF_CHANNELS),
    ("stage2_L2", FEATURE + PAF_CHANNELS, 128, 512, PAF_CHANNELS),
    ("stage3_L2", FEATURE + PAF_CHANNELS, 128, 512, PAF_CHANNELS),
    ("stage0_L1", FEATURE + PAF_CHANNELS, 96, 256, HEAT_CHANNELS),
    ("stage1_L1", FEATURE + PAF_CHANNELS + HEAT_CHANNELS, 128, 512, HEAT_CHANNELS),
)


def layer_table() -> list[tuple]:
    """Every layer as (state-dict prefix, cin, cout, k) for a conv and
    (prefix, channels) for a PReLU, in the order they run."""
    table = [(f"vgg.{v[0]}", v[1], v[2], 3) for v in VGG if v != "pool"]
    table += [("vgg.conv4_2", 512, 512, 3), ("cpm.prelu4_2", 512),
              ("cpm.conv4_3_CPM", 512, 256, 3), ("cpm.prelu4_3_CPM", 256),
              ("cpm.conv4_4_CPM", 256, FEATURE, 3), ("cpm.prelu4_4_CPM", FEATURE)]
    for scope, cin, w, h, out in STAGES:
        for i in range(1, 6):
            for j in range(3):
                c = (cin if i == 1 else 3 * w) if j == 0 else w
                table += [(f"{scope}.Mconv{i}_{scope}_{j}", c, w, 3),
                          (f"{scope}.Mprelu{i}_{scope}_{j}", w)]
        table += [(f"{scope}.Mconv6_{scope}", 3 * w, h, 1), (f"{scope}.Mprelu6_{scope}", h),
                  (f"{scope}.Mconv7_{scope}", h, out, 1)]
    return table


def no_tf32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (amax / 448), in bf16."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = amax / 448.0
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(torch.bfloat16)


class Net:
    """The network over a parameter dict, in one precision."""

    def __init__(self, params: dict[str, torch.Tensor], precision: str = "float32"):
        if precision not in ("float32", "bfloat16", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        no_tf32()
        self.p, self.precision = params, precision
        self.body = torch.float32 if precision == "float32" else torch.bfloat16
        self.head = torch.bfloat16 if precision == "fp8" else torch.float32

    def _conv(self, name: str, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        w = self.p[f"{name}.weight"]
        if self.precision == "fp8" and dtype != self.head:
            x, w = fp8_round(x), fp8_round(w)
        return F.conv2d(x.to(dtype), w.to(dtype), padding=w.shape[-1] // 2)

    def relu_conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        y = self._conv(name, x, self.body)
        return torch.relu(y + self.p[f"{name}.bias"].to(self.body)[:, None, None])

    def prelu_conv(self, conv: str, prelu: str, x: torch.Tensor) -> torch.Tensor:
        v = self._conv(conv, x, self.body).float() + self.p[f"{conv}.bias"].float()[:, None, None]
        s = self.p[f"{prelu}.slope"].float()[:, None, None]
        return torch.where(v > 0, v, s * v).to(self.body)

    def head_conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        y = self._conv(name, x.to(self.head), self.head)
        return y + self.p[f"{name}.bias"].to(self.head)[:, None, None]

    def feature(self, x: torch.Tensor) -> torch.Tensor:
        for layer in VGG:
            x = F.max_pool2d(x, 2) if layer == "pool" else self.relu_conv(f"vgg.{layer[0]}", x)
        x = self.prelu_conv("vgg.conv4_2", "cpm.prelu4_2", x)
        x = self.prelu_conv("cpm.conv4_3_CPM", "cpm.prelu4_3_CPM", x)
        return self.prelu_conv("cpm.conv4_4_CPM", "cpm.prelu4_4_CPM", x)

    def stage(self, scope: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, 6):
            ys = []
            for j in range(3):
                x = self.prelu_conv(f"{scope}.Mconv{i}_{scope}_{j}",
                                    f"{scope}.Mprelu{i}_{scope}_{j}", x)
                ys.append(x)
            x = torch.cat(ys, dim=1)
        x = self.prelu_conv(f"{scope}.Mconv6_{scope}", f"{scope}.Mprelu6_{scope}", x)
        return self.head_conv(f"{scope}.Mconv7_{scope}", x).float()

    def __call__(self, image: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Normalised (N, H, W, 3) image -> the last (PAF, heat), NHWC f32."""
        feat = self.feature(image.permute(0, 3, 1, 2))
        paf = heat = None
        for scope, _, _, _, _ in STAGES:
            if scope.endswith("L2"):
                parts = [feat] if paf is None else [feat, paf]
                paf = self.stage(scope, torch.cat([t.to(self.body) for t in parts], dim=1))
            else:
                parts = [feat, paf] if heat is None else [feat, heat, paf]
                heat = self.stage(scope, torch.cat([t.to(self.body) for t in parts], dim=1))
        return paf.permute(0, 2, 3, 1), heat.permute(0, 2, 3, 1)


# --- the pyramid and its averaged maps ----------------------------------------------


def normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 (N, H, W, 3), in the order the weights expect -> img/256 - 0.5."""
    return images.float() / 256.0 - 0.5


def scale_sizes(h: int, w: int, scales, boxsize: int, stride: int):
    """Per scale (resized h, resized w, padded h, padded w)."""
    out = []
    for s in scales:
        f = s * boxsize / h
        rh, rw = max(int(round(h * f)), 1), max(int(round(w * f)), 1)
        out.append((rh, rw, -(-rh // stride) * stride, -(-rw // stride) * stride))
    return out


def resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Half-pixel bilinear resize of NHWC, no antialiasing."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


def averaged_maps(net: Net, images: torch.Tensor, scales, boxsize: int = 368, stride: int = 8):
    """uint8 (N, H, W, 3) -> scale-averaged (heat (N, H, W, 26), PAF (N, H,
    W, 52)) in f32: per scale resize, pad right and down with gray (0 once
    normalised), run the network, upsample x stride, crop the pad, resize
    to the image, add 1 / len(scales) of it."""
    n, h, w, _ = images.shape
    x0 = normalize(images)
    heat = paf = None
    sizes = scale_sizes(h, w, scales, boxsize, stride)
    for rh, rw, ph, pw in sizes:
        x = F.pad(resize(x0, rh, rw), (0, 0, 0, pw - rw, 0, ph - rh))
        p, q = net(x)
        terms = [resize(resize(m, ph, pw)[:, :rh, :rw], h, w) / len(sizes) for m in (q, p)]
        heat = terms[0] if heat is None else heat + terms[0]
        paf = terms[1] if paf is None else paf + terms[1]
    return heat, paf


# --- the decode ------------------------------------------------------------------------


def gaussian_taps(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _reflect(n: int, r: int, device) -> torch.Tensor:
    j = torch.arange(-r, n + r, device=device) % (2 * n)
    return torch.where(j < n, j, 2 * n - 1 - j)


def blur(maps: torch.Tensor, sigma: float) -> torch.Tensor:
    """(N, H, W, C) -> its separable gaussian blur ('reflect' borders)."""
    taps = torch.as_tensor(gaussian_taps(sigma), dtype=torch.float32, device=maps.device)
    r = (taps.numel() - 1) // 2
    n, h, w, c = maps.shape
    x = maps.permute(0, 3, 1, 2).reshape(n * c, 1, h, w)
    x = F.conv2d(x.index_select(2, _reflect(h, r, maps.device)), taps.view(1, 1, -1, 1))
    x = F.conv2d(x.index_select(3, _reflect(w, r, maps.device)), taps.view(1, 1, 1, -1))
    return x.reshape(n, c, h, w).permute(0, 2, 3, 1)


def peak_lists(heat: torch.Tensor, cfg: dict) -> list[list[tuple]]:
    """(N, H, W, 26) averaged heat -> per image, per part (xs, ys, scores)."""
    parts = heat[..., :len(PARTS)].float()
    smooth = blur(parts, cfg["peak_sigma"])
    pad = F.pad(smooth, (0, 0, 1, 1, 1, 1))
    is_peak = ((smooth >= pad[:, :-2, 1:-1]) & (smooth >= pad[:, 2:, 1:-1])
               & (smooth >= pad[:, 1:-1, :-2]) & (smooth >= pad[:, 1:-1, 2:])
               & (smooth > cfg["thre1"]))
    n, h, w, c = parts.shape
    k = cfg["max_peaks"]
    mask = is_peak.permute(0, 3, 1, 2).reshape(n, c, h * w)
    val = parts.permute(0, 3, 1, 2).reshape(n, c, h * w)
    overflow = bool((mask.sum(-1) > k).any())
    out = []
    for i in range(n):
        per_part = []
        for p in range(c):
            idx = torch.nonzero(mask[i, p]).flatten()
            v = val[i, p, idx]
            if overflow:
                order = torch.sort(v.double(), descending=True, stable=True).indices
                idx, v = idx[order], v[order]
            idx, v = idx[:k].cpu().numpy(), v[:k].cpu().numpy()
            per_part.append((idx % w, idx // w, v.astype(np.float64)))
        out.append(per_part)
    return out


def limb_connections(paf: torch.Tensor, peaks, cfg: dict, height: int) -> list[np.ndarray]:
    """One image's (H, W, 52) PAF and peak lists -> per limb the accepted
    connections, rows [slot_a, slot_b, score]."""
    dev = paf.device
    m = cfg["mid_num"]
    h, w = paf.shape[:2]
    cap = min(512, cfg["max_peaks"] ** 2)
    t = torch.linspace(0.0, 1.0, m, dtype=torch.float64, device=dev)
    out = []
    for (pa, pb), (cx, cy) in zip(PAIRS, PAF):
        xa, ya, _ = peaks[pa]
        xb, yb, _ = peaks[pb]
        if len(xa) == 0 or len(xb) == 0:
            out.append(np.zeros((0, 3)))
            continue
        ax = torch.as_tensor(xa, dtype=torch.float64, device=dev)[:, None]
        ay = torch.as_tensor(ya, dtype=torch.float64, device=dev)[:, None]
        bx = torch.as_tensor(xb, dtype=torch.float64, device=dev)[None, :]
        by = torch.as_tensor(yb, dtype=torch.float64, device=dev)[None, :]
        vx, vy = bx - ax, by - ay
        norm = torch.sqrt(vx * vx + vy * vy)
        safe = torch.clamp(norm, min=1e-8)
        mx = torch.round(ax[..., None] + vx[..., None] * t).long().clamp(0, w - 1)
        my = torch.round(ay[..., None] + vy[..., None] * t).long().clamp(0, h - 1)
        mid = (paf[my, mx, cx].double() * (vx / safe)[..., None]
               + paf[my, mx, cy].double() * (vy / safe)[..., None])
        score = mid.mean(-1) + torch.clamp(0.5 * height / safe - 1.0, max=0.0)
        ok = (((mid > cfg["thre2"]).sum(-1) > cfg["connect_min_ratio"] * m) & (score > 0)
              & (norm > 1e-8))
        flat = torch.where(ok, score, torch.full_like(score, -math.inf)).flatten()
        top, idx = torch.sort(flat, descending=True, stable=True)
        top, idx = top[:cap].cpu().numpy(), idx[:cap].cpu().numpy()
        nb, limit = len(xb), min(len(xa), len(xb))
        used_a, used_b, rows = set(), set(), []
        for s, f in zip(top, idx):
            if not np.isfinite(s):
                break
            i, j = divmod(int(f), nb)
            if i in used_a or j in used_b:
                continue
            rows.append((i, j, float(s)))
            used_a.add(i)
            used_b.add(j)
            if len(rows) >= limit:
                break
        out.append(np.asarray(rows, np.float64).reshape(-1, 3))
    return out


def assemble(peaks, connections, cfg: dict) -> list[dict]:
    """The demo's subset assembly and cull over BODY_25 -> people
    ({"keypoints": {part: {x, y, score}}, "score", "num_parts"})."""
    n_parts = len(PARTS)
    offsets = np.cumsum([0] + [len(p[0]) for p in peaks])
    cand = np.concatenate([np.stack([p[0], p[1], p[2]], 1).astype(np.float64)
                           if len(p[0]) else np.zeros((0, 3)) for p in peaks])
    subset = -1 * np.ones((0, n_parts + 2))
    for k, (index_a, index_b) in enumerate(PAIRS):
        conn = connections[k]
        if len(conn) == 0:
            continue
        part_as = conn[:, 0] + offsets[index_a]
        part_bs = conn[:, 1] + offsets[index_b]
        for i in range(len(conn)):
            found = 0
            subset_idx = [-1, -1]
            for j in range(len(subset)):
                if subset[j][index_a] == part_as[i] or subset[j][index_b] == part_bs[i]:
                    if found < 2:
                        subset_idx[found] = j
                    found += 1
            if found == 1:
                j = subset_idx[0]
                if subset[j][index_b] != part_bs[i]:
                    subset[j][index_b] = part_bs[i]
                    subset[j][-1] += 1
                    subset[j][-2] += cand[int(part_bs[i]), 2] + conn[i][2]
            elif found == 2:
                j1, j2 = subset_idx
                membership = ((subset[j1] >= 0).astype(int) + (subset[j2] >= 0).astype(int))[:-2]
                if np.count_nonzero(membership == 2) == 0:
                    subset[j1][:-2] += subset[j2][:-2] + 1
                    subset[j1][-2:] += subset[j2][-2:]
                    subset[j1][-2] += conn[i][2]
                    subset = np.delete(subset, j2, 0)
                else:
                    subset[j1][index_b] = part_bs[i]
                    subset[j1][-1] += 1
                    subset[j1][-2] += cand[int(part_bs[i]), 2] + conn[i][2]
            elif not found and k not in NO_SEED:
                row = -1 * np.ones(n_parts + 2)
                row[index_a] = part_as[i]
                row[index_b] = part_bs[i]
                row[-1] = 2
                row[-2] = cand[int(part_as[i]), 2] + cand[int(part_bs[i]), 2] + conn[i][2]
                subset = np.vstack([subset, row])
    people = []
    for row in subset:
        if row[-1] < cfg["min_subset_cnt"] or row[-2] / row[-1] < cfg["min_subset_score"]:
            continue
        kps = {}
        for p in range(n_parts):
            pid = int(row[p])
            if pid >= 0:
                x, y, s = cand[pid]
                kps[PARTS[p]] = {"x": float(x), "y": float(y), "score": float(s)}
        people.append({"keypoints": kps, "score": float(row[-2]), "num_parts": int(row[-1])})
    return people


def decode_batch(heat: torch.Tensor, paf: torch.Tensor, cfg: dict) -> list[list[dict]]:
    """Averaged (N, H, W, 26) heat and (N, H, W, 52) PAF -> people per image.
    ``cfg``: thre1, thre2, mid_num, peak_sigma, connect_min_ratio,
    min_subset_cnt, min_subset_score, max_peaks."""
    peaks = peak_lists(heat, cfg)
    return [assemble(pk, limb_connections(paf[i], pk, cfg, heat.shape[1]), cfg)
            for i, pk in enumerate(peaks)]
