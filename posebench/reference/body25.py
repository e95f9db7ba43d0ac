"""The plain reference of OpenPose BODY_25 and its decode.

Written from the published architecture (Cao, Hidalgo, Simon, Wei, Sheikh,
TPAMI 2019, arXiv:1812.08008; CMU OpenPose ``models/pose/body_25/
pose_deploy.prototxt``); it imports nothing of the program and takes
nothing the program has made. The network, phi a PReLU of one slope a
channel, every conv stride 1 with SAME zero padding:

  * VGG19 conv1_1 .. conv4_1 + ReLU (2x2 pools after conv1_2, conv2_2,
    conv3_4), conv4_2 + phi, conv4_3_CPM 512 -> 256 + phi, conv4_4_CPM
    256 -> 128 + phi: the feature F;
  * a dense block D(c, w): y0 = phi(conv3(x)), y1 = phi(conv3(y0)), y2 =
    phi(conv3(y1)) -> concat(y0, y1, y2); a stage S(c, w, h, out): D(c, w),
    D(3w, w) x 4, Mconv6 1x1 3w -> h + phi, Mconv7 1x1 h -> out;
  * P_0 = S(128, 96, 256, 52)(F), P_t = S(180, 128, 512, 52)(concat(F,
    P_{t-1})), t = 1..3; H_0 = S(180, 96, 256, 26)(concat(F, P_3)), H_1 =
    S(206, 128, 512, 26)(concat(F, H_0, P_3)); the output (P_3, H_1).

Parameters: f32 tensors ``<scope>.<layer>.weight`` (O, I, kh, kw),
``.bias`` and ``.slope`` under the prototxt's layer names (``layer_table``).
Precision, as the configuration states it:

  ``"bfloat16"``: every conv but the heads on bf16 input and kernel; the
      VGG ReLU convs add their bias in bf16; each PReLU conv adds its f32
      bias and applies its f32 slope in f32 and rounds once to bf16; the
      Mconv7 heads in f32 on f32 input; the stage concats in bf16. TF32 off.
  ``"float32"``: everything in f32, TF32 off.
  ``"fp8"``: the control one step below bf16: each body conv's input and
      kernel rounded to float8 e4m3 under one scale a tensor (amax / 448),
      then as bf16; the heads in bf16.

The decode is the OpenPose demo's on the scale-averaged maps (as
``decode.py`` writes it for COCO-18, its blur and taps imported from there)
over BODY_25's 25 parts and 26 limbs in OpenPose's pair order, limb k
reading PAF channels (2k, 2k + 1); the two shoulder-ear limbs, 18 and 19,
never seed a person.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from posebench.reference.decode import blur
from posebench.reference.model import fp8_round

PARTS = (
    "Nose", "Neck", "RShoulder", "RElbow", "RWrist", "LShoulder", "LElbow", "LWrist",
    "MidHip", "RHip", "RKnee", "RAnkle", "LHip", "LKnee", "LAnkle", "REye", "LEye", "REar",
    "LEar", "LBigToe", "LSmallToe", "LHeel", "RBigToe", "RSmallToe", "RHeel",
)
PART_INDEX = {name: i for i, name in enumerate(PARTS)}
PAIRS = (
    (1, 8), (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (8, 9), (9, 10), (10, 11),
    (8, 12), (12, 13), (13, 14), (1, 0), (0, 15), (15, 17), (0, 16), (16, 18), (2, 17),
    (5, 18), (14, 19), (19, 20), (14, 21), (11, 22), (22, 23), (11, 24),
)
PAF = tuple((2 * k, 2 * k + 1) for k in range(len(PAIRS)))
NO_SEED = (18, 19)
NUM_PAF_CHANNELS, NUM_HEAT_CHANNELS = 2 * len(PAIRS), len(PARTS) + 1

VGG = (("conv1_1", 3, 64), ("conv1_2", 64, 64), "pool", ("conv2_1", 64, 128),
       ("conv2_2", 128, 128), "pool", ("conv3_1", 128, 256), ("conv3_2", 256, 256),
       ("conv3_3", 256, 256), ("conv3_4", 256, 256), "pool", ("conv4_1", 256, 512))
FEATURE = 128
SLOPE_INIT = 0.25       # Caffe's PReLU filler


# (scope, cin, w, h, out) of every stage, in the order they run: the released
# model's 4 PAF stages, then its 2 heat stages
STAGES = (
    ("stage0_L2", FEATURE, 96, 256, NUM_PAF_CHANNELS),
    ("stage1_L2", FEATURE + NUM_PAF_CHANNELS, 128, 512, NUM_PAF_CHANNELS),
    ("stage2_L2", FEATURE + NUM_PAF_CHANNELS, 128, 512, NUM_PAF_CHANNELS),
    ("stage3_L2", FEATURE + NUM_PAF_CHANNELS, 128, 512, NUM_PAF_CHANNELS),
    ("stage0_L1", FEATURE + NUM_PAF_CHANNELS, 96, 256, NUM_HEAT_CHANNELS),
    ("stage1_L1", FEATURE + NUM_PAF_CHANNELS + NUM_HEAT_CHANNELS, 128, 512, NUM_HEAT_CHANNELS),
)


def layer_table() -> list[tuple]:
    """Every layer in the order it runs: (prefix, cin, cout, k) of a conv,
    (prefix, channels) of a PReLU."""
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


class Net:
    """The network over a parameter dict, in one precision."""

    def __init__(self, params: dict[str, torch.Tensor], precision: str = "bfloat16"):
        if precision not in ("bfloat16", "float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.p, self.precision = params, precision
        self.body = torch.float32 if precision == "float32" else torch.bfloat16
        self.head = torch.bfloat16 if precision == "fp8" else torch.float32

    def _conv(self, name: str, x: torch.Tensor, head: bool = False) -> torch.Tensor:
        w = self.p[f"{name}.weight"]
        dtype = self.head if head else self.body
        if self.precision == "fp8" and not head:
            x, w = fp8_round(x), fp8_round(w)
        return F.conv2d(x.to(dtype), w.to(dtype), padding=w.shape[-1] // 2)

    def relu_conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        b = self.p[f"{name}.bias"].to(self.body)[:, None, None]
        return torch.relu(self._conv(name, x) + b)

    def prelu_conv(self, conv: str, prelu: str, x: torch.Tensor) -> torch.Tensor:
        v = self._conv(conv, x).float() + self.p[f"{conv}.bias"].float()[:, None, None]
        s = self.p[f"{prelu}.slope"].float()[:, None, None]
        return torch.where(v > 0, v, s * v).to(self.body)

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
        name = f"{scope}.Mconv7_{scope}"
        y = self._conv(name, x.to(self.head), head=True)
        return y + self.p[f"{name}.bias"].to(self.head)[:, None, None]

    def last(self, image: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
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
        return paf.permute(0, 2, 3, 1).float(), heat.permute(0, 2, 3, 1).float()


def peak_lists(heat: torch.Tensor, cfg: dict) -> list[list[tuple]]:
    """(N, H, W, 26) averaged heat -> per image, per part (xs, ys, scores)
    within the capacity, in the order the capacity rule gives."""
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
    """One image: PAF (H, W, 52) and its peak lists -> per limb the accepted
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
    """The demo's subset assembly and cull over BODY_25's 25 parts."""
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
    """Averaged (N, H, W, 26) heat and (N, H, W, 52) PAF -> people per image."""
    peaks = peak_lists(heat, cfg)
    return [assemble(pk, limb_connections(paf[i], pk, cfg, heat.shape[1]), cfg)
            for i, pk in enumerate(peaks)]

