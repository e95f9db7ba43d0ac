"""Seeded weights of the network, made on the device.

The flax default the program also uses for a fresh model: every kernel
lecun-normal (a normal truncated to [-2, 2], rescaled to unit variance,
times sqrt(1 / fan_in)), every bias zero. All kernels come from one
``trunc_normal_`` call on one flat tensor with a generator on the device.

A random network's maps are small and flat, so nothing would cross the
decode's thresholds. ``scale_heads`` scales the last stage's two output
convs so that the largest heat (parts) and PAF magnitudes that the
reference network gives on a calibration frame at scale 1.0 are the
configuration's; the program's own output is never read for it.
"""

from __future__ import annotations

import math

import torch

from posebench.reference import model as ref_model

_TRUNC_STD = 0.87962566103423978


def make(seed: int, device, num_stages: int = 6) -> dict[str, torch.Tensor]:
    """State-dict-named f32 tensors, (O, I, kh, kw) kernels, on ``device``."""
    table = ref_model.layer_table(num_stages)
    sizes = [cout * cin * k * k for _, cin, cout, k in table]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    params, off = {}, 0
    for (name, cin, cout, k), n in zip(table, sizes):
        std = math.sqrt(1.0 / (cin * k * k)) / _TRUNC_STD
        params[f"{name}.weight"] = (flat[off:off + n] * std).view(cout, cin, k, k)
        params[f"{name}.bias"] = torch.zeros(cout, dtype=torch.float32, device=device)
        off += n
    return params


@torch.no_grad()
def scale_heads(params: dict[str, torch.Tensor], frame: torch.Tensor, config: dict) -> dict:
    """Rescales the last stage's two heads in place from the reference
    network's maps of ``frame`` (uint8 (H, W, 3) on the device) at scale
    1.0, by the configuration's ``calibration``: with ``center``, each
    channel's median moves to 0 (through the bias); then one factor per
    head makes the ``quantile`` of the magnitudes of the heat parts
    ``heat`` and that of the PAF ``paf``. Returns the factors."""
    m = config["model"]
    cal = config["calibration"]
    ref_model.no_tf32()
    net = ref_model.Net(params, m["compute_dtype"], m["num_stages"])
    h, w = frame.shape[:2]
    (rh, rw, ph, pw), = ref_model.scale_sizes(h, w, (1.0,), m["boxsize"], m["stride"])
    x = ref_model.resize(ref_model.normalize(frame[None]), rh, rw)
    x = torch.nn.functional.pad(x, (0, 0, 0, pw - rw, 0, ph - rh))
    paf, heat = net.last(x)
    last = m["num_stages"]
    factors = {}
    for branch, maps, target, used in ((f"stage{last}_L2", heat, cal["heat"], slice(0, -1)),
                                       (f"stage{last}_L1", paf, cal["paf"], slice(None))):
        flat = maps.reshape(-1, maps.shape[-1])
        shift = flat.median(dim=0).values if cal["center"] else torch.zeros_like(flat[0])
        level = torch.quantile((flat - shift)[:, used].abs().flatten(), cal["quantile"])
        f = float(target / level)
        params[f"{branch}.out.weight"].mul_(f)
        params[f"{branch}.out.bias"].sub_(shift).mul_(f)
        factors[branch] = f
    return factors
