"""Deployment bundles (.tppx): the estimator's batched programs, exported.

Counterpart of ``tpupose/deploy.py``, on ``torch.export`` where the
reference uses ``jax.export``:

  * ``save_bundle`` exports every batched inference program live serving
    can reach — one per (bucket canvas x power-of-two device batch), the
    geometries ``serve.MicroBatcher`` runs — into one ``.tppx`` zip, with
    ONE copy of the weights and a manifest (shapes, scales, readout,
    sha256 per member).
  * ``load_bundle`` returns a ``DeployedEstimator`` that duck-types
    ``PoseEstimator`` where the serving stack uses it, so it drops into
    the HTTP server (``serve --program model.tppx``), the micro-batcher,
    warmup and ``buckets.BucketedRunner`` unchanged.

A program is ``PoseEstimator.program`` — (weights, images uint8 (n, h, w,
3), valid_hw int32 (n, 2)) -> the people tables — traced once per
geometry. The hand-written kernels are registered operators
(``tpupose_torch::block1``, ``::pyramid_peak_scores``, ``::sample_avg``,
``::assoc``, ``::peak_scores``; ``tpupose_torch.ops``), so each call is
one node of the graph, and everything they read on the host (packed
weights, band and tap tables) is built inside their CUDA kernels at run
time, never baked into the program. The decode's peak-overflow switch is
a ``torch.cond`` over both table orders. Pyramid, readout, capacities and
thresholds are compiled in.

The weights are arguments of every program, not its state: the programs
of a bundle share one ``weights.npz`` (the flax-layout tree of
``models.weights.to_flax``, '/'-joined keys, as in the reference's
bundle), and a program is a graph of a few hundred kilobytes. On the
device a 4-D kernel (HWIO) is held as a view of an OIHW tensor in
``channels_last``, the live estimator's layout, so cuDNN meets the same
operands and the bundle's tables equal the live estimator's bit for bit.

Loading needs the port's operator registrations (``tpupose_torch.ops``)
and the decode's ``to_people``, never the model's code
(``tpupose_torch.models``) nor ``tpupose_torch.infer``. A program names
the device it was traced on, index included (``torch.export`` writes it
into the graph's factory calls), and the manifest records it as
``"device"``. ``load_bundle`` refuses another device type and retargets
the programs to another index of the same type (``retarget``).
"""

from __future__ import annotations

import hashlib
import io
import json
import time
import zipfile
from typing import Any, Iterable

import numpy as np
import torch

FORMAT = "tppx-torch-v1"
_MANIFEST = "manifest.json"
_WEIGHTS = "weights.npz"


def _pow2_sizes(max_batch: int) -> list[int]:
    """1, 2, 4, ... up to ceil_pow2(max_batch) — the micro-batcher's
    device-batch buckets (serve.MicroBatcher pads to the next power of
    two, so these are exactly the reachable batch dimensions)."""
    top = 1 << (max(1, int(max_batch)) - 1).bit_length()
    return [1 << i for i in range(top.bit_length())]


def _flatten_params(params) -> dict[str, np.ndarray]:
    """Nested dict of arrays -> {'a/b/c': array}, keys in sorted order at
    every level (the reference's ``tree_flatten_with_path`` order).
    Refuses trees the '/'-joined key scheme cannot round-trip (a non-dict
    node on the way, '/' inside a key)."""
    flat: dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for key in sorted(node):
                if "/" in str(key):
                    raise ValueError(
                        f"param key {key!r} contains '/', which collides with "
                        "the bundle's flattened-key separator"
                    )
                walk(node[key], (*path, str(key)))
        elif isinstance(node, (list, tuple)):
            raise ValueError(
                "save_bundle supports plain nested-dict param trees "
                f"only; found a non-dict node at {path!r}"
            )
        else:
            flat["/".join(path)] = np.asarray(node)

    walk(params, ())
    return flat


def _unflatten_params(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, arr in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def _order(keys) -> list[str]:
    """The programs' argument order: ``_flatten_params``' order."""
    return sorted(keys, key=lambda k: k.split("/"))


def device_params(flat: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """A bundle's flax-layout weights as a program's arguments on
    ``device``, f32: a 4-D kernel (HWIO) as a view of an OIHW tensor in
    ``channels_last``, the live estimator's layout (``infer.py``), so that
    the program's convolutions run on the same operands."""
    out = {}
    for key in _order(flat):
        t = torch.from_numpy(np.ascontiguousarray(flat[key], dtype=np.float32)).to(device)
        if t.dim() == 4:
            t = t.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            t = t.permute(2, 3, 1, 0)
        out[key] = t
    return out


def _live_params(estimator) -> dict[str, torch.Tensor]:
    """The live model's parameters under their flax keys, as
    ``device_params`` lays them out (HWIO views of the OIHW tensors)."""
    out = {}
    for name, t in estimator.model.state_dict().items():
        scope, layer, leaf = name.split(".")
        if leaf == "weight":
            out[f"{scope}/{layer}/kernel"] = t.permute(2, 3, 1, 0)
        elif leaf == "bias":
            out[f"{scope}/{layer}/bias"] = t
        else:
            raise ValueError(f"unknown state_dict entry {name}")
    return {key: out[key] for key in _order(out)}


class _Program(torch.nn.Module):
    """``PoseEstimator.program`` as a module whose inputs are the weights:
    it owns no parameters (the estimator's bound method is no submodule),
    so the exported program holds none."""

    def __init__(self, estimator, scales):
        super().__init__()
        self._run = estimator.program
        self._scales = scales

    def forward(self, params: dict[str, torch.Tensor], images: torch.Tensor,
                valid_hw: torch.Tensor) -> dict[str, torch.Tensor]:
        state = {}
        for key, t in params.items():
            scope, layer, leaf = key.split("/")
            if leaf == "kernel":
                state[f"{scope}.{layer}.weight"] = t.permute(3, 2, 0, 1)
            else:
                state[f"{scope}.{layer}.bias"] = t
        return self._run(state, images, valid_hw, self._scales)


def export_program(estimator, n: int, h: int, w: int,
                   scales: tuple[float, ...] | None = None) -> bytes:
    """Serialize ONE batched program (masked: takes ``valid_hw``).

    The program's signature is ``(params, images uint8 (n, h, w, 3),
    valid_hw int32 (n, 2)) -> decode tables``, ``params`` the flax-keyed
    weights of ``device_params`` (arguments, so a bundle stores them
    once). Traced on the estimator's device with ``torch.export`` under
    ``torch.no_grad``; raises if the program captured any weight.
    """
    scales_t = tuple(scales) if scales else tuple(estimator.cfg.inference.scale_search)
    dev = estimator.device
    args = (
        _live_params(estimator),
        torch.zeros((n, h, w, 3), dtype=torch.uint8, device=dev),
        torch.tensor([[h, w]] * n, dtype=torch.int32, device=dev),
    )
    with torch.no_grad():
        ep = torch.export.export(_Program(estimator, scales_t), args, strict=False)
    if ep.state_dict:
        raise RuntimeError(f"export_program: the program holds {len(ep.state_dict)} tensors "
                           "of state; the weights must be its arguments")
    # the example arguments (the weights among them) would be saved with it
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _indexed(device: torch.device) -> torch.device:
    """``device`` with its index: a CUDA device without one is the current."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def retarget(manifest: dict, device: torch.device) -> dict[str, str]:
    """The device map that moves a bundle's programs onto ``device`` (an
    indexed device): ``{}`` where they were exported on it, else the map
    that ``torch.export.passes.move_to_device_pass`` applies to every
    program. A bundle written before the manifest held ``"device"`` was
    exported on ``cuda:0`` or ``cpu``. Raises ``ValueError`` for another
    device type than the export's."""
    kind = manifest.get("device_type")
    if kind != device.type:
        raise ValueError(f"the programs were exported for {kind!r} devices; "
                         f"cannot run them on {device}")
    exported = torch.device(manifest.get("device", "cuda:0" if kind == "cuda" else "cpu"))
    if exported.type != kind:
        raise ValueError(f"the manifest names device {exported} for device type {kind!r}")
    if exported == device:
        return {}
    # "cuda" without an index would be the current device at run time
    return {str(exported): str(device), exported.type: str(device)}


def save_bundle(path: str, estimator,
                buckets: Iterable[tuple[int, int]],
                max_batch: int = 8,
                scales: tuple[float, ...] | None = None,
                log=None) -> dict:
    """Export every (bucket x pow2-batch <= max_batch) program + weights
    into a ``.tppx`` zip at ``path``. Returns the manifest dict."""
    from tpupose_torch.models import weights as weights_lib

    buckets = [tuple(map(int, b)) for b in buckets]
    if not buckets:
        raise ValueError("save_bundle needs a non-empty bucket ladder")
    sizes = _pow2_sizes(max_batch)
    scales_t = tuple(scales) if scales else tuple(estimator.cfg.inference.scale_search)

    flat = _flatten_params(weights_lib.to_flax(estimator.model.state_dict()))
    wbuf = io.BytesIO()
    # compressed: np.savez stores raw .npy members
    np.savez_compressed(wbuf, **flat)
    wbytes = wbuf.getvalue()

    members: list[tuple[str, bytes]] = [(_WEIGHTS, wbytes)]
    programs = []
    for bh, bw in buckets:
        for nb in sizes:
            t0 = time.perf_counter()
            blob = export_program(estimator, nb, bh, bw, scales_t)
            name = f"programs/{bh}x{bw}_b{nb}.pt2"
            members.append((name, blob))
            programs.append({
                "h": bh, "w": bw, "n": nb, "file": name,
                "bytes": len(blob),
                "sha256": hashlib.sha256(blob).hexdigest(),
            })
            if log is not None:
                log(f"exported {bh}x{bw} batch={nb}: {len(blob)} bytes in "
                    f"{time.perf_counter() - t0:.1f} s")

    manifest = {
        "format": FORMAT,
        "torch_version": torch.__version__,
        "device_type": estimator.device.type,
        "device": str(_indexed(estimator.device)),
        "scales": list(scales_t),
        "buckets": [list(b) for b in buckets],
        "max_batch": int(max_batch),
        "pretrained": bool(getattr(estimator, "pretrained", False)),
        "num_stages": int(estimator.cfg.model.num_stages),
        "compute_dtype": str(estimator.cfg.model.compute_dtype),
        "paf_readout": str(estimator.cfg.inference.paf_readout),
        "weights_sha256": hashlib.sha256(wbytes).hexdigest(),
        "programs": programs,
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        # STORED: the weights npz is already deflated above
        zf.writestr(_MANIFEST, json.dumps(manifest, indent=1))
        for name, blob in members:
            zf.writestr(name, blob)
    return manifest


class DeployedEstimator:
    """Serving estimator backed by exported programs, not Python model
    code. Duck-types the slice of ``PoseEstimator`` the serving stack
    uses (``process_batch_async``/``_finish``/``process_batch``/
    ``process``/``pretrained``), so it drops into ``serve()``,
    ``MicroBatcher``, ``warmup_estimator`` and ``BucketedRunner``
    unchanged. ``params`` are the programs' weight arguments on
    ``device``."""

    def __init__(self, manifest: dict, params: dict[str, torch.Tensor], programs: dict,
                 device: torch.device):
        self.manifest = manifest
        self.params = params
        self.device = device
        self.pretrained = bool(manifest.get("pretrained", False))
        self.buckets = tuple(tuple(b) for b in manifest["buckets"])
        # the serving ceiling is the largest exported batch dimension,
        # not the raw --max-batch argument (export rounds up to the
        # next power of two, so a bundle built with --max-batch 5
        # really serves batches of 8)
        self.max_batch = max(
            (int(p["n"]) for p in manifest["programs"]),
            default=int(manifest["max_batch"]),
        )
        self.scales = tuple(manifest["scales"])
        self._programs = programs      # (n, h, w) -> ExportedProgram
        self._calls: dict[tuple, Any] = {}

    def _call(self, key: tuple):
        if key not in self._calls:
            ep = self._programs.get(key)
            if ep is None:
                have = sorted(self._programs)
                raise ValueError(
                    f"bundle has no program for (n, h, w)={key}; "
                    f"available: {have}"
                )
            self._calls[key] = ep.module()
        return self._calls[key]

    def process_batch_async(self, images: np.ndarray,
                            scales: tuple[float, ...] | None = None,
                            valid_hw: np.ndarray | None = None):
        """Enqueue the exported program; returns (n, device tables).

        Same contract as ``PoseEstimator.process_batch_async`` except
        the canvas must exist in the bundle and ``scales`` cannot
        deviate from the exported ladder (it is compiled in). Batch
        sizes between exported programs are padded up to the next
        exported power of two (copies of the last image, dropped by
        ``_finish``), so callers that pad to arbitrary batch sizes —
        ``buckets.BucketedRunner`` pads to its ``batch_size`` — still
        land on an exported program."""
        if scales is not None and tuple(scales) != self.scales:
            raise ValueError(
                f"bundle was exported with scales={self.scales}; "
                f"cannot run scales={tuple(scales)} (the pyramid is "
                "compiled into the artifact)"
            )
        images = np.asarray(images, np.uint8)
        n, h, w = images.shape[:3]
        if valid_hw is None:
            valid_hw = np.tile(np.asarray([[h, w]], np.int32), (n, 1))
        valid_hw = np.asarray(valid_hw, np.int32)
        nb = 1 << (max(1, n) - 1).bit_length()
        if nb > n:
            images = np.concatenate(
                [images, np.repeat(images[-1:], nb - n, axis=0)]
            )
            valid_hw = np.concatenate(
                [valid_hw, np.repeat(valid_hw[-1:], nb - n, axis=0)]
            )
        run = self._call((nb, h, w))
        host = [torch.from_numpy(np.ascontiguousarray(images)),
                torch.from_numpy(np.ascontiguousarray(valid_hw))]
        if self.device.type == "cuda":
            host = [t.pin_memory() for t in host]
        x, vhw = (t.to(self.device, non_blocking=True) for t in host)
        with torch.no_grad():
            tables = run(self.params, x, vhw)
        return n, tables

    @staticmethod
    def _finish(n: int, tables: dict[str, torch.Tensor]) -> list[list[dict]]:
        # tables -> people through decode.to_people: the bundle path never
        # imports the model's code nor tpupose_torch.infer
        from tpupose_torch.decode.api import to_people

        host = {k: v.cpu().numpy() for k, v in tables.items()}
        return [to_people({k: v[i] for k, v in host.items()}) for i in range(n)]

    def process_batch(self, images: np.ndarray,
                      scales: tuple[float, ...] | None = None,
                      valid_hw: np.ndarray | None = None) -> list[list[dict]]:
        """Batched inference through the exported program for this
        (batch, canvas) — same contract as ``PoseEstimator.process_batch``
        with the bundle caveats of ``process_batch_async``."""
        return self._finish(*self.process_batch_async(
            images, scales=scales, valid_hw=valid_hw
        ))

    def process(self, image: np.ndarray, draw: bool = False) -> dict:
        """Single-image convenience: routes through the bundle's bucket
        ladder (batch-1 program), mapping keypoints back to the input
        frame — what the HTTP server does per request."""
        from tpupose_torch import buckets as _bk

        image = np.asarray(image, np.uint8)
        bh, bw, s = _bk.choose_bucket(
            image.shape[0], image.shape[1], self.buckets
        )
        canvas, vh, vw = _bk.to_bucket(image, bh, bw, s)
        people = self.process_batch(
            canvas[None], valid_hw=np.asarray([[vh, vw]], np.int32)
        )[0]
        if s != 1.0:
            people = _bk.unscale_people(people, s)
        out = {"people": people}
        if draw:
            from tpupose_torch.utils.drawing import draw_people

            out["canvas"] = draw_people(image, people)
        return out


def load_bundle(path: str, device: str | torch.device = "cuda") -> DeployedEstimator:
    """Read a ``.tppx`` bundle back into a servable estimator on ``device``.

    Verifies every member's sha256 against the manifest (a truncated or
    bit-flipped artifact fails loudly, not with wrong poses), refuses
    another format (the reference's ``tppx-v1`` among them) and a bundle
    exported for another device type, and deserializes each program with
    ``torch.export.load``; where that fails under another torch than the
    exporting one, the error names both versions. ``device`` without an
    index is the current CUDA device; a program exported on another index
    of its type (``cuda:0`` for a bundle whose manifest names no
    ``"device"``) is moved onto ``device`` by
    ``torch.export.passes.move_to_device_pass`` (``retarget``), never
    refused. Like the live estimator, turns TF32 off for cuDNN
    convolutions and CUDA matmuls.
    """
    import tpupose_torch.ops  # noqa: F401  (the programs' operators, resolved by name)
    from torch.export.passes import move_to_device_pass

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_bundle(device='cuda'): no CUDA device is available")
    device = _indexed(device)
    with zipfile.ZipFile(path) as zf:
        manifest = json.loads(zf.read(_MANIFEST))
        if manifest.get("format") != FORMAT:
            raise ValueError(
                f"{path}: unsupported bundle format "
                f"{manifest.get('format')!r} (expected {FORMAT})"
            )
        try:
            moves = retarget(manifest, device)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
        wbytes = zf.read(_WEIGHTS)
        if hashlib.sha256(wbytes).hexdigest() != manifest["weights_sha256"]:
            raise ValueError(f"{path}: weights corrupted (sha256 mismatch)")
        with np.load(io.BytesIO(wbytes)) as npz:
            params = device_params({k: npz[k] for k in npz.files}, device)
        programs = {}
        for p in manifest["programs"]:
            blob = zf.read(p["file"])
            if hashlib.sha256(blob).hexdigest() != p["sha256"]:
                raise ValueError(
                    f"{path}: program {p['file']} corrupted (sha256 mismatch)"
                )
            try:
                ep = torch.export.load(io.BytesIO(blob))
            except Exception as e:
                exported = manifest.get("torch_version")
                if exported != torch.__version__:
                    raise RuntimeError(
                        f"{path}: program {p['file']} was exported with torch {exported} "
                        f"and does not load with torch {torch.__version__}: {e}"
                    ) from e
                raise
            programs[(p["n"], p["h"], p["w"])] = move_to_device_pass(ep, moves) if moves else ep
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return DeployedEstimator(manifest, params, programs, device)
