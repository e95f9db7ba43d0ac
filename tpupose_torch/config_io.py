"""Reference INI config compatibility (``config_reader()`` parity).

The port's own copy of ``tpupose/config_io.py``, over the port's
``config`` and ``topology`` (``tests/test_torch_imports.py`` holds the two
to the same results on the same files). The original release ships a
configobj-format ``config`` file that its ``config_reader.py`` parses into
(param, model_params) dicts. Users migrating from it point this loader at
that same file; its values overlay the port's defaults.

Every key the original documents is handled here, one of two ways:

Wired ([param]): ``scale_search`` -> ``InferenceConfig.scale_search``,
``thre1``/``thre2`` -> peak / PAF thresholds, ``mid_num`` -> line-integral
samples, ``min_num`` -> ``min_subset_cnt`` (the skeleton part-count cull).
Wired ([models] / [[1]]): ``boxsize``, ``stride``, ``padValue`` onto
``ModelConfig``; ``part_str`` is validated against the built-in COCO-18
topology (a mismatch warns — the topology is not reconfigurable);
``caffemodel`` is surfaced as ``weights_hint`` so the CLI can ingest the
referenced weights when no ``--weights`` is given.

Explicitly rejected (each produces a :class:`ReferenceConfigWarning`
naming the key, so a migrating user's edit is never silently dropped):
``use_gpu``/``GPUdeviceNumber`` (the device is the estimator's ``device``
argument), ``modelID`` (one model family; the model section's geometry
still applies), ``octave``/``starting_range``/``ending_range`` (consumed
only by the upstream Matlab click-mode scale search — the Python demo
path, and therefore this port, takes the pyramid from ``scale_search``),
``thre3`` (upstream single-person/Matlab threshold, unused by the
multi-person Python decode), ``crop_ratio``/``bbox_ratio`` (Matlab-path
crop parameters), ``deployFile`` (the architecture is built-in), ``np``
(part count is fixed by the topology), ``description`` (informational).
Unknown keys warn as unrecognised.

Format notes: the upstream file is configobj, not strict INI — nested
``[[1]]`` model subsections, duplicate options (``GPUdeviceNumber``
appears twice in the stock file), inline ``#`` comments, and quoted
scalars (``modelID = '1'``) all occur in the wild. The parser accepts all
of them: section names are normalised by stripping brackets (so
configparser's literal ``[1]`` section name for a ``[[1]]`` header
matches), options parse in non-strict last-wins mode, and values are
unquoted before conversion.
"""

from __future__ import annotations

import ast
import configparser
import dataclasses
import warnings

from tpupose_torch.config import PoseConfig


class ReferenceConfigWarning(UserWarning):
    """A reference-config key was present but has no effect in the port."""


# key (configparser-lowercased) -> why it is not wired
_PARAM_REJECTED: dict[str, str] = {
    "use_gpu": "the device is the estimator's device argument",
    "gpudevicenumber": "the device is the estimator's device argument",
    "modelid": "the port builds the one COCO-18 model family "
               "(the model section's geometry keys still apply)",
    "octave": "only the upstream Matlab click-mode scale search reads it; "
              "the wired pyramid contract is scale_search",
    "starting_range": "only the upstream Matlab click-mode scale search reads it",
    "ending_range": "only the upstream Matlab click-mode scale search reads it",
    "thre3": "upstream single-person/Matlab threshold; the multi-person "
             "Python decode never reads it",
    "crop_ratio": "Matlab-path crop parameter; the Python demo path never reads it",
    "bbox_ratio": "Matlab-path crop parameter; the Python demo path never reads it",
}
_PARAM_WIRED = ("scale_search", "thre1", "thre2", "mid_num", "min_num")

_MODEL_REJECTED: dict[str, str] = {
    "deployfile": "the network architecture is built-in (tpupose_torch/models/openpose.py)",
    "np": "part count is fixed by the COCO-18 topology",
    "description": "informational only",
}
_MODEL_WIRED = ("boxsize", "stride", "padvalue", "part_str", "caffemodel")


@dataclasses.dataclass(frozen=True)
class ReferenceConfigResult:
    """Everything extracted from a reference config file."""

    config: PoseConfig
    # [models] caffemodel path, if present — the reference's pointer at its
    # own weights; the CLI uses it as the default --weights.
    weights_hint: str | None
    # key -> reason for every documented-but-unwired or unknown key seen
    # (already emitted as a ReferenceConfigWarning by read time).
    ignored: dict[str, str]


def _unquote(raw: str) -> str:
    raw = raw.strip()
    if len(raw) >= 2 and raw[0] == raw[-1] and raw[0] in ("'", '"'):
        return raw[1:-1]
    return raw


def _parse_scale_search(raw: str) -> tuple[float, ...]:
    raw = _unquote(raw)
    if raw.startswith("["):
        return tuple(float(x) for x in ast.literal_eval(raw))
    return tuple(float(x) for x in raw.split(","))


def _parse_part_str(raw: str) -> tuple[str, ...]:
    raw = _unquote(raw).strip()
    if raw.startswith("[") and raw.endswith("]"):
        raw = raw[1:-1]
    return tuple(_unquote(p.strip()) for p in raw.split(",") if p.strip())


def _norm_section(name: str) -> str:
    """Normalise a section header: configobj ``[[1]]`` reaches configparser
    as the literal section name ``[1]`` — strip brackets and lowercase."""
    return name.strip().strip("[]").strip().lower()


def _is_model_section(name: str) -> bool:
    n = _norm_section(name)
    return n.startswith("model") or n.isdigit()


def read_reference_config(
    path: str, base: PoseConfig | None = None
) -> ReferenceConfigResult:
    """Parse a reference-format config file onto a PoseConfig.

    Returns the config plus the ``caffemodel`` weights hint and the map of
    keys that were present but rejected (each already warned about).
    """
    base = base or PoseConfig()
    # strict=False: the stock upstream file repeats GPUdeviceNumber;
    # inline `#` comments appear in the [models] block.
    cp = configparser.ConfigParser(
        strict=False, inline_comment_prefixes=("#", ";")
    )
    read = cp.read(path)
    if not read:
        raise FileNotFoundError(path)

    inf = base.inference
    mdl = base.model
    ignored: dict[str, str] = {}
    weights_hint: str | None = None

    for section in cp.sections():
        norm = _norm_section(section)
        if norm == "param":
            p = cp[section]
            if "scale_search" in p:
                inf = dataclasses.replace(
                    inf, scale_search=_parse_scale_search(p["scale_search"])
                )
            if "thre1" in p:
                inf = dataclasses.replace(inf, thre1=float(_unquote(p["thre1"])))
            if "thre2" in p:
                inf = dataclasses.replace(inf, thre2=float(_unquote(p["thre2"])))
            if "mid_num" in p:
                inf = dataclasses.replace(inf, mid_num=int(_unquote(p["mid_num"])))
            if "min_num" in p:
                # the original subset part-count cull (min_num = 4 in the stock file)
                inf = dataclasses.replace(
                    inf, min_subset_cnt=int(_unquote(p["min_num"]))
                )
            for key in p:
                if key in _PARAM_WIRED:
                    continue
                ignored[key] = _PARAM_REJECTED.get(key, "unrecognised key")
        elif norm == "models" or _is_model_section(norm):
            # the reference nests per-model sections under [models]; accept
            # the configobj [[1]] form (-> "[1]"), flat [model1], and keys
            # directly under [models]; last section wins per key.
            m = cp[section]
            if "boxsize" in m:
                mdl = dataclasses.replace(mdl, boxsize=int(_unquote(m["boxsize"])))
            if "stride" in m:
                mdl = dataclasses.replace(mdl, stride=int(_unquote(m["stride"])))
            if "padvalue" in m:
                mdl = dataclasses.replace(
                    mdl, pad_value=int(_unquote(m["padvalue"]))
                )
            if "caffemodel" in m:
                weights_hint = _unquote(m["caffemodel"])
            if "part_str" in m:
                from tpupose_torch.topology import PARTS

                parts = _parse_part_str(m["part_str"])
                # the stock file appends a 19th "pt19" background token
                trimmed = parts[: len(PARTS)]
                if tuple(trimmed) != PARTS:
                    ignored["part_str"] = (
                        "does not match the built-in COCO-18 topology "
                        f"({trimmed[:3]}... vs {PARTS[:3]}...); the part "
                        "layout is not reconfigurable"
                    )
            for key in m:
                if key in _MODEL_WIRED:
                    continue
                ignored[key] = _MODEL_REJECTED.get(key, "unrecognised key")
        else:
            ignored[f"[{section}]"] = "unrecognised section"

    if ignored:
        lines = ", ".join(f"{k} ({v})" for k, v in sorted(ignored.items()))
        warnings.warn(
            f"reference config keys with no effect in the port: {lines}",
            ReferenceConfigWarning,
            stacklevel=2,
        )

    return ReferenceConfigResult(
        config=dataclasses.replace(base, inference=inf, model=mdl),
        weights_hint=weights_hint,
        ignored=ignored,
    )


def load_reference_config(path: str, base: PoseConfig | None = None) -> PoseConfig:
    """Parse a reference-format INI file onto a PoseConfig."""
    return read_reference_config(path, base).config
