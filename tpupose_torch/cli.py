"""Command-line entry points of the port.

Counterpart of ``tpupose/cli.py`` for the commands whose modules the port
holds:

  demo-image       single image -> people JSON + overlay
  demo-video       frame loop (video file / camera), optional tracking
  convert-weights  reference weights (.h5 / .caffemodel / .pth) -> the
                   port's checkpoint (``training/checkpoint.py``, .npz)
  export-weights   the port's checkpoint -> reference-format Keras .h5

Every command runs on the card (``--device cuda``, the default) unless
``--device cpu`` is given. Reading images and video needs cv2, imported
where a command reads them.

Usage: python -m tpupose_torch.cli <command> [options]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _add_common_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--weights", default=None,
                   help="reference weights: Keras .h5, Caffe .caffemodel, "
                        "or torch .pth/.pt (optional)")
    p.add_argument(
        "--checkpoint", default=None, metavar="DIR",
        help="the port's checkpoint directory (from convert-weights or the "
             "trainer); takes precedence over --weights",
    )
    p.add_argument("--config", default=None, metavar="INI",
                   help="reference-format INI config file (the upstream "
                        "`config`: scale_search, thre1/thre2, boxsize, "
                        "stride, padValue, ...); explicit flags below "
                        "override it")
    p.add_argument("--scales", default=None,
                   help="comma-separated pyramid scales, e.g. 0.5,1,1.5,2")
    p.add_argument("--boxsize", type=int, default=None,
                   help="override canonical input size (default 368)")
    p.add_argument("--stages", type=int, default=None,
                   help="override number of refinement stages (default 6)")
    p.add_argument(
        "--decode-groups", type=int, default=None,
        help="accepted for configurations shared with the JAX package; the "
             "port's decode has no groups and reads it nowhere",
    )
    p.add_argument(
        "--max-peaks", type=int, default=None,
        help="decode capacity: candidate peaks per part channel "
             "(default 96). Raise for uniformly dense crowds (e.g. 128); "
             "scenes past the capacity keep only the strongest peaks",
    )
    p.add_argument("--device", default="cuda",
                   help="where the estimator runs: cuda (default) or cpu")


def _config(args):
    import dataclasses

    from tpupose_torch.config import DEFAULT, with_scales

    cfg = DEFAULT
    if getattr(args, "config", None):
        from tpupose_torch.config_io import read_reference_config

        try:
            res = read_reference_config(args.config, base=cfg)
        except FileNotFoundError:
            print(f"error: cannot read {args.config}", file=sys.stderr)
            raise SystemExit(2)
        except Exception as e:  # malformed INI -> clean error, not traceback
            print(f"error: cannot parse {args.config}: {e}", file=sys.stderr)
            raise SystemExit(2)
        cfg = res.config
        # the reference config names its own weights (caffemodel=...), relative
        # to its own repository root: resolve a relative hint against the
        # config file's directory, not the working directory
        hint = res.weights_hint
        if hint and not os.path.isabs(hint):
            hint = os.path.normpath(os.path.join(
                os.path.dirname(os.path.abspath(args.config)), hint))
        args._config_weights_hint = hint
    if getattr(args, "scales", None):
        cfg = with_scales(tuple(float(s) for s in args.scales.split(",")), cfg)
    if getattr(args, "boxsize", None):
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, boxsize=args.boxsize))
    if getattr(args, "stages", None):
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, num_stages=args.stages))
    if getattr(args, "decode_groups", None):
        cfg = dataclasses.replace(
            cfg, inference=dataclasses.replace(
                cfg.inference, decode_groups=args.decode_groups))
    if getattr(args, "max_peaks", None):
        mp = args.max_peaks
        inf = cfg.inference
        cfg = dataclasses.replace(
            cfg,
            inference=dataclasses.replace(
                inf, max_peaks=mp,
                # the ladders stay consistent with the new capacity, as in the
                # reference (the port reads neither)
                pair_tiers=tuple(sorted(
                    {t for t in (*inf.pair_tiers, 96) if t < mp})),
                peak_compact_tiers=tuple(
                    t for t in inf.peak_compact_tiers if t < mp),
            ),
        )
    return cfg


def _estimator(args, cfg=None):
    """PoseEstimator from the common model args: a checkpoint directory of
    the port (``--checkpoint``) wins over reference ``--weights``."""
    from tpupose_torch.infer import PoseEstimator

    cfg = cfg if cfg is not None else _config(args)
    device = getattr(args, "device", "cuda")
    ckpt_dir = getattr(args, "checkpoint", None)
    if ckpt_dir:
        from tpupose_torch.training.checkpoint import restore_params

        params = restore_params(ckpt_dir)
        if params is None:
            raise SystemExit(f"error: no checkpoint found in {ckpt_dir}")
        return PoseEstimator(cfg, params=params, device=device)
    weights = getattr(args, "weights", None)
    if weights is None:
        # --config pointed at a reference file whose [models] section names
        # its own caffemodel: use it when the file exists
        hint = getattr(args, "_config_weights_hint", None)
        if hint:
            if os.path.exists(hint):
                print(f"using weights from reference config: {hint}",
                      file=sys.stderr)
                weights = hint
            else:
                print(f"warning: reference config names weights at {hint} "
                      "but the file does not exist; continuing without",
                      file=sys.stderr)
    return PoseEstimator(cfg, weights_path=weights, device=device)


def cmd_demo_image(args) -> int:
    import cv2
    import numpy as np

    est = _estimator(args)
    if not est.pretrained:
        print("warning: no pretrained weights loaded; output is untrained",
              file=sys.stderr)
    image = cv2.imread(args.image)
    if image is None:
        print(f"error: cannot read {args.image}", file=sys.stderr)
        return 2
    out = est.process(np.asarray(image), draw=True)
    print(json.dumps(out["people"], indent=2))
    if getattr(args, "json_out", None):
        with open(args.json_out, "w") as f:
            json.dump(out["people"], f, indent=2)
        print(f"keypoints written to {args.json_out}", file=sys.stderr)
    if args.output:
        cv2.imwrite(args.output, out["canvas"])
        print(f"overlay written to {args.output}", file=sys.stderr)
    return 0


def cmd_demo_video(args) -> int:
    import collections
    import time

    import cv2
    import numpy as np

    from tpupose_torch.config import single_scale
    from tpupose_torch.decode.api import to_people
    from tpupose_torch.utils.drawing import draw_people

    est = _estimator(args, single_scale(_config(args)))
    tracker = None
    if getattr(args, "track", False):
        from tpupose_torch.tracking import PoseTracker

        tracker = PoseTracker(smoothing=args.smooth)
    cap = cv2.VideoCapture(int(args.input) if args.input.isdigit() else args.input)
    if not cap.isOpened():
        print(f"error: cannot open {args.input}", file=sys.stderr)
        return 2

    def frames():
        n = 0
        while True:
            ok, frame = cap.read()
            if not ok or (args.max_frames and n >= args.max_frames):
                return
            yield np.asarray(frame, np.uint8)
            n += 1

    writer = None
    n = 0

    def drain_one(pending):
        nonlocal writer, n
        frame0, tables = pending.popleft()
        people = to_people({k: v.cpu().numpy() for k, v in tables.items()})
        if tracker is not None:
            people = tracker.update(people)
        canvas = draw_people(frame0, people)
        if tracker is not None:
            for p in people:   # stable id label at the person's top joint
                if not p["keypoints"]:
                    continue
                top = min(p["keypoints"].values(), key=lambda kp: kp["y"])
                cv2.putText(
                    canvas, f"#{p['track_id']}",
                    (int(top["x"]), max(12, int(top["y"]) - 6)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1,
                    cv2.LINE_AA,
                )
        if args.output:
            if writer is None:
                writer = cv2.VideoWriter(
                    args.output, cv2.VideoWriter_fourcc(*"mp4v"),
                    cap.get(cv2.CAP_PROP_FPS) or 25.0,
                    (canvas.shape[1], canvas.shape[0]),
                )
            writer.write(canvas)
        n += 1

    # pipelined: several frames in flight, so uploads overlap compute
    pending: collections.deque = collections.deque()
    t0 = time.time()
    for frame in frames():
        pending.append((frame, est.process_async(frame)))
        while len(pending) > 3:
            drain_one(pending)
    while pending:
        drain_one(pending)
    if writer is not None:
        writer.release()
    cap.release()
    dt = time.time() - t0
    print(f"{n} frames in {dt:.1f}s ({n / max(dt, 1e-9):.1f} fps)", file=sys.stderr)
    return 0


def cmd_convert_weights(args) -> int:
    """Reference weights (.h5 / .caffemodel / .pth) -> the port's checkpoint."""
    import torch

    from tpupose_torch.models import OpenPose, weights as weights_lib
    from tpupose_torch.models.openpose import DTYPES
    from tpupose_torch.training import checkpoint as ckpt_lib

    cfg = _config(args)
    model = OpenPose(num_stages=cfg.model.num_stages, dtype=DTYPES[cfg.model.compute_dtype])
    model.reset_parameters(torch.Generator().manual_seed(0))
    params, missing = weights_lib.load_reference_weights(
        args.weights, weights_lib.to_flax(model.state_dict()))
    if missing:
        print(f"warning: {len(missing)} layers missing from {args.weights}: {missing[:3]}...",
              file=sys.stderr)
    ckpt_lib.save(args.output, {"params": weights_lib.from_flax(params),
                                "opt_state": {"count": 0, "mini_step": 0}, "step": 0})
    print(f"converted {args.weights} -> {args.output}")
    return 0


def cmd_export_weights(args) -> int:
    """The port's checkpoint -> reference-format Keras .h5 (the reverse of
    convert-weights; Keras ``load_weights(by_name=True)`` reads the file)."""
    from tpupose_torch.models import weights as weights_lib
    from tpupose_torch.training import checkpoint as ckpt_lib

    params = ckpt_lib.restore_params(args.checkpoint)
    if params is None:
        print(f"no checkpoint found under {args.checkpoint}", file=sys.stderr)
        return 1
    names = weights_lib.save_keras_h5(args.output, params)
    print(f"exported {len(names)} layers: {args.checkpoint} -> {args.output}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="tpupose-torch", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("demo-image", help="single-image inference")
    p.add_argument("--image", required=True)
    p.add_argument("--output", default=None, help="overlay image path")
    p.add_argument("--json", default=None, dest="json_out",
                   help="write the keypoint JSON to this path (always "
                        "also printed to stdout)")
    _add_common_model_args(p)
    p.set_defaults(fn=cmd_demo_image)

    p = sub.add_parser("demo-video", help="video/camera realtime loop")
    p.add_argument("--input", required=True, help="video path or camera index")
    p.add_argument("--output", default=None, help="output video path")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--track", action="store_true",
                   help="assign stable person ids across frames "
                        "(tpupose_torch.tracking.PoseTracker)")
    p.add_argument("--smooth", type=float, default=0.0,
                   help="keypoint EMA factor in [0,1) with --track")
    _add_common_model_args(p)
    p.set_defaults(fn=cmd_demo_video)

    p = sub.add_parser("convert-weights",
                       help="reference weights -> the port's checkpoint")
    p.add_argument("--weights", required=True,
                   help="Keras .h5, Caffe .caffemodel, or torch .pth/.pt")
    p.add_argument("--output", required=True, help="checkpoint directory to write")
    p.add_argument("--scales", default=None)
    p.add_argument("--boxsize", type=int, default=None)
    p.add_argument("--stages", type=int, default=None)
    p.set_defaults(fn=cmd_convert_weights)

    p = sub.add_parser("export-weights",
                       help="the port's checkpoint -> Keras .h5")
    p.add_argument("--checkpoint", required=True, help="checkpoint directory")
    p.add_argument("--output", required=True, help=".h5 path to write")
    p.set_defaults(fn=cmd_export_weights)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
