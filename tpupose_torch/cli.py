"""Command-line entry points of the port.

Counterpart of ``tpupose/cli.py`` for the commands whose modules the port
holds:

  demo-image       single image -> people JSON + overlay
  demo-video       frame loop (video file / camera), optional tracking
  prepare          COCO keypoint annotations + images -> packed dataset
                   (``.tpr``, or HDF5 where h5py is installed)
  train            training from a packed dataset (or 'synthetic')
  finetune         the same with the VGG base frozen
  eval             OKS keypoint AP over a packed dataset or a COCO
                   annotation file
  convert-weights  reference weights (.h5 / .caffemodel / .pth) -> the
                   port's checkpoint (``training/checkpoint.py``, .npz)
  export-weights   the port's checkpoint -> reference-format Keras .h5
  export-program   the serving programs + weights -> one .tppx bundle
                   (``deploy.py``; ``serve --program`` loads it)
  bench            the headline benchmark (``benchmark.py``): one JSON line

Every command that runs a model runs it on the card (``--device cuda``,
the default) unless ``--device cpu`` is given. Reading images and video
needs cv2, imported where a command reads them.

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


def _dp_devices(args) -> list:
    """The devices ``--dp`` counts: every visible CUDA device, or the CPU
    with ``--device cpu``."""
    from tpupose_torch.parallel.sharding import local_devices

    return local_devices(getattr(args, "device", "cuda"))


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


def cmd_prepare(args) -> int:
    from tpupose_torch.data import coco_prep

    n = coco_prep.pack(args.annotations, args.images, args.output)
    print(f"packed {n} records -> {args.output}")
    return 0


def _init_params(cfg) -> dict:
    """The seeded default init (seed 0, as ``loop.train`` makes it) in the
    flax layout, for the weight loaders to overlay."""
    import torch

    from tpupose_torch.models import OpenPose, weights as weights_lib
    from tpupose_torch.models.openpose import DTYPES

    model = OpenPose(num_stages=cfg.model.num_stages, dtype=DTYPES[cfg.model.compute_dtype])
    model.reset_parameters(torch.Generator().manual_seed(0))
    return weights_lib.to_flax(model.state_dict())


def _run_training(args, frozen_vgg: bool) -> int:
    import dataclasses

    from tpupose_torch.data import pipeline
    from tpupose_torch.models import weights as weights_lib
    from tpupose_torch.training import loop

    cfg = _config(args)
    train_cfg = cfg.train
    if args.batch_size:
        train_cfg = dataclasses.replace(train_cfg, batch_size=args.batch_size)
    if frozen_vgg:
        train_cfg = train_cfg.frozen_vgg()
    cfg = dataclasses.replace(cfg, train=train_cfg)

    params = None  # flax layout until handed to the loop
    if getattr(args, "checkpoint", None):
        # initial params from one of the port's checkpoints (the promised
        # precedence over --weights); the workdir's own checkpoints
        # still win for resume inside loop.train
        from tpupose_torch.training.checkpoint import restore_params

        params = restore_params(args.checkpoint)
        if params is None:
            print(f"error: no checkpoint found in {args.checkpoint}",
                  file=sys.stderr)
            return 2
    elif args.weights:
        params, loaded = weights_lib.maybe_load_pretrained(_init_params(cfg), args.weights)
        if not loaded:
            print(f"warning: weights file {args.weights} not found", file=sys.stderr)

    if getattr(args, "vgg19_npz", None):
        # the reference's from_vgg init: ImageNet VGG19 convs overlaid on
        # the (possibly fresh) param tree before training starts
        if params is not None:
            # the reference's from_vgg path only applies to a fresh init;
            # overlaying ImageNet convs on restored weights degrades them
            print(
                "warning: --vgg19-npz overlays ImageNet convs ON TOP of the "
                "restored --checkpoint/--weights VGG base (the reference's "
                "from_vgg only ever applies to a fresh init); drop the flag "
                "to keep the trained convs",
                file=sys.stderr,
            )
        else:
            params = _init_params(cfg)
        params, ok = weights_lib.load_vgg19_imagenet_npz(args.vgg19_npz, params)
        if not ok:
            print(f"warning: VGG19 npz {args.vgg19_npz} had no effect "
                  "(missing file or no matching arrays)", file=sys.stderr)

    # under torchrun (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK set) every
    # process joins one group and the loop trains data-parallel over it
    from tpupose_torch.parallel.distributed import init_multihost

    init_multihost()
    # shard=None: every process reads the same stream and feeds the loop
    # the same global batch, of which each rank keeps its rows
    # (training/loop.py); the JAX package shards the records instead
    # (shard="auto") because it places one global batch over its mesh
    if args.dataset == "synthetic":
        batches = pipeline.synthetic_batches(cfg, n_batches=args.max_steps or 10)
    elif getattr(args, "grain", False):
        # the checkpointable feed over an HDF5 file: the data position
        # rides every checkpoint, so preempted runs resume mid-epoch
        from tpupose_torch.data.grain_pipeline import hdf5_grain_batches

        batches = hdf5_grain_batches(args.dataset, cfg, shard=None,
                                     worker_count=getattr(args, "data_workers", 0))
    else:
        # .tpr datasets take the native threaded-inflate path; pre-padded
        # ones (data/pack_tpr.py --pre-pad) skip host-side prep entirely,
        # and their position rides every checkpoint.
        batches = pipeline.dataset_batches(args.dataset, cfg, shard=None)

    val_batches = None
    if getattr(args, "val_dataset", None):
        # the reference's fit_generator validation_data: a fresh pass
        # over the held-out set each time the loop validates (epochs=1,
        # unshuffled)
        if args.val_dataset == "synthetic":
            def val_batches():
                return pipeline.synthetic_batches(cfg, seed=997, n_batches=2)
        else:
            def val_batches():
                return pipeline.dataset_batches(
                    args.val_dataset, cfg, epochs=1, shuffle_seed=None, shard=None,
                )

    try:
        result = loop.train(
            cfg, batches,
            params=None if params is None else weights_lib.from_flax(params),
            workdir=args.workdir,
            max_steps=args.max_steps,
            val_batches=val_batches,
            val_every=getattr(args, "val_every", None),
            device=args.device,
        )
    finally:
        if hasattr(batches, "close"):
            batches.close()
    print(
        json.dumps(
            {
                "steps": result["steps"],
                "steps_per_sec": round(result["steps_per_sec"], 3),
                "last_losses": {k: round(v, 4) for k, v in result["last_losses"].items()},
            }
        )
    )
    return 0


def cmd_train(args) -> int:
    return _run_training(args, frozen_vgg=False)


def cmd_finetune(args) -> int:
    return _run_training(args, frozen_vgg=True)


def _ignore_region_gt(regions):
    """[x, y, w, h, area] rows -> coco_eval match-to-ignore GT dicts.

    Detections falling on these regions match-to-ignore instead of
    counting as false positives (data/coco_eval.py crowd semantics,
    SURVEY §4 eval contract)."""
    import numpy as np

    out = []
    for reg in regions:
        x, y, w, h, area = (float(v) for v in reg)
        out.append({
            "keypoints": np.full((18, 3), 2.0),  # all absent
            "area": area if area > 0 else w * h,
            "iscrowd": 1,
            "num_keypoints": 0,
            "bbox": [x, y, w, h],
        })
    return out


def _eval_inputs(args):
    """Yields (image, gt_list, image_id) from either eval source:
    a packed dataset (--dataset; per-main-person records) or a COCO
    annotation file + image dir (--annotations/--images; one record per
    image, the reference-user workflow — no packing step)."""
    if getattr(args, "annotations", None):
        from tpupose_torch.data.coco_prep import iter_eval_images

        for rec in iter_eval_images(args.annotations, args.images):
            gt = list(rec["gt"]) + _ignore_region_gt(rec["ignore_regions"])
            yield rec["image"], gt, rec["image_id"]
        return
    import tpupose_torch.data as data_pkg

    for rec in data_pkg.read_samples(args.dataset):
        # real GT areas ride the records (bbox-estimated by the reader
        # for older files without them) — OKS is exponential in area
        gt = [
            {"keypoints": j, "area": float(a)}
            for j, a in zip(rec["joints"], rec["areas"])
            if (j[:, 2] < 2).any()
        ]
        gt += _ignore_region_gt(rec.get("ignore_regions", ()))
        yield rec["image"], gt, rec.get("image_id")


def cmd_eval(args) -> int:
    from tpupose_torch.data import coco_eval

    if getattr(args, "annotations", None) and getattr(args, "dataset", None):
        print("error: --dataset and --annotations are mutually exclusive",
              file=sys.stderr)
        return 2
    if not getattr(args, "annotations", None) and not getattr(
        args, "dataset", None
    ):
        print("error: one of --dataset or --annotations is required",
              file=sys.stderr)
        return 2
    if getattr(args, "annotations", None) and not getattr(args, "images",
                                                          None):
        print("error: --annotations requires --images <dir>",
              file=sys.stderr)
        return 2
    dp = getattr(args, "dp", None)
    if dp:  # validate before paying for the model build
        from tpupose_torch.parallel.inference import resolve_dp

        if not getattr(args, "buckets", None):
            print("error: --dp requires --buckets (per-image eval never "
                  "builds device batches to shard)", file=sys.stderr)
            return 2
        try:
            resolve_dp(dp, _dp_devices(args))
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    est = _estimator(args)
    if dp:
        from tpupose_torch.parallel.inference import wrap_dp

        est, n_dp = wrap_dp(est, dp, _dp_devices(args))
        if n_dp > 1:
            print(f"data-parallel eval over {n_dp} devices",
                  file=sys.stderr)
    runner = None
    if getattr(args, "buckets", None):
        from tpupose_torch.buckets import BucketedRunner, resolve_buckets

        runner = BucketedRunner(
            est, resolve_buckets(args.buckets), batch_size=args.eval_batch
        )
    preds, gts, image_ids = [], [], []
    for i, (image, gt, image_id) in enumerate(_eval_inputs(args)):
        if args.max_images and i >= args.max_images:
            break
        if runner is not None:
            runner.add(image)
        else:
            preds.append(est.process(image)["people"])
        gts.append(gt)
        image_ids.append(image_id)
    if runner is not None:
        preds = runner.finish()
    if getattr(args, "coco_results", None):
        # pycocotools-format keypoint results: detections from this
        # framework drop into any COCO-results tooling / COCOeval run.
        # Datasets written by prepare carry the original COCO image id per
        # record, so the export aligns with the real annotation file;
        # records are per main person, so repeats of the same image
        # (identical detections) are deduplicated. Older files without ids
        # fall back to the record index — only self-consistent GT applies.
        from tpupose_torch.data.coco_prep import people_to_coco_results

        records, seen = [], set()
        have_ids = all(v is not None for v in image_ids)
        if not have_ids:
            print("warning: dataset records carry no COCO image_id; "
                  "exporting sequential ids (usable only against GT "
                  "indexed the same way, not the original COCO "
                  "annotation file)", file=sys.stderr)
        for i, people in enumerate(preds):
            img_id = image_ids[i] if have_ids else i
            if img_id in seen:
                continue
            seen.add(img_id)
            records.extend(people_to_coco_results(people, image_id=img_id))
        with open(args.coco_results, "w") as f:
            json.dump(records, f)
        print(f"COCO keypoint results written to {args.coco_results}",
              file=sys.stderr)
    res = coco_eval.evaluate(preds, gts)
    print(json.dumps(res))
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


def cmd_export_program(args) -> int:
    """Serving programs + weights -> one .tppx deployment bundle: every
    (bucket x power-of-two batch) program, traced with ``torch.export``
    on ``--device``, for a serving host that runs them without the
    model's code."""
    from tpupose_torch.buckets import resolve_buckets
    from tpupose_torch.deploy import save_bundle

    bks = resolve_buckets(args.buckets)
    if not bks:
        print("error: export-program requires a bucket ladder "
              "(--buckets default | 'HxW,...')", file=sys.stderr)
        return 2
    est = _estimator(args)
    manifest = save_bundle(args.output, est, bks, max_batch=args.max_batch,
                           log=lambda m: print(m, file=sys.stderr))
    print(f"wrote {args.output}: {len(manifest['programs'])} programs, "
          f"scales={tuple(manifest['scales'])}, "
          f"pretrained={manifest['pretrained']}")
    return 0


def cmd_bench(args) -> int:
    from tpupose_torch import benchmark

    benchmark.main(baseline_cache=args.baseline_cache, device=args.device)
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

    p = sub.add_parser("prepare", help="COCO annotations -> packed .tpr / HDF5")
    p.add_argument("--annotations", required=True)
    p.add_argument("--images", required=True)
    p.add_argument("--output", required=True,
                   help=".tpr (the native record container) or .h5 (needs h5py)")
    p.set_defaults(fn=cmd_prepare)

    for name, fn in (("train", cmd_train), ("finetune", cmd_finetune)):
        p = sub.add_parser(name, help=f"{name} (finetune = frozen VGG)")
        p.add_argument("--dataset", required=True,
                       help="packed .tpr / HDF5 path, or 'synthetic'")
        p.add_argument("--workdir", default=f"runs/{name}")
        p.add_argument("--max-steps", type=int, default=None)
        p.add_argument("--batch-size", type=int, default=None)
        p.add_argument("--val-dataset", default=None, metavar="PATH",
                       help="held-out packed dataset (or 'synthetic'): "
                            "per-head eval losses every --val-every steps "
                            "to workdir/validation.csv + TensorBoard (the "
                            "reference's fit_generator validation_data)")
        p.add_argument("--val-every", type=int, default=None,
                       help="steps between validation passes (default: "
                            "the checkpoint interval)")
        p.add_argument("--grain", action="store_true",
                       help="the checkpointable feed over an HDF5 dataset "
                            "(data/grain_pipeline.py): exact mid-epoch resume "
                            "after preemption")
        p.add_argument("--data-workers", type=int, default=0,
                       help="record-preparing processes of --grain (0 = in-process)")
        p.add_argument("--vgg19-npz", default=None, metavar="NPZ",
                       help="overlay VGG19 ImageNet conv weights from an "
                            ".npz onto the init (the reference's from_vgg "
                            "fine-tune initialisation); applied AFTER any "
                            "--checkpoint/--weights restore, overwriting "
                            "the restored VGG convs — meant for fresh inits")
        _add_common_model_args(p)
        p.set_defaults(fn=fn)

    p = sub.add_parser(
        "eval",
        help="OKS keypoint AP over a packed dataset or a COCO "
             "annotation file",
    )
    p.add_argument("--dataset", default=None,
                   help="packed .tpr/.h5 dataset (per-main-person records)")
    p.add_argument("--annotations", default=None, metavar="JSON",
                   help="evaluate straight from a COCO keypoint annotation "
                        "file (one pass per image, crowd/ignore GT "
                        "included) — no packing step; requires --images")
    p.add_argument("--images", default=None, metavar="DIR",
                   help="image directory for --annotations")
    p.add_argument("--max-images", type=int, default=0)
    p.add_argument(
        "--buckets", default=None,
        help="'default' or 'HxW,...' — batch mixed-size images through "
             "the canvas ladder instead of one image at a time",
    )
    p.add_argument("--eval-batch", type=int, default=8,
                   help="batch size per bucket with --buckets")
    p.add_argument("--dp", default=None, metavar="N|auto",
                   help="split each bucketed device batch over N devices "
                        "(requires --buckets; pair with --eval-batch >= N)")
    p.add_argument("--coco-results", default=None, metavar="JSON",
                   help="also write detections as pycocotools keypoint "
                        "results (17-kp COCO order; loadRes-compatible "
                        "against the original annotation file when the "
                        "dataset carries COCO image ids — files written by "
                        "prepare do; older files export sequential ids)")
    _add_common_model_args(p)
    p.set_defaults(fn=cmd_eval)

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

    p = sub.add_parser(
        "export-program",
        help="serialize the serving programs + weights into a .tppx "
             "deployment bundle (torch.export; serve --program loads it "
             "without the model's code)",
    )
    p.add_argument("--output", required=True, help=".tppx path to write")
    p.add_argument("--buckets", default="default",
                   help="bucket ladder to export: 'default' or "
                        "'368x368,368x496,...' (one program per "
                        "bucket x power-of-two batch)")
    p.add_argument("--max-batch", type=int, default=8,
                   help="largest device batch to export (powers of two "
                        "up to this are included)")
    _add_common_model_args(p)
    p.set_defaults(fn=cmd_export_program)

    p = sub.add_parser("bench", help="headline throughput benchmark")
    p.add_argument("--device", default="cuda",
                   help="where the benchmark runs: cuda (default) or cpu")
    p.add_argument("--baseline-cache", default=None, metavar="JSON",
                   help="the CPU baseline's cache (default: "
                        "tpupose_torch/_build/bench_baseline.json; measured "
                        "there when missing)")
    p.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
