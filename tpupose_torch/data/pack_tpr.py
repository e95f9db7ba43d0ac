"""Pack a dataset into the native `.tpr` record format.

The port's counterpart of ``tools/pack_tpr.py``. Converts a packed-HDF5
dataset (this framework's writer OR the upstream packed-datum layout —
``data/hdf5.py``) or a `.tpr` file into the `.tpr` container that
``native/feed.cpp`` reads with mmap + threaded zlib inflate
(``data/tpr.py``).

`--pre-pad H W` additionally applies the train-time static-shape
padding (`hdf5.pad_sample`: fit-downscale + letterbox + person padding)
ONCE at pack time, so the training feed's hot loop is nothing but the
native batch decompress — no per-sample cv2 work, no Python-side
stacking (`pipeline.tpr_batches` fast path).

Usage:
  python -m tpupose_torch.data.pack_tpr --input ds.h5 --output ds.tpr
  python -m tpupose_torch.data.pack_tpr --input ds.tpr --output ds368.tpr \\
      --pre-pad 368 368 --max-persons 24 [--compression zlib|none]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def iter_input(path: str):
    from tpupose_torch.data import hdf5 as hdf5_io
    from tpupose_torch.data import tpr

    if path.endswith(".tpr"):
        return tpr.read_samples(path)
    return hdf5_io.read_samples(path)


def main(argv=None) -> int:
    from tpupose_torch.data import hdf5 as hdf5_io
    from tpupose_torch.data import tpr

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input", required=True, help=".h5 or .tpr dataset")
    ap.add_argument("--output", required=True, help=".tpr output path")
    ap.add_argument("--compression", default="zlib",
                    choices=["zlib", "none"],
                    help="record codec; 'none' reads at mmap speed")
    ap.add_argument("--level", type=int, default=1,
                    help="zlib level (1 = fast, reference-gzip-like ratio)")
    ap.add_argument("--pre-pad", type=int, nargs=2, metavar=("H", "W"),
                    default=None,
                    help="apply train-time static padding at pack time")
    ap.add_argument("--max-persons", type=int, default=8,
                    help="person-axis padding for --pre-pad")
    args = ap.parse_args(argv)

    def samples():
        for s in iter_input(args.input):
            if args.pre_pad is not None:
                s = hdf5_io.pad_sample(
                    s, args.pre_pad[0], args.pre_pad[1], args.max_persons
                )
                s["prepadded"] = True
            yield s

    # write_samples serialises the standard meta fields; the pre-padded
    # marker rides each record's meta so readers can pick the fast path
    n = 0
    with tpr.TprWriter(args.output, compression=args.compression,
                       level=args.level) as w:
        for s in samples():
            mask = np.asarray(s["mask"])
            if mask.dtype != np.uint8:
                mask = np.round(
                    np.asarray(mask, np.float32)
                    * (255.0 if mask.max() <= 1.0 else 1.0)
                ).astype(np.uint8)
            meta = tpr._meta_from_sample(s)
            if s.get("prepadded"):
                meta["prepadded"] = {"max_persons": args.max_persons}
            w.add(np.asarray(s["image"], np.uint8), mask, meta)
            n += 1

    with tpr.TprReader(args.output) as r:
        static = r.static_shapes
    print(f"wrote {n} records -> {args.output} "
          f"(static={static}, codec={args.compression}, "
          f"{os.path.getsize(args.output) / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
