"""Shape buckets: batched inference over arbitrary image sizes.

Counterpart of ``tpupose/buckets.py``. Images of different shapes cannot
share a batch, and every distinct (H, W) is its own set of kernel
geometries. A bucket ladder fixes the set of canvas geometries: each
image is aspect-preserving resized (downscale only) into the smallest
bucket that holds it, placed top-left, and the bottom/right margin is
padded with the reference's gray pad value — the same padRightDownCorner
convention the model already sees at every pyramid scale, just extended
to the canvas. The decode masks the margin out of peak finding
(``decode_impl_batch(valid_hw=...)``), and detected keypoints are mapped
back to original-image coordinates on the host.

Bucketing trades exact native-resolution processing for cross-image
batchability (images in the same bucket batch together even when their
native shapes differ); detections on a downscaled image are equivalent
to running the pipeline on the downscaled image.
"""

from __future__ import annotations

import numpy as np

# Ladder of (H, W) canvases. Heights/widths are multiples of the model
# stride (8) so the canvas itself never needs further padding at scale
# 1.0; the ladder covers portrait/landscape/square up to ~720p-ish with
# len(DEFAULT_BUCKETS) canvas geometries.
DEFAULT_BUCKETS: tuple[tuple[int, int], ...] = (
    (368, 368),
    (368, 496),
    (496, 368),
    (368, 656),
    (656, 368),
    (496, 656),
    (656, 496),
)


def parse_buckets(spec: str) -> tuple[tuple[int, int], ...]:
    """``"368x368,368x496"`` -> ((368, 368), (368, 496))."""
    out = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        parts = item.lower().split("x")
        if len(parts) != 2:
            raise ValueError(f"bad bucket {item!r}: expected HxW")
        out.append((int(parts[0]), int(parts[1])))
    if not out:
        raise ValueError("empty bucket spec")
    return tuple(out)


def resolve_buckets(spec: str | None) -> tuple[tuple[int, int], ...] | None:
    """A ``--buckets`` option value -> ladder (None / "default" / "HxW,...")."""
    if not spec:
        return None
    if spec == "default":
        return DEFAULT_BUCKETS
    return parse_buckets(spec)


def choose_bucket(
    h: int, w: int, buckets: tuple[tuple[int, int], ...]
) -> tuple[int, int, float]:
    """Pick the bucket minimising wasted canvas area; never upscale.

    Returns (bucket_h, bucket_w, scale) with scale = min(1, fit factor):
    the image content will occupy round(h*scale) x round(w*scale) of the
    canvas top-left. Among buckets with equal waste the smaller canvas
    wins (less compute).
    """
    best = None
    for bh, bw in buckets:
        s = min(1.0, bh / h, bw / w)
        vh, vw = max(1, round(h * s)), max(1, round(w * s))
        if s == 1.0:
            # fits natively: minimise wasted canvas, then canvas area
            key = (0, bh * bw - vh * vw, bh * bw)
        else:
            # must downscale: retain the most resolution, then the
            # smallest canvas that achieves it
            key = (1, -s, bh * bw)
        if best is None or key < best[0]:
            best = (key, (bh, bw, s))
    return best[1]


def _resize_host(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Half-pixel-centre bilinear (cv2.INTER_LINEAR semantics) on host.

    Uses cv2 when importable; the NumPy branch implements the same 2-tap
    kernel so users without cv2 get identical geometry.
    """
    try:
        import cv2

        return cv2.resize(
            image, (out_w, out_h), interpolation=cv2.INTER_LINEAR
        )
    except ImportError:
        pass
    h, w = image.shape[:2]
    ys = (np.arange(out_h) + 0.5) * (h / out_h) - 0.5
    xs = (np.arange(out_w) + 0.5) * (w / out_w) - 0.5
    y0 = np.clip(np.floor(ys), 0, h - 1).astype(np.int32)
    x0 = np.clip(np.floor(xs), 0, w - 1).astype(np.int32)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    img = image.astype(np.float32)
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    out = top * (1 - fy) + bot * fy
    if np.issubdtype(image.dtype, np.integer):
        out = np.round(out).clip(0, 255)
    return out.astype(image.dtype)


GRAY_PAD = 128  # uint8 pad pixel; normalises to ops.image.PAD_NORM (0.0)


def to_bucket(
    image: np.ndarray, bucket_h: int, bucket_w: int, scale: float
) -> tuple[np.ndarray, int, int]:
    """Place ``image`` into a (bucket_h, bucket_w, 3) gray canvas.

    Returns (canvas uint8, valid_h, valid_w). Content goes top-left at
    ``scale`` (1.0 = no resample, just pad)."""
    h, w = image.shape[:2]
    vh, vw = max(1, round(h * scale)), max(1, round(w * scale))
    vh, vw = min(vh, bucket_h), min(vw, bucket_w)
    content = (
        np.asarray(image, np.uint8)
        if (vh, vw) == (h, w)
        else _resize_host(np.asarray(image, np.uint8), vh, vw)
    )
    canvas = np.full((bucket_h, bucket_w, 3), GRAY_PAD, np.uint8)
    canvas[:vh, :vw] = content
    return canvas, vh, vw


class BucketedRunner:
    """Offline mixed-size batch processing over the bucket ladder.

    A dataset sweep feeds images of arbitrary shapes; one by one they
    run at batch 1, where the device mostly waits for launches. The
    runner maps every image into its bucket, accumulates per-bucket
    batches of ``batch_size``, runs each as one masked batch
    (``process_batch_async(valid_hw=...)``), and returns people in
    original-image coordinates and input order.
    """

    def __init__(self, estimator, buckets=DEFAULT_BUCKETS, scales=None,
                 batch_size: int = 8, depth: int = 2):
        self._est = estimator
        self._buckets = tuple(buckets)
        self._scales = scales
        self._bs = max(1, int(batch_size))
        self._depth = max(0, int(depth))
        # bucket shape -> list of (input-order index, canvas, (vh, vw), scale)
        self._pending: dict[tuple, list] = {}
        # enqueued-but-unresolved: (items, n, device tables); keeps up to
        # ``depth`` batches in flight so the host prepares the next canvas
        # while the device works (same contract as PoseEstimator.stream)
        self._inflight: list[tuple] = []
        self._results: dict[int, list[dict]] = {}
        self._n = 0

    def add(self, image: np.ndarray) -> int:
        """Queue one image; returns its input-order index."""
        idx = self._n
        self._n += 1
        h, w = image.shape[:2]
        bh, bw, s = choose_bucket(h, w, self._buckets)
        canvas, vh, vw = to_bucket(image, bh, bw, s)
        items = self._pending.setdefault((bh, bw), [])
        items.append((idx, canvas, (vh, vw), s))
        if len(items) >= self._bs:
            self._flush((bh, bw))
        return idx

    def _flush(self, key: tuple) -> None:
        items = self._pending.pop(key, [])
        if not items:
            return
        imgs = np.stack([c for _, c, _, _ in items])
        valid = np.asarray([v for _, _, v, _ in items], np.int32)
        n = len(items)
        pad = self._bs - n if n < self._bs else 0
        if pad:  # keep one batch geometry per bucket
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, axis=0)])
            valid = np.concatenate([valid, np.repeat(valid[-1:], pad, axis=0)])
        nb, tables = self._est.process_batch_async(
            imgs, scales=self._scales, valid_hw=valid
        )
        self._inflight.append((items, nb, tables))
        while len(self._inflight) > self._depth:
            self._resolve_one()

    def _resolve_one(self) -> None:
        items, nb, tables = self._inflight.pop(0)
        people = self._est._finish(nb, tables)
        for (idx, _, _, s), p in zip(items, people[: len(items)]):
            self._results[idx] = unscale_people(p, s)

    def finish(self) -> list[list[dict]]:
        """Flush remainders; returns people per image in input order.

        Resets the runner: a subsequent add/process_many starts a fresh
        sweep (indices and results from the finished one don't leak)."""
        for key in list(self._pending):
            self._flush(key)
        while self._inflight:
            self._resolve_one()
        out = [self._results[i] for i in range(self._n)]
        self._results = {}
        self._n = 0
        return out

    def process_many(self, images) -> list[list[dict]]:
        for img in images:
            self.add(img)
        return self.finish()


def unscale_people(people: list[dict], scale: float) -> list[dict]:
    """Map bucket-canvas keypoint coordinates back to the original image."""
    if scale == 1.0:
        return people
    inv = 1.0 / scale
    out = []
    for p in people:
        kps = {
            name: {**kp, "x": kp["x"] * inv, "y": kp["y"] * inv}
            for name, kp in p["keypoints"].items()
        }
        out.append({**p, "keypoints": kps})
    return out
