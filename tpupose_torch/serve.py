"""HTTP inference server of the port.

Counterpart of ``tpupose/serve.py``: a threaded stdlib HTTP server around
one ``PoseEstimator``. Endpoints:

  GET  /healthz          -> {"status": "ok", "pretrained": bool}
  GET  /metrics          -> request/error counts, latency p50/p90/p99,
                            micro-batch engagement (mean device batch)
  POST /pose             -> people JSON for one encoded (png/jpg) image
  POST /pose?draw=1      -> adds a base64 PNG skeleton overlay

Two dispatch modes:

  * serial (default): requests funnel through a lock, one
    ``PoseEstimator.process`` at a time on the handler's thread.
  * micro-batched (``--max-batch N`` with N > 1, or any bucket ladder):
    concurrent requests are gathered for up to ``--batch-window-ms`` and
    run as one ``PoseEstimator.process_batch`` per canvas shape on the
    batcher's worker thread. Device batches are padded to powers of two,
    so every bucket meets at most log2(max batch) + 1 batch geometries.

Overload: the batcher queue is bounded (``--max-queue``, default 8x
max_batch): a burst beyond the card's throughput is shed with 503 +
``Retry-After``; every request carries a deadline
(``--request-timeout-s``) answered with 504 when missed (abandoned queue
entries are dropped before they take device time). The serial path bounds
its waiters the same way (``--max-pending``). Shed and timeout counts ride
``/metrics`` with the queue depth.

Request bodies are decoded by ``cv2.imdecode`` as in the reference, in C
and outside the GIL. Where cv2 cannot be imported, ``_decode_png`` reads
8-bit non-interlaced PNGs (gray, gray + alpha, RGB, RGBA) with ``zlib``
and numpy to the same BGR array, and refuses, with a 400 that names cv2,
any other body and a PNG with more Average or Paeth rows than its Python
loop may spend on one request. ``?draw=1`` needs cv2 for the overlay.

Run: python -m tpupose_torch.serve --port 8080 [--weights model.h5]
     [--scales 1] [--max-batch 8 --batch-window-ms 5 --buckets default
     --warmup] [--device cpu]
"""

from __future__ import annotations

import argparse
import base64
import json
import struct
import sys
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from tpupose_torch import buckets as buckets_lib

DEFAULT_REQUEST_TIMEOUT_S = 30.0
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}    # colour type -> samples per pixel
_MAX_PIXELS = 1 << 30                        # cv2's default limit on decoded images
# Average and Paeth rows decode byte by byte in Python, contending with the
# batcher's worker for the GIL: without cv2, a body may hold this many bytes
# of them (a 368x368 RGB frame of Paeth rows passes, a 720x1280 one does not)
_SLOW_ROW_BYTES = 1 << 19


class Overloaded(RuntimeError):
    """Shed: the serving queue is at capacity (HTTP 503)."""


class RequestTimeout(RuntimeError):
    """The request missed its deadline before completing (HTTP 504)."""


class UndecodableImage(ValueError):
    """A request body that is not an image this server can decode (HTTP 400)."""


# --- request decoding ----------------------------------------------------------

def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth) of ``raw``,
    ``h`` rows of a filter byte and ``stride`` bytes each; (h, stride) uint8."""
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:      # Sub: a running sum of each byte lane, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:      # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: each byte needs the one bpp before it
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise UndecodableImage(f"cannot decode image: PNG row {y} has filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out


def _decode_png(data: bytes) -> np.ndarray | None:
    """The decoder of a server without cv2: an 8-bit non-interlaced gray,
    gray + alpha, RGB or RGBA PNG -> (H, W, 3) uint8 BGR, as
    ``cv2.imdecode(..., IMREAD_COLOR)`` gives it (alpha dropped, gray
    repeated). None for a PNG of another kind (palette, 16-bit,
    interlaced) or a body that is no PNG; raises ``UndecodableImage`` for
    a broken PNG and for one with over ``_SLOW_ROW_BYTES`` of Average or
    Paeth rows."""
    if not data.startswith(_PNG_SIGNATURE):
        return None
    pos, header, idat = len(_PNG_SIGNATURE), None, []
    try:
        while pos + 8 <= len(data):
            length, kind = struct.unpack(">I4s", data[pos:pos + 8])
            chunk = data[pos + 8:pos + 8 + length]
            if len(chunk) != length:
                raise UndecodableImage("cannot decode image: truncated PNG chunk")
            pos += 12 + length
            if kind == b"IHDR":
                header = struct.unpack(">IIBBBBB", chunk)
            elif kind == b"IDAT":
                idat.append(chunk)
            elif kind == b"IEND":
                break
        if header is None or not idat:
            raise UndecodableImage("cannot decode image: PNG without IHDR or IDAT")
        w, h, depth, colour, _, _, interlace = header
        if depth != 8 or interlace != 0 or colour not in _PNG_CHANNELS:
            return None
        if w * h > _MAX_PIXELS:
            raise UndecodableImage(f"cannot decode image: {w}x{h} exceeds {_MAX_PIXELS} pixels")
        bpp = _PNG_CHANNELS[colour]
        stride = w * bpp + 1
        # inflate no further than the header's image needs
        raw = np.frombuffer(zlib.decompressobj().decompress(b"".join(idat), h * stride),
                            np.uint8)
    except (struct.error, zlib.error) as e:
        raise UndecodableImage(f"cannot decode image: broken PNG ({e})") from e
    if w == 0 or h == 0 or raw.size < h * stride:
        raise UndecodableImage("cannot decode image: PNG data shorter than its header says")
    kinds = raw[:h * stride:stride]
    slow = int(np.count_nonzero((kinds == 3) | (kinds == 4))) * (stride - 1)
    if slow > _SLOW_ROW_BYTES:
        raise UndecodableImage(
            f"cannot decode image: {slow} bytes of Average/Paeth rows, more than "
            f"the {_SLOW_ROW_BYTES} read without cv2 (cv2 reads them)")
    pix = _unfilter(raw[:h * stride], h, stride - 1, bpp).reshape(h, w, bpp)
    if bpp <= 2:
        return np.repeat(pix[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(pix[:, :, 2::-1])


def decode_image(data: bytes) -> np.ndarray:
    """A request body -> (H, W, 3) uint8 BGR, by ``cv2.imdecode``; where cv2
    cannot be imported, by ``_decode_png``. Raises ``UndecodableImage``
    with the reason."""
    try:
        import cv2
    except ImportError as e:
        image = _decode_png(data)
        if image is None:
            raise UndecodableImage(
                "cannot decode image: the body is not an 8-bit non-interlaced PNG, "
                f"and other formats need cv2, which cannot be imported ({e})") from e
        return image
    image = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if image is None:
        raise UndecodableImage("cannot decode image")
    return image


# --- the micro-batcher -----------------------------------------------------------

class MicroBatcher:
    """Cross-request micro-batching.

    ``submit(image)`` blocks until the image's people JSON is ready. A
    single worker thread collects concurrent submissions for up to
    ``window_ms`` (or ``max_batch`` items, whichever first), groups them
    by image shape, pads each group to the next power of two (copies of
    its last image, whose outputs are dropped) and runs one
    ``process_batch`` per group. Errors reach every caller of the failed
    group.

    With ``buckets`` set (a ladder of (H, W) canvases, see
    ``tpupose_torch.buckets``), each image is aspect-preserving resized
    into its bucket before grouping, so requests of different shapes batch
    together; keypoints are mapped back to original-image coordinates.
    """

    def __init__(self, estimator, max_batch: int = 8, window_ms: float = 5.0,
                 scales=None, buckets=None, metrics=None,
                 max_queue: int | None = None):
        self._est = estimator
        self._metrics = metrics
        self._scales = scales
        self._buckets = tuple(buckets) if buckets else None
        self._max = max(1, int(max_batch))
        # bounded queue: beyond this depth submit() sheds (Overloaded)
        self._max_queue = int(max_queue) if max_queue else 8 * self._max
        self._window = max(0.0, window_ms) / 1e3
        self._cv = threading.Condition()
        self._queue: list[tuple[np.ndarray, dict]] = []
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @property
    def depth(self) -> int:
        """Current queue depth (for /metrics)."""
        with self._cv:
            return len(self._queue)

    def submit(self, image: np.ndarray, timeout_s: float | None = None) -> list[dict]:
        slot: dict = {"done": threading.Event()}
        with self._cv:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            if len(self._queue) >= self._max_queue:
                raise Overloaded(f"serving queue at capacity ({self._max_queue})")
            self._queue.append((np.asarray(image, np.uint8), slot))
            self._cv.notify()
        if not slot["done"].wait(timeout_s):
            with self._cv:
                # still queued: remove it so that it stops holding queue
                # capacity; already in flight: its result is dropped on arrival
                slot["abandoned"] = True
                for i, (_, s) in enumerate(self._queue):
                    if s is slot:
                        del self._queue[i]
                        break
            raise RequestTimeout(f"request exceeded its {timeout_s:.1f}s deadline")
        if "error" in slot:
            raise slot["error"]
        return slot["people"]

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join()

    # --- worker ---------------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue and self._closed:
                    return
                # first request in hand: linger up to the window for more
                deadline = time.monotonic() + self._window
                while len(self._queue) < self._max and not self._closed:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                batch = []
                while self._queue and len(batch) < self._max:
                    img, slot = self._queue.pop(0)
                    if slot.get("abandoned"):   # deadline already missed
                        continue
                    batch.append((img, slot))
                if not batch:
                    continue
            try:
                self._process(batch)
            except BaseException as e:  # backstop: the worker must survive
                for _, slot in batch:
                    if not slot["done"].is_set():
                        slot["error"] = e if isinstance(e, Exception) else (
                            RuntimeError(f"batch worker failed: {e!r}"))
                        slot["done"].set()

    def _process(self, batch: list[tuple[np.ndarray, dict]]) -> None:
        # items: (canvas, slot, valid_hw | None, scale)
        groups: dict[tuple, list[tuple]] = {}
        if self._buckets is None:
            for img, slot in batch:
                groups.setdefault(img.shape, []).append((img, slot, None, 1.0))
        else:
            for img, slot in batch:
                # per item: a malformed image (wrong ndim, zero-sized) fails
                # its own request, not the worker or the batch
                try:
                    bh, bw, s = buckets_lib.choose_bucket(img.shape[0], img.shape[1],
                                                          self._buckets)
                    canvas, vh, vw = buckets_lib.to_bucket(img, bh, bw, s)
                except Exception as e:
                    slot["error"] = e
                    slot["done"].set()
                    continue
                groups.setdefault(canvas.shape, []).append((canvas, slot, (vh, vw), s))
        for items in groups.values():
            try:
                n = len(items)
                imgs = np.stack([img for img, *_ in items])
                valid = (None if items[0][2] is None
                         else np.asarray([it[2] for it in items], np.int32))
                bucket = 1 << (n - 1).bit_length()
                if bucket > n:  # pad with copies; padded outputs dropped
                    imgs = np.concatenate([imgs, np.repeat(imgs[-1:], bucket - n, axis=0)])
                    if valid is not None:
                        valid = np.concatenate(
                            [valid, np.repeat(valid[-1:], bucket - n, axis=0)])
                # only bucketed batches pass valid_hw: plain mode keeps the
                # process_batch(images, scales) signature
                kw = {} if valid is None else {"valid_hw": valid}
                people = self._est.process_batch(imgs, scales=self._scales, **kw)
                if self._metrics is not None:
                    self._metrics.record_batch(n)
                for (_, slot, _, s), p in zip(items, people[:n]):
                    slot["people"] = buckets_lib.unscale_people(p, s)
                    slot["done"].set()
            except Exception as e:  # reaches every waiting caller
                for _, slot, *_ in items:
                    slot["error"] = e
                    slot["done"].set()


# --- process memory and metrics ------------------------------------------------------

def rss_mb() -> float | None:
    """Resident set size of this process in MB (Linux /proc; None where
    unavailable). Exposed on ``/metrics`` so that a deploy can watch serving
    memory, and read by the ``--max-rss-mb`` recycle guard."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except (OSError, ValueError, IndexError):
        pass
    return None


class RssWatchdog(threading.Thread):
    """Samples process RSS; sets ``tripped`` when it exceeds the limit.

    The serving main loop waits on ``tripped`` and recycles cleanly (stop
    accepting, drain the batcher, exit 3): where memory grows below the
    application, bounding the process lifetime under a supervisor is the
    in-process mitigation."""

    def __init__(self, limit_mb: float, interval_s: float = 5.0):
        super().__init__(daemon=True)
        self.limit_mb = float(limit_mb)
        self.interval_s = float(interval_s)
        self.tripped = threading.Event()
        self.last_mb: float | None = None
        self._stop = threading.Event()

    def run(self) -> None:
        while not self._stop.wait(self.interval_s):
            mb = rss_mb()
            if mb is None:
                return  # no /proc: nothing to watch
            self.last_mb = mb
            if mb > self.limit_mb:
                self.tripped.set()
                return

    def stop(self) -> None:
        self._stop.set()


class ServeMetrics:
    """Lock-guarded serving counters for the ``/metrics`` endpoint.

    Request count, errors (server 5xx apart from client 4xx, so that the
    alertable signal does not climb on junk uploads), a bounded reservoir
    of recent request latencies (wall, from the body read to the reply)
    and the device-batch sizes the micro-batcher ran.
    """

    RESERVOIR = 1024

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.errors = 0          # 5xx: inference/server failures
        self.client_errors = 0   # 4xx: bad requests (junk bodies, 413s)
        self.shed = 0            # 503: overload shedding (bounded queue)
        self.timeouts = 0        # 504: missed request deadlines
        self._lat: list[float] = []   # ring buffer, seconds
        self._lat_pos = 0
        self.batches = 0
        self.batched_images = 0

    def record(self, seconds: float, status: int = 200) -> None:
        with self._lock:
            self.requests += 1
            if status == 503:
                self.shed += 1      # expected under overload, not an error
            elif status == 504:
                self.timeouts += 1
            elif status >= 500:
                self.errors += 1
            elif status >= 400:
                self.client_errors += 1
            if len(self._lat) < self.RESERVOIR:
                self._lat.append(seconds)
            else:
                self._lat[self._lat_pos] = seconds
                self._lat_pos = (self._lat_pos + 1) % self.RESERVOIR

    def record_batch(self, n_images: int) -> None:
        with self._lock:
            self.batches += 1
            self.batched_images += n_images

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat)
            n = len(lat)
            pick = lambda q: (lat[min(n - 1, int(q * n))] * 1e3) if n else None  # noqa: E731
            return {
                "requests": self.requests,
                "errors": self.errors,
                "client_errors": self.client_errors,
                "shed": self.shed,
                "timeouts": self.timeouts,
                "latency_ms": {"p50": pick(0.50), "p90": pick(0.90), "p99": pick(0.99)},
                "batches": self.batches,
                "mean_batch": (self.batched_images / self.batches if self.batches else None),
                "rss_mb": rss_mb(),
            }


# --- the HTTP shell ---------------------------------------------------------------

def make_handler(estimator, batcher: MicroBatcher | None = None,
                 metrics: ServeMetrics | None = None,
                 max_body_bytes: int = 32 << 20,
                 request_timeout_s: float = DEFAULT_REQUEST_TIMEOUT_S,
                 max_pending: int = 32):
    lock = threading.Lock()
    # serial mode: bound the requests allowed to wait on the lock (the server
    # spawns a thread per connection; without this a burst grows threads and
    # latency without limit)
    pending = threading.Semaphore(max(1, max_pending))
    retry_after_s = max(1, int(request_timeout_s / 10) or 1)

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj: dict, headers: dict | None = None) -> None:
            self._last_status = code
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, str(v))
            self.end_headers()
            self.wfile.write(body)

        def _shed(self, why: str) -> None:
            self._reply(503, {"error": f"overloaded: {why}"},
                        headers={"Retry-After": retry_after_s})

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok", "pretrained": estimator.pretrained})
            elif self.path == "/metrics" and metrics is not None:
                snap = metrics.snapshot()
                if batcher is not None:
                    snap["queue_depth"] = batcher.depth
                self._reply(200, snap)
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if not self.path.startswith("/pose"):
                self._reply(404, {"error": "unknown path"})
                return
            t0 = time.perf_counter()
            try:
                n = int(self.headers.get("Content-Length", "0"))
                if n <= 0:
                    self._reply(400, {"error": "empty body"})
                    return
                if n > max_body_bytes:
                    self._reply(413, {"error": f"body {n} bytes exceeds limit {max_body_bytes}"})
                    return
                data = self.rfile.read(n)
                try:
                    image = decode_image(data)
                except UndecodableImage as e:
                    self._reply(400, {"error": str(e)})
                    return
                draw = "draw=1" in (self.path.split("?", 1) + [""])[1]
                deadline = t0 + request_timeout_s
                if batcher is not None:
                    try:
                        people = batcher.submit(image, timeout_s=deadline - time.perf_counter())
                    except Overloaded as e:
                        self._shed(str(e))
                        return
                    except RequestTimeout as e:
                        self._reply(504, {"error": str(e)})
                        return
                    out = {"people": people}
                    if draw:
                        from tpupose_torch.utils.drawing import draw_people

                        out["canvas"] = draw_people(np.asarray(image, np.uint8), people)
                else:
                    if not pending.acquire(blocking=False):
                        self._shed(f"{max_pending} requests already pending")
                        return
                    try:
                        if not lock.acquire(timeout=max(0.0, deadline - time.perf_counter())):
                            self._reply(504, {"error": "request exceeded its "
                                                       f"{request_timeout_s:.1f}s deadline"})
                            return
                        try:
                            out = estimator.process(image, draw=draw)
                        finally:
                            lock.release()
                    finally:
                        pending.release()
                resp = {"people": out["people"]}
                if draw:
                    import cv2

                    ok, png = cv2.imencode(".png", out["canvas"])
                    if ok:
                        resp["overlay_png_b64"] = base64.b64encode(png.tobytes()).decode()
                self._reply(200, resp)
            except Exception as e:
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            finally:
                if metrics is not None:
                    metrics.record(time.perf_counter() - t0,
                                   status=getattr(self, "_last_status", 500))

        def log_message(self, fmt, *args):  # quiet
            pass

    return Handler


def serve(estimator, host: str = "127.0.0.1", port: int = 8080,
          max_batch: int = 1, batch_window_ms: float = 5.0, scales=None,
          buckets=None, max_queue: int | None = None,
          request_timeout_s: float = DEFAULT_REQUEST_TIMEOUT_S,
          max_pending: int = 32):
    """Returns the started ThreadingHTTPServer (the caller owns shutdown).

    ``max_batch > 1`` enables the cross-request micro-batcher; the returned
    server carries it as ``server.batcher`` (close it after shutdown).
    ``buckets`` (a ladder of (H, W), see ``tpupose_torch.buckets``) bounds
    the batch geometries over arbitrary request shapes; it routes every
    request through the batcher even at max_batch 1.

    Overload: ``max_queue`` bounds the batcher queue (default 8x max_batch)
    and ``max_pending`` the serial-mode waiters; beyond either, requests
    are shed with 503 + Retry-After. ``request_timeout_s`` is the
    per-request deadline (504 when missed)."""
    metrics = ServeMetrics()
    batcher = (
        MicroBatcher(estimator, max_batch, batch_window_ms, scales, buckets,
                     metrics, max_queue=max_queue)
        if max_batch > 1 or buckets else None
    )
    server = ThreadingHTTPServer(
        (host, port),
        make_handler(estimator, batcher, metrics,
                     request_timeout_s=request_timeout_s, max_pending=max_pending),
    )
    server.batcher = batcher
    server.metrics = metrics
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


def warmup_estimator(estimator, buckets, max_batch: int = 1, scales=None,
                     log=None) -> int:
    """Run every batch geometry live traffic can reach, before the traffic.

    The micro-batcher runs (bucket canvas, power-of-two device batch,
    ``valid_hw`` present) geometries, see ``MicroBatcher._process``. The
    first run of a geometry on the card builds the kernels that are not
    built yet (nvcc), lets cuDNN choose its algorithms for the new shapes
    and grows the caching allocator; a cold server would pay all of it on
    the first unlucky request. Runs one blank ``process_batch`` per bucket
    x power-of-two size up to ceil_pow2(max_batch), with ``valid_hw``
    exactly as the batcher passes it; returns the number of geometries run.
    """
    if not buckets:
        return 0
    top = 1 << (max(1, int(max_batch)) - 1).bit_length()
    sizes = [1 << i for i in range(top.bit_length())]
    warmed = 0
    for bh, bw in buckets:
        for n in sizes:
            t0 = time.perf_counter()
            imgs = np.zeros((n, bh, bw, 3), np.uint8)
            valid = np.asarray([[bh, bw]] * n, np.int32)
            estimator.process_batch(imgs, scales=scales, valid_hw=valid)
            warmed += 1
            if log is not None:
                log(f"warmup {bh}x{bw} batch={n}: {time.perf_counter() - t0:.1f}s")
    return warmed


def _run_until_exit(server, max_rss_mb: float | None = None) -> int:
    """Block until Ctrl-C (exit 0) or the RSS guard trips (exit 3, the
    supervisor-restart signal); always drains the batcher on the way out."""
    wd = None
    if max_rss_mb:
        wd = RssWatchdog(max_rss_mb)
        wd.start()
    try:
        while True:
            if wd is not None:
                if wd.tripped.wait(timeout=3600):
                    print(f"rss {wd.last_mb:.0f} MB exceeded --max-rss-mb "
                          f"{wd.limit_mb:.0f}; recycling (exit 3)", file=sys.stderr)
                    return 3
            else:
                time.sleep(3600)
    except KeyboardInterrupt:
        return 0
    finally:
        if wd is not None:
            wd.stop()
        server.shutdown()
        if server.batcher is not None:
            server.batcher.close()


def main(argv=None) -> int:
    from tpupose_torch.cli import _add_common_model_args, _estimator

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-batch", type=int, default=1,
                    help="> 1 enables cross-request micro-batching (default 1: "
                         "serial service)")
    ap.add_argument("--batch-window-ms", type=float, default=5.0)
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound on queued requests before 503 shedding "
                         "(default 8x max-batch)")
    ap.add_argument("--request-timeout-s", type=float, default=DEFAULT_REQUEST_TIMEOUT_S,
                    help="per-request deadline; missed -> 504")
    ap.add_argument("--max-pending", type=int, default=32,
                    help="serial mode: bound on requests waiting for the "
                         "device before 503 shedding")
    ap.add_argument("--buckets", default=None,
                    help="shape-bucket ladder: 'default' or '368x368,368x496,...' — "
                         "bounds the batch geometries over arbitrary request shapes")
    ap.add_argument("--warmup", action="store_true",
                    help="run every (bucket x batch-size) geometry before "
                         "accepting traffic (requires --buckets): kernel builds, "
                         "cuDNN's algorithm choice and the allocator's growth "
                         "never land on a live request's deadline")
    ap.add_argument("--max-rss-mb", type=float, default=None,
                    help="recycle guard: when process RSS exceeds this, stop "
                         "accepting, drain in-flight requests and exit 3 so a "
                         "supervisor restarts the server")
    _add_common_model_args(ap)
    args = ap.parse_args(argv)

    bks = buckets_lib.resolve_buckets(args.buckets)
    if args.warmup and not bks:
        print("error: --warmup requires --buckets (without a bucket "
              "ladder the request shapes, hence the geometries to "
              "run, are unknown)", file=sys.stderr)
        return 2
    est = _estimator(args)
    if args.warmup:
        n = warmup_estimator(est, bks, max_batch=args.max_batch,
                             log=lambda m: print(m, file=sys.stderr))
        print(f"warmed {n} batch geometries", file=sys.stderr)
    server = serve(
        est, host=args.host, port=args.port, max_batch=args.max_batch,
        batch_window_ms=args.batch_window_ms, buckets=bks,
        max_queue=args.max_queue, request_timeout_s=args.request_timeout_s,
        max_pending=args.max_pending,
    )
    print(f"serving on http://{args.host}:{args.port}  (pretrained={est.pretrained})")
    return _run_until_exit(server, args.max_rss_mb)


if __name__ == "__main__":
    raise SystemExit(main())
