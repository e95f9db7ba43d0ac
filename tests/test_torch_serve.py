"""The port's HTTP server (``tpupose_torch/serve.py``) against the JAX
package's, and its host logic on its own.

Parity: the port's server and the JAX server, over estimators of the same
small configuration (1 stage, f32, scale 0.5, as tests/test_serve.py) and
the same weight file, answer the same PNG bodies with the same people
(coordinates equal, scores within rtol 1e-5, atol 1e-4, the tolerance of
tests/test_torch_infer.py), in serial mode and micro-batched over a bucket
ladder. The host-logic cases of tests/test_serve.py are ported against the
port's module, with a duck-typed estimator where the JAX test uses one.
The server decodes request bodies with cv2, as the reference does: a large
body of Paeth rows never reaches the Python row loop and answers beside a
concurrent request. ``_decode_png``, the decoder of a server without cv2,
is held bit for bit to ``cv2.imdecode(IMREAD_COLOR)`` on PNGs that cv2 and
PIL encode, over all five row filters; with cv2 hidden, a JPEG body and a
PNG with too many Average/Paeth bytes get a 400 that names cv2, and a
smaller PNG still decodes.
"""

import base64
import builtins
import concurrent.futures
import http.client
import io
import json
import struct
import sys
import threading
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_weights import (
    _jax_tree, _layers, _small_cfgs, _write, assert_same_people,
)
from tpupose.infer import PoseEstimator as JaxEstimator
from tpupose.models import weights as jweights
from tpupose.serve import serve as jax_serve
from tpupose_torch.buckets import DEFAULT_BUCKETS
from tpupose_torch.infer import PoseEstimator
from tpupose_torch.serve import (
    MicroBatcher, Overloaded, RequestTimeout, RssWatchdog, ServeMetrics, _decode_png,
    _run_until_exit, rss_mb, serve, warmup_estimator,
)
from tpupose_torch.testing import limit_threads

limit_threads()


def png(img: np.ndarray) -> bytes:
    import cv2

    ok, enc = cv2.imencode(".png", img)
    assert ok
    return enc.tobytes()


def _conn(server):
    host, port = server.server_address[:2]
    return http.client.HTTPConnection(host, port, timeout=600)


def post(server, body: bytes, path: str = "/pose"):
    c = _conn(server)
    c.request("POST", path, body=body)
    r = c.getresponse()
    return r.status, json.loads(r.read()), r.getheader("Retry-After")


def get(server, path: str):
    c = _conn(server)
    c.request("GET", path)
    r = c.getresponse()
    return r.status, json.loads(r.read())


def _metrics_after(server, n_requests: int, timeout_s: float = 10.0) -> dict:
    """/metrics once it counts ``n_requests`` (a request is recorded after
    its reply is written)."""
    deadline = time.time() + timeout_s
    while True:
        m = get(server, "/metrics")[1]
        if m["requests"] >= n_requests or time.time() > deadline:
            return m
        time.sleep(0.02)


# --- the two servers on the same weights ---------------------------------------------
@pytest.fixture(scope="module")
def estimators(tmp_path_factory):
    """(JAX estimator, port estimator) on one weight file; the JAX one takes
    the JAX loader's tree of it (tests/test_torch_weights.py says why)."""
    path = _write(tmp_path_factory.mktemp("w"), "h5", _layers(1, seed=6, head_gain=1000.0))
    jcfg, tcfg = _small_cfgs()
    jtree = jweights.load_reference_weights(path, _jax_tree(1))[0]
    return (JaxEstimator(jcfg, params=jax.tree.map(jnp.asarray, jtree)),
            PoseEstimator(tcfg, weights_path=path, device="cpu"))


def _images():
    rng = np.random.default_rng(11)
    return [(rng.random(shape) * 255).astype(np.uint8)
            for shape in ((160, 200, 3), (150, 170, 3), (120, 200, 3))]


class _OneProgram:
    """The JAX estimator with ``process`` run as a batch of one through the
    program the bucketed test compiles (a 160x200 canvas, ``valid_hw``
    the whole image): one XLA compile for both tests, where the JAX
    single-image path would take a second compile, the longest step here.
    Only 160x200 images reach it."""

    pretrained = True

    def __init__(self, est):
        self.est = est

    def process(self, image, draw=False):
        assert image.shape[:2] == (160, 200) and not draw
        return {"people": self.est.process_batch(
            image[None], valid_hw=np.asarray([[160, 200]], np.int32))[0]}


def test_serial_server_answers_as_the_reference_server(estimators):
    jest, test = estimators
    jsrv = jax_serve(_OneProgram(jest), port=0, request_timeout_s=600.0)
    tsrv = serve(test, port=0)
    try:
        body = png(_images()[0])
        js, jbody, _ = post(jsrv, body)
        ts, tbody, _ = post(tsrv, body)
        assert js == ts == 200
        assert len(jbody["people"]) >= 3
        assert_same_people(tbody["people"], jbody["people"])
        assert get(tsrv, "/healthz") == get(jsrv, "/healthz") == (
            200, {"status": "ok", "pretrained": True})
    finally:
        jsrv.shutdown()
        tsrv.shutdown()


def test_bucketed_server_answers_as_the_reference_server(estimators):
    """One bucket: every image resized into the 160x200 canvas. Requests go
    one at a time to the JAX server (one batch geometry to compile) and
    both one at a time and all at once to the port's."""
    jest, test = estimators
    kw = dict(port=0, max_batch=4, batch_window_ms=20.0, buckets=((160, 200),))
    jsrv, tsrv = jax_serve(jest, request_timeout_s=600.0, **kw), serve(test, **kw)
    try:
        bodies = [png(img) for img in _images()]
        want = [post(jsrv, b)[1]["people"] for b in bodies]
        assert sum(map(len, want)) >= 3
        for body, w in zip(bodies, want):
            status, got, _ = post(tsrv, body)
            assert status == 200
            assert_same_people(got["people"], w)
        with concurrent.futures.ThreadPoolExecutor(3) as ex:
            together = list(ex.map(lambda b: post(tsrv, b), bodies))
        for (status, got, _), w in zip(together, want):
            assert status == 200
            assert_same_people(got["people"], w)
        m = _metrics_after(tsrv, 6)
        assert m["requests"] == 6 and m["errors"] == 0 and m["batches"] >= 2
    finally:
        for srv in (jsrv, tsrv):
            srv.shutdown()
            srv.batcher.close()


def test_server_threads_run_the_estimator_without_autograd(estimators):
    """process and process_batch reach torch.inference_mode from any thread."""
    test = estimators[1]
    img = _images()[1]
    seen = {}

    def work():
        seen["tables"] = test.process_async(img)
        seen["maps"] = test.maps(img)
        seen["grad"] = torch.is_grad_enabled()

    t = threading.Thread(target=work)
    t.start()
    t.join()
    assert seen["grad"] is True           # the thread's own mode is untouched
    assert all(v.is_inference() for v in seen["tables"].values())
    assert all(m.is_inference() and not m.requires_grad for m in seen["maps"])


def test_kernel_builds_of_two_threads_write_separate_files():
    """Two threads building one kernel (a cold server's first requests)
    never write the same temporary file; each renames a whole library."""
    from tpupose_torch.ops import _build, assoc

    lib = assoc.KERNEL._lib_path()
    paths = []
    both_alive = threading.Barrier(2)     # a finished thread's ident can be reused

    def build():
        paths.append(_build.CudaKernel._tmp_path(lib))
        both_alive.wait(timeout=10)

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert len(set(paths)) == 2 and all(p.startswith(lib[:-3]) for p in paths)


# --- host logic (tests/test_serve.py, against the port) -----------------------------------
class _FakeServeEstimator:
    """Minimal estimator for server-level tests."""

    pretrained = False

    def __init__(self, delay_s=0.0, fail=None):
        self.delay_s = delay_s
        self.fail = fail

    def process(self, image, draw=False):
        time.sleep(self.delay_s)
        if self.fail:
            raise self.fail
        out = {"people": []}
        if draw:
            out["canvas"] = np.asarray(image, np.uint8)
        return out

    def process_batch(self, imgs, scales=None, valid_hw=None):
        time.sleep(self.delay_s)
        if self.fail:
            raise self.fail
        return [[] for _ in range(len(imgs))]


@pytest.fixture(scope="module")
def fake_server():
    srv = serve(_FakeServeEstimator(), port=0)
    yield srv
    srv.shutdown()


def test_healthz(fake_server):
    assert get(fake_server, "/healthz") == (200, {"status": "ok", "pretrained": False})


def test_pose_bad_body_400(fake_server):
    status, body, _ = post(fake_server, b"not an image")
    assert status == 400 and "cannot decode" in body["error"]
    status, body, _ = post(fake_server, b"\x89PNG\r\n\x1a\n\x00\x00\x00\x0dIHDR\x00")
    assert status == 400 and "cannot decode" in body["error"]


def test_unknown_path_404(fake_server):
    assert get(fake_server, "/nope")[0] == 404
    assert post(fake_server, b"x", "/other")[0] == 404


def test_unknown_path_404_reads_the_body_first(fake_server):
    # a server that closed over the unread body would reset the connection
    # while this client is still sending
    for size in (1, 8 << 20):
        assert post(fake_server, b"x" * size, "/other")[:2] == (404, {"error": "unknown path"})


def test_oversized_body_rejected_413(fake_server):
    c = _conn(fake_server)
    c.putrequest("POST", "/pose")
    c.putheader("Content-Length", str(64 << 20))
    c.endheaders()
    r = c.getresponse()
    assert r.status == 413 and "exceeds limit" in json.loads(r.read())["error"]


def test_pose_roundtrip_with_overlay(estimators):
    import cv2

    srv = serve(estimators[1], port=0)
    try:
        img = _images()[2]
        status, body, _ = post(srv, png(img), "/pose?draw=1")
        assert status == 200 and isinstance(body["people"], list)
        overlay = cv2.imdecode(np.frombuffer(base64.b64decode(body["overlay_png_b64"]), np.uint8),
                               cv2.IMREAD_COLOR)
        assert overlay.shape == img.shape
    finally:
        srv.shutdown()


def test_bucketed_draw_overlay_in_original_frame(estimators):
    import cv2

    srv = serve(estimators[1], port=0, max_batch=2, batch_window_ms=5.0, buckets=((96, 96),))
    try:
        img = np.random.default_rng(8).integers(0, 255, (100, 80, 3)).astype(np.uint8)
        status, body, _ = post(srv, png(img), "/pose?draw=1")
        assert status == 200
        overlay = cv2.imdecode(np.frombuffer(base64.b64decode(body["overlay_png_b64"]), np.uint8),
                               cv2.IMREAD_COLOR)
        assert overlay.shape == (100, 80, 3)
        for p in body["people"]:
            for kp in p["keypoints"].values():
                assert 0 <= kp["x"] < 80 and 0 <= kp["y"] < 100
    finally:
        srv.shutdown()
        srv.batcher.close()


def test_metrics_endpoint(fake_server):
    before = get(fake_server, "/metrics")[1]
    assert post(fake_server, png(np.zeros((16, 16, 3), np.uint8)))[0] == 200
    assert post(fake_server, b"junk")[0] == 400      # 400 -> client_errors only
    after = _metrics_after(fake_server, before["requests"] + 2)
    assert after["requests"] == before["requests"] + 2
    assert after["client_errors"] == before["client_errors"] + 1
    assert after["errors"] == before["errors"]  # 4xx must not alert as 5xx
    assert after["latency_ms"]["p50"] is not None
    assert after["latency_ms"]["p99"] >= after["latency_ms"]["p50"]
    assert after["rss_mb"] is not None and after["rss_mb"] > 10.0


def test_metrics_batch_engagement():
    release = threading.Event()
    calls = []

    class Gated(_FakeServeEstimator):
        def process_batch(self, imgs, scales=None, valid_hw=None):
            calls.append(len(imgs))
            if len(calls) == 1:
                release.wait(10.0)      # hold the first batch until the wave queued
            return [[] for _ in range(len(imgs))]

    srv = serve(Gated(), port=0, max_batch=4, batch_window_ms=50.0)
    try:
        body = png(np.zeros((16, 16, 3), np.uint8))
        with concurrent.futures.ThreadPoolExecutor(5) as ex:
            futs = [ex.submit(post, srv, body) for _ in range(5)]
            deadline = time.monotonic() + 10.0
            while (calls[:1] or [0])[0] + srv.batcher.depth < 5 and time.monotonic() < deadline:
                time.sleep(0.005)
            release.set()
            assert [f.result()[0] for f in futs] == [200] * 5
        m = _metrics_after(srv, 5)
        assert m["batches"] >= 1 and m["mean_batch"] is not None
        assert m["mean_batch"] > 1.0   # the concurrent wave coalesced
    finally:
        release.set()
        srv.shutdown()
        srv.batcher.close()


def test_metrics_queue_wait_of_the_batcher():
    """A request queued behind a held batch waits until the worker takes
    it; ``/metrics`` reports the waits' percentiles."""
    started, release = threading.Event(), threading.Event()

    class Held:
        def process_batch(self, imgs, scales=None):
            started.set()
            release.wait(10.0)
            return [[] for _ in range(len(imgs))]

    metrics = ServeMetrics()
    assert metrics.snapshot()["queue_wait_ms"] == {"p50": None, "p90": None, "p99": None}
    mb = MicroBatcher(Held(), max_batch=1, window_ms=0.0, metrics=metrics)
    try:
        img = np.zeros((8, 8, 3), np.uint8)
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            first = ex.submit(mb.submit, img)
            assert started.wait(10.0)
            second = ex.submit(mb.submit, img)
            deadline = time.monotonic() + 10.0
            while mb.depth < 1 and time.monotonic() < deadline:
                time.sleep(0.005)
            time.sleep(0.1)
            release.set()
            assert first.result(timeout=10.0) == [] and second.result(timeout=10.0) == []
        wait = metrics.snapshot()["queue_wait_ms"]
        assert wait["p99"] >= 100.0 and wait["p50"] <= wait["p99"]
    finally:
        release.set()
        mb.close()

def test_microbatch_server_correctness(estimators):
    """Concurrent clients against a micro-batching server each get what
    process_batch gives for their image."""
    test = estimators[1]
    srv = serve(test, port=0, max_batch=4, batch_window_ms=30.0)
    try:
        rng = np.random.default_rng(1)
        imgs = [(rng.random((64, 80, 3)) * 255).astype(np.uint8) for _ in range(3)]
        with concurrent.futures.ThreadPoolExecutor(3) as ex:
            got = list(ex.map(lambda im: post(srv, png(im)), imgs))
        for img, (status, body, _) in zip(imgs, got):
            assert status == 200
            assert_same_people(body["people"], test.process_batch(img[None])[0])
    finally:
        srv.shutdown()
        srv.batcher.close()


def test_microbatcher_batches_concurrent_submissions():
    calls = []
    release = threading.Event()

    class FakeEstimator:
        def process_batch(self, imgs, scales=None):
            calls.append(imgs.shape[0])
            if len(calls) == 1:
                release.wait(timeout=10.0)
            return [[{"id": float(imgs[i].mean())}] for i in range(len(imgs))]

    mb = MicroBatcher(FakeEstimator(), max_batch=8, window_ms=20.0)
    try:
        imgs = [np.full((8, 8, 3), i, np.uint8) for i in range(8)]
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            futs = [ex.submit(mb.submit, img) for img in imgs]
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                if mb.depth + (calls[0] if calls else 0) >= 8:
                    break
                time.sleep(0.005)
            release.set()
            got = [f.result(timeout=30.0) for f in futs]
        for i, people in enumerate(got):
            assert people == [{"id": float(i)}]
        assert sum(calls) >= 8 and len(calls) <= 2, calls
        assert all(n & (n - 1) == 0 for n in calls)      # powers of two
    finally:
        release.set()
        mb.close()


def test_batcher_sheds_when_queue_full():
    release = threading.Event()

    class Slow:
        def process_batch(self, imgs, scales=None):
            release.wait(30.0)
            return [[] for _ in range(len(imgs))]

    mb = MicroBatcher(Slow(), max_batch=1, window_ms=0.0, max_queue=2)
    try:
        def submit(_):
            try:
                return ("ok", mb.submit(np.zeros((8, 8, 3), np.uint8)))
            except Overloaded as e:
                return ("shed", e)

        with concurrent.futures.ThreadPoolExecutor(10) as ex:
            futs = [ex.submit(submit, i) for i in range(10)]
            deadline = time.monotonic() + 15.0
            while time.monotonic() < deadline:
                if sum(f.done() for f in futs) + mb.depth >= 9:
                    break
                time.sleep(0.005)
            release.set()
            kinds = [f.result()[0] for f in futs]
        assert kinds.count("shed") >= 1 and kinds.count("ok") >= 3 and len(kinds) == 10
    finally:
        release.set()
        mb.close()


def test_batcher_timeout_and_abandoned_entries_dropped():
    release = threading.Event()
    processed = []

    class Slow:
        def process_batch(self, imgs, scales=None):
            release.wait(5.0)
            processed.extend(float(imgs[i].mean()) for i in range(len(imgs)))
            return [[] for _ in range(len(imgs))]

    mb = MicroBatcher(Slow(), max_batch=1, window_ms=0.0)
    try:
        first = threading.Thread(target=lambda: mb.submit(np.full((8, 8, 3), 1, np.uint8)))
        first.start()            # occupies the worker
        time.sleep(0.1)
        with pytest.raises(RequestTimeout):
            mb.submit(np.full((8, 8, 3), 2, np.uint8), timeout_s=0.2)
        release.set()
        first.join(5.0)
        time.sleep(0.2)          # the worker drains the queue
        assert 1.0 in processed and 2.0 not in processed
    finally:
        release.set()
        mb.close()


def test_abandoned_requests_release_queue_capacity():
    release = threading.Event()

    class Stalling:
        def process_batch(self, imgs, scales=None, valid_hw=None):
            release.wait(10.0)
            return [[] for _ in range(len(imgs))]

    img = np.zeros((8, 8, 3), np.uint8)
    mb = MicroBatcher(Stalling(), max_batch=1, window_ms=0.0, max_queue=2)
    try:
        threading.Thread(target=lambda: mb.submit(img, timeout_s=10.0), daemon=True).start()
        deadline = time.time() + 5.0
        while mb.depth > 0 and time.time() < deadline:
            time.sleep(0.01)
        for _ in range(2):
            with pytest.raises(RequestTimeout):
                mb.submit(img, timeout_s=0.05)
        assert mb.depth == 0
        try:
            mb.submit(img, timeout_s=0.05)
        except Overloaded:
            pytest.fail("abandoned entries still hold queue capacity")
        except RequestTimeout:
            pass
    finally:
        release.set()
        mb.close()


def test_server_serial_sheds_503_with_retry_after():
    srv = serve(_FakeServeEstimator(delay_s=0.5), port=0, max_pending=1)
    try:
        body = png(np.zeros((16, 16, 3), np.uint8))
        with concurrent.futures.ThreadPoolExecutor(6) as ex:
            got = list(ex.map(lambda _: post(srv, body), range(6)))
        statuses = [s for s, _, _ in got]
        assert 200 in statuses and 503 in statuses
        assert all(ra is not None for s, _, ra in got if s == 503)
        m = _metrics_after(srv, 6)
        assert m["shed"] == statuses.count(503) and m["errors"] == 0
    finally:
        srv.shutdown()


def test_server_batcher_timeout_returns_504():
    srv = serve(_FakeServeEstimator(delay_s=0.8), port=0, max_batch=2,
                batch_window_ms=0.0, request_timeout_s=0.3)
    try:
        body = png(np.zeros((16, 16, 3), np.uint8))
        with concurrent.futures.ThreadPoolExecutor(3) as ex:
            got = [s for s, _, _ in ex.map(lambda _: post(srv, body), range(3))]
        assert 504 in got
        m = get(srv, "/metrics")[1]
        assert m["timeouts"] >= 1 and "queue_depth" in m
    finally:
        srv.shutdown()
        srv.batcher.close()


def test_microbatcher_error_propagates():
    class Broken:
        def process_batch(self, imgs, scales=None):
            raise RuntimeError("boom")

    mb = MicroBatcher(Broken(), max_batch=2, window_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            mb.submit(np.zeros((8, 8, 3), np.uint8))
    finally:
        mb.close()


def test_device_error_answers_every_waiting_request_500_and_the_server_lives_on():
    """An error of the device batch (a failed kernel launch, say) reaches
    every request of the batch as a 500; the next batch is served."""
    fake = _FakeServeEstimator(delay_s=0.05, fail=RuntimeError("CUDA error: launch failure"))
    srv = serve(fake, port=0, max_batch=4, batch_window_ms=30.0, request_timeout_s=10.0)
    try:
        body = png(np.zeros((16, 16, 3), np.uint8))
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            got = list(ex.map(lambda _: post(srv, body), range(4)))
        assert [s for s, _, _ in got] == [500] * 4
        assert all("launch failure" in b["error"] for _, b, _ in got)
        fake.fail = None
        assert post(srv, body)[0] == 200
        m = _metrics_after(srv, 5)
        assert m["errors"] == 4 and m["timeouts"] == 0
    finally:
        srv.shutdown()
        srv.batcher.close()


def test_microbatcher_survives_malformed_image():
    class FakeEstimator:
        def process_batch(self, imgs, scales=None, valid_hw=None):
            return [[{"ok": 1.0}] for _ in range(len(imgs))]

    mb = MicroBatcher(FakeEstimator(), max_batch=2, window_ms=1.0, buckets=DEFAULT_BUCKETS)
    try:
        with pytest.raises(Exception):
            mb.submit(np.zeros((0, 16, 3), np.uint8))
        assert mb.submit(np.zeros((16, 16, 3), np.uint8)) == [{"ok": 1.0}]
    finally:
        mb.close()


def test_rss_watchdog_trips_and_recycles(monkeypatch):
    import tpupose_torch.serve as serve_mod

    now = rss_mb()
    assert now is not None and now > 10.0
    wd = RssWatchdog(limit_mb=now * 100, interval_s=0.01)
    wd.start()
    assert not wd.tripped.wait(timeout=0.2)
    wd.stop()
    wd = RssWatchdog(limit_mb=1.0, interval_s=0.01)
    wd.start()
    assert wd.tripped.wait(timeout=5.0)
    assert wd.last_mb is not None and wd.last_mb > 1.0

    shutdown, closed = [], []

    class FakeBatcher:
        def close(self):
            closed.append(True)

    class FakeServer:
        batcher = FakeBatcher()

        def shutdown(self):
            shutdown.append(True)

    class QuickWatchdog(RssWatchdog):       # samples every 10 ms, not every 5 s
        def __init__(self, limit_mb):
            super().__init__(limit_mb, interval_s=0.01)

    monkeypatch.setattr(serve_mod, "RssWatchdog", QuickWatchdog)
    assert _run_until_exit(FakeServer(), max_rss_mb=1.0) == 3
    assert shutdown == [True] and closed == [True]


def test_warmup_covers_every_batcher_geometry():
    calls = []

    class Recording:
        def process_batch(self, imgs, scales=None, valid_hw=None):
            calls.append((imgs.shape, valid_hw is not None))
            return [[] for _ in range(len(imgs))]

    est = Recording()
    buckets = ((64, 64), (64, 96))
    assert warmup_estimator(est, buckets, max_batch=6) == 8   # 1, 2, 4, 8 per bucket
    warmed = set(calls)
    assert ((8, 64, 96, 3), True) in warmed and ((1, 64, 64, 3), True) in warmed
    calls.clear()
    mb = MicroBatcher(est, max_batch=6, window_ms=1.0, buckets=buckets)
    try:
        rng = np.random.default_rng(0)
        for h, w in [(40, 60), (64, 64), (30, 90), (64, 96), (17, 23)]:
            mb.submit((rng.random((h, w, 3)) * 255).astype(np.uint8))
    finally:
        mb.close()
    assert calls
    for key in calls:
        assert key in warmed, f"cold geometry after warmup: {key}"


def test_warmup_without_buckets_is_a_noop():
    class Boom:
        def process_batch(self, *a, **k):
            raise AssertionError("must not be called")

    assert warmup_estimator(Boom(), None) == 0
    assert warmup_estimator(Boom(), ()) == 0


# --- request decoding ---------------------------------------------------------------------------
def _row_filters(data: bytes) -> list:
    """The filter type of every row of an 8-bit non-interlaced PNG, in order."""
    pos, idat = 8, []
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            w, h, _, colour = struct.unpack(">IIBB", chunk[:10])
        elif kind == b"IDAT":
            idat.append(chunk)
    raw = zlib.decompress(b"".join(idat))
    stride = w * {0: 1, 2: 3, 4: 2, 6: 4}[colour] + 1
    return [raw[y * stride] for y in range(h)]


def test_decode_png_is_bit_equal_to_cv2_over_all_five_filters():
    import cv2
    from PIL import Image

    rng = np.random.default_rng(0)
    filters = set()
    cases = 0
    for mode, ch in (("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)):
        yy, xx = np.mgrid[0:37, 0:53]
        ramp = ((yy * 3 + xx * 2)[..., None] + np.arange(ch) * 20) % 256
        noise = rng.integers(0, 256, (37, 53, ch))
        img = np.where((yy < 18)[..., None], ramp, noise).astype(np.uint8)
        arr = img[..., 0] if ch == 1 else img
        for level in (0, 1, 6, 9):
            bodies = []
            if ch != 2:     # cv2 writes no gray + alpha
                ok, enc = cv2.imencode(".png", arr, [cv2.IMWRITE_PNG_COMPRESSION, level])
                assert ok
                bodies.append(enc.tobytes())
            buf = io.BytesIO()
            Image.fromarray(arr, mode).save(buf, format="PNG", compress_level=level)
            bodies.append(buf.getvalue())
            for data in bodies:
                got = _decode_png(data)
                want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
                assert got.dtype == np.uint8 and got.shape == want.shape == (37, 53, 3)
                assert np.array_equal(got, want), (mode, level)
                filters |= set(_row_filters(data))
                cases += 1
    assert filters == {0, 1, 2, 3, 4} and cases == 28


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
def test_png_bytes_round_trips_through_both_decoders(filters):
    """testing.png_bytes (the card script's request encoder) writes PNGs
    that cv2 and _decode_png read back as the image."""
    import cv2

    from tpupose_torch.testing import png_bytes

    img = np.random.default_rng(3).integers(0, 256, (21, 34, 3)).astype(np.uint8)
    data = png_bytes(img, filters, level=6)
    assert set(_row_filters(data)) == set(filters)
    assert np.array_equal(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR), img)
    assert np.array_equal(_decode_png(data), img)


def test_decode_png_refuses_broken_and_oversized_pngs():
    from tpupose_torch.serve import UndecodableImage
    from tpupose_torch.testing import png_bytes

    data = png_bytes(np.zeros((6, 7, 3), np.uint8))
    for broken in (data[:40], data[:33] + b"\x00" * 30, data.replace(b"IDAT", b"IDAX")):
        with pytest.raises(UndecodableImage, match="cannot decode image"):
            _decode_png(broken)
    # a header of 2^16 x 2^16 pixels over a tiny body: refused before inflating
    huge = data[:16] + struct.pack(">II", 1 << 16, 1 << 16) + data[24:]
    with pytest.raises(UndecodableImage, match="exceeds"):
        _decode_png(huge)


def test_decode_png_hands_other_kinds_to_cv2():
    import cv2
    from PIL import Image

    img = np.random.default_rng(1).integers(0, 256, (9, 11, 3)).astype(np.uint8)
    ok, jpg = cv2.imencode(".jpg", img)
    assert _decode_png(jpg.tobytes()) is None
    buf = io.BytesIO()
    Image.fromarray(img).convert("P").save(buf, format="PNG")      # palette
    assert _decode_png(buf.getvalue()) is None
    ok, deep = cv2.imencode(".png", img.astype(np.uint16) * 257)    # 16-bit
    assert _decode_png(deep.tobytes()) is None


@pytest.fixture
def no_cv2(monkeypatch):
    real_import = builtins.__import__

    def guarded(name, *args, **kwargs):
        if name == "cv2" or name.startswith("cv2."):
            raise ImportError("No module named 'cv2'")
        return real_import(name, *args, **kwargs)

    monkeypatch.delitem(sys.modules, "cv2", raising=False)
    monkeypatch.setattr(builtins, "__import__", guarded)


def test_without_cv2_a_jpeg_gets_400_naming_cv2_and_a_png_decodes(fake_server, no_cv2):
    from PIL import Image

    img = np.random.default_rng(2).integers(0, 256, (20, 24, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    status, body, _ = post(fake_server, buf.getvalue())
    assert status == 400
    assert "cannot decode image" in body["error"] and "cv2" in body["error"]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    status, body, _ = post(fake_server, buf.getvalue())
    assert status == 200 and body == {"people": []}
    assert np.array_equal(_decode_png(buf.getvalue()), img[..., ::-1])


def test_without_cv2_the_python_row_loop_takes_only_small_paeth_bodies(fake_server, no_cv2,
                                                                        monkeypatch):
    """Without cv2, a 720x1280 frame of Paeth rows is refused with a 400
    that names cv2 before the row loop starts; a 368x368 one (406,272 bytes
    of Paeth rows, under the 2^19 allowed) is decoded by it."""
    import tpupose_torch.serve as serve_mod

    rows = []
    real = serve_mod._unfilter

    def counted(raw, h, stride, bpp):
        rows.append(h)
        return real(raw, h, stride, bpp)

    monkeypatch.setattr(serve_mod, "_unfilter", counted)
    status, body, _ = post(fake_server, _paeth_frame(720, 1280)[1])
    assert status == 400 and "Average/Paeth" in body["error"] and "cv2" in body["error"]
    assert rows == []
    img, data = _paeth_frame(368, 368)
    assert post(fake_server, data)[:2] == (200, {"people": []})
    assert rows == [368]
    assert np.array_equal(serve_mod.decode_image(data), img)


def test_png_bytes_adaptive_chooses_the_row_filters_libpng_chooses():
    """png_bytes(filters="adaptive") (the card script's request encoder)
    picks, row for row, the filters cv2's libpng writes at a compression
    level, on noise, a ramp and a smooth image: mixed, Paeth among them."""
    import cv2

    from tpupose_torch.testing import png_bytes

    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:48, 0:64]
    smooth = 128 + 60 * np.sin(xx / 13.0) * np.cos(yy / 7.0)
    images = (rng.integers(0, 256, (48, 64, 3)),
              ((yy * 3 + xx * 2)[..., None] + np.arange(3) * 20) % 256,
              np.clip(smooth[..., None] + rng.normal(0, 4, (48, 64, 3)), 0, 255))
    seen = set()
    for img in images:
        img = img.astype(np.uint8)
        ok, enc = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_COMPRESSION, 6])
        data = png_bytes(img, "adaptive", level=6)
        assert _row_filters(data) == _row_filters(enc.tobytes())
        assert np.array_equal(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR), img)
        seen |= set(_row_filters(data))
    assert {0, 1, 2, 3, 4} <= seen


def _paeth_frame(h: int, w: int) -> tuple[np.ndarray, bytes]:
    from tpupose_torch.testing import png_bytes

    yy, xx = np.mgrid[0:h, 0:w]
    img = (((yy // 3 + xx // 5)[..., None] + np.arange(3) * 40) % 256).astype(np.uint8)
    return img, png_bytes(img, filters=(4,), level=6)


def test_large_paeth_body_is_decoded_by_cv2_beside_a_concurrent_request(fake_server, monkeypatch):
    """With cv2 importable, a 720x1280 frame of Paeth rows (2.76 MB of them,
    seconds of the Python row loop) is decoded by cv2.imdecode: the loop
    never runs, and the frame and a small request sent beside it are both
    answered within seconds."""
    import tpupose_torch.serve as serve_mod

    def python_row_loop(*args):
        raise AssertionError("the Python row filters ran")

    monkeypatch.setattr(serve_mod, "_unfilter", python_row_loop)
    img, body = _paeth_frame(720, 1280)
    assert set(_row_filters(body)) == {4}
    assert np.array_equal(serve_mod.decode_image(body), img)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        t0 = time.perf_counter()
        large = pool.submit(post, fake_server, body)
        small = pool.submit(post, fake_server, png(np.zeros((20, 24, 3), np.uint8)))
        assert small.result()[:2] == (200, {"people": []})
        assert large.result()[:2] == (200, {"people": []})
        assert time.perf_counter() - t0 < 5.0
