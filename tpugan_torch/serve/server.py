"""Serving: micro-batched, seeded image generation over HTTP (port of
``tpugan/serve/server.py``).

- ``BatchingEngine``: a queue + worker thread that coalesces concurrent
  requests into one device batch (padded to power-of-two buckets), then
  scatters results back to per-request futures.
- ``make_server`` / ``serve_forever``: a stdlib ThreadingHTTPServer exposing
  ``GET /healthz`` (liveness + engine stats), ``GET /metrics`` and
  ``POST /sample`` (JSON body: n / seed / labels / format png|npy / nrow).

The engine serves any generator with the ``Sampler`` surface (``nz``,
``n_classes``, ``image_size``, ``channels``, ``conditional``,
``generate(z, y)``); requests use the sampler's seeded-noise contract, so a
served image equals ``Sampler.sample`` for the same seed.
"""

from __future__ import annotations

import collections
import io
import json
import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from tpugan_torch.sample.sampler import seeded_labels, seeded_noise
from tpugan_torch.utils.images import encode_png, make_grid, to_uint8


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class EngineOverloadedError(RuntimeError):
    """Raised by submit() when the request queue is full (backpressure);
    the HTTP layer maps it to a fast 503 instead of queueing unboundedly."""


# Per-request response-buffer budget: POST /sample concatenates the result
# in the handler thread and npy-encoding makes a second copy, so the real
# per-request footprint is ~2x this.  ThreadingHTTPServer handles requests
# concurrently — the cap is what keeps a handful of big npy requests from
# OOMing the serving host.
MAX_RESPONSE_MB = 512


class BatchingEngine:
    """Coalesce concurrent generation requests into padded device batches."""

    def __init__(self, gen, max_batch: int = 64,
                 linger_ms: float = 2.0, queue_depth: int = 256,
                 request_timeout_s: float = 120.0):
        self.gen = gen
        self.max_batch = int(max_batch)
        self.linger_s = float(linger_ms) / 1e3
        self.request_timeout_s = float(request_timeout_s)
        # Bounded: under sustained overload requests shed with a fast
        # EngineOverloadedError (HTTP 503) instead of piling up in RAM.
        self._q: "queue.Queue" = queue.Queue(maxsize=int(queue_depth))
        self._carry = None  # worker-only: item deferred to the next batch
        self._stop = threading.Event()
        self.stats = {"requests": 0, "images": 0, "batches": 0,
                      "padded_images": 0}
        # last-1000 per-batch device latencies; the worker appends while
        # HTTP handler threads snapshot, so guard both with a lock (deque
        # iteration during mutation raises RuntimeError)
        self._latencies_ms = collections.deque(maxlen=1000)
        self._lat_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="tpugan-torch-batcher")
        self._worker.start()

    def submit(self, z: np.ndarray, y: Optional[np.ndarray] = None
               ) -> "Future[np.ndarray]":
        """Request images for explicit latents (and labels). Thread-safe.

        Validated here, before enqueueing, so one malformed request can
        never poison co-batched requests; larger-than-max_batch requests
        are split into max_batch chunks and transparently reassembled.
        """
        with self._lat_lock:
            # one client request, however many chunks it splits into
            # (the worker counts batches/images; counting chunks here
            # over-reported 'requests' 64x for an n=4096 call)
            self.stats["requests"] += 1
        z = np.asarray(z, np.float32)
        if z.ndim != 2 or z.shape[1] != self.gen.nz:
            raise ValueError(
                f"latents must be (n, {self.gen.nz}), got {z.shape}")
        if self.gen.conditional:
            if y is None:
                raise ValueError("conditional model: labels required")
            y = np.asarray(y, np.int32)
            if y.shape != (z.shape[0],):
                raise ValueError(
                    f"labels must be ({z.shape[0]},), got {y.shape}")
        elif y is not None:
            raise ValueError("unconditional model: labels not accepted")
        n = z.shape[0]
        if n <= self.max_batch:
            return self._enqueue(z, y)
        chunks = [(z[i:i + self.max_batch],
                   None if y is None else y[i:i + self.max_batch])
                  for i in range(0, n, self.max_batch)]
        futs = []
        try:
            for zc, yc in chunks:
                futs.append(self._enqueue(zc, yc))
        except EngineOverloadedError:
            # Shed the WHOLE request: cancel already-enqueued chunks (the
            # worker skips done futures) so a 503'd oversized request does
            # not leave partial device work queued — retries would
            # otherwise amplify load instead of shedding it.
            for f in futs:
                try:
                    if not f.done():
                        f.set_exception(EngineOverloadedError(
                            "request shed (queue filled mid-request)"))
                except Exception:
                    pass  # worker completed it in the race window — fine
            raise
        outer: "Future[np.ndarray]" = Future()

        # add_done_callback runs INLINE in the submitting thread when the
        # future already completed, so two threads can race here; the last
        # decrement of the lock-guarded counter finishes outer exactly once.
        remaining = [len(futs)]
        finish_lock = threading.Lock()

        def _maybe_finish(_):
            with finish_lock:
                remaining[0] -= 1
                if remaining[0] > 0:
                    return
            errs = [f.exception() for f in futs if f.exception()]
            if errs:
                outer.set_exception(errs[0])
            else:
                outer.set_result(
                    np.concatenate([f.result() for f in futs], axis=0))

        for f in futs:
            f.add_done_callback(_maybe_finish)
        outer._tpugan_chunks = futs  # lets shed() cancel the queued work
        return outer

    def _enqueue(self, z: np.ndarray, y: Optional[np.ndarray]
                 ) -> "Future[np.ndarray]":
        if self._stop.is_set():
            raise RuntimeError("engine closed")
        fut: "Future[np.ndarray]" = Future()
        try:
            self._q.put_nowait((z, y, fut))
        except queue.Full:
            raise EngineOverloadedError(
                f"request queue full ({self._q.maxsize} pending)") from None
        if self._stop.is_set() and not fut.done():
            # close() may have drained the queue between our _stop check and
            # the put — fail fast rather than letting the request dangle
            # until its timeout (the worker tolerates already-done futures).
            try:
                fut.set_exception(RuntimeError("engine closed"))
            except Exception:
                pass  # worker resolved it concurrently — fine
        return fut

    def sample(self, n: int, seed: int = 0,
               labels=None) -> "Future[np.ndarray]":
        """Seeded request — same (seed, index) contract as the Sampler."""
        z = np.asarray(seeded_noise(self.gen.nz, n, seed))
        y = None
        if self.gen.conditional:
            y = (np.asarray(labels, np.int32) if labels is not None else
                 np.asarray(seeded_labels(self.gen.n_classes, n, seed)))
        return self.submit(z, y)

    def shed(self, fut: "Future", exc: Optional[Exception] = None) -> None:
        """Drop a timed-out/abandoned request: fail its future (and, for a
        chunked oversized request, every chunk future) so the worker skips
        the still-queued device work — _collect() discards done items.
        Without this, a client timeout leaves the work queued and retries
        ADD load instead of shedding it (unlike the 503 path)."""
        exc = exc or TimeoutError("request abandoned by caller")
        for f in getattr(fut, "_tpugan_chunks", [fut]):
            try:
                if not f.done():
                    f.set_exception(exc)
            except Exception:
                pass  # worker completed it in the race window — fine

    def latency_summary(self) -> dict:
        with self._lat_lock:
            lat = sorted(self._latencies_ms)
        if not lat:
            return {}
        q = lambda p: lat[min(int(p * len(lat)), len(lat) - 1)]  # noqa: E731
        return {"p50_ms": round(q(0.50), 2), "p90_ms": round(q(0.90), 2),
                "p99_ms": round(q(0.99), 2), "max_ms": round(lat[-1], 2)}

    def close(self) -> None:
        self._stop.set()
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass  # worker will see _stop after its current batch
        # A legal in-flight batch may run up to request_timeout_s — wait at
        # least that long before declaring the worker stuck and failing
        # leftovers (the scatter path tolerates the residual race anyway).
        self._worker.join(timeout=max(30.0, self.request_timeout_s + 10.0))
        # Fail any request the worker never got to (still queued, or parked
        # in _carry) so its HTTP thread errors out fast instead of blocking
        # until the future timeout.
        leftovers = [] if self._carry is None else [self._carry]
        self._carry = None
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                leftovers.append(item)
        for _, _, fut in leftovers:
            try:
                if not fut.done():
                    fut.set_exception(RuntimeError("engine closed"))
            except Exception:
                pass  # racing _enqueue's own fail-fast — already resolved

    # -- worker -------------------------------------------------------------

    def _collect(self):
        """Block for the first item, then linger briefly for co-travelers.

        The device batch never exceeds ``max_batch`` (submit() pre-chunks
        oversized requests to at most max_batch each): an item that would
        overshoot is carried over to lead the next batch.
        """
        while True:
            first = self._carry or self._q.get()
            self._carry = None
            if first is None:
                return None
            if not first[2].done():  # skip cancelled/shed requests
                break
        items = [first]
        total = first[0].shape[0]
        deadline = time.monotonic() + self.linger_s
        while total < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if item is None:
                try:  # re-signal stop after this batch (best-effort: _stop
                    self._q.put_nowait(None)  # is already set by close())
                except queue.Full:
                    pass
                break
            if item[2].done():  # cancelled/shed while queued
                continue
            if total + item[0].shape[0] > self.max_batch:
                self._carry = item
                break
            items.append(item)
            total += item[0].shape[0]
        return items

    def _run(self) -> None:
        while not self._stop.is_set():
            items = self._collect()
            if items is None:
                return
            try:
                zs = np.concatenate([z for z, _, _ in items], axis=0)
                ys = None
                if self.gen.conditional:
                    ys = np.concatenate([y for _, y, _ in items], axis=0)
                n = zs.shape[0]
                # pad up to the next power of two (<= _next_pow2(max_batch))
                # so the device sees O(log max_batch) distinct batch shapes
                bucket = _next_pow2(n)
                if bucket > n:
                    zs = np.concatenate(
                        [zs, np.zeros((bucket - n, zs.shape[1]),
                                      np.float32)])
                    if ys is not None:
                        ys = np.concatenate(
                            [ys, np.zeros((bucket - n,), np.int32)])
                t0 = time.monotonic()
                imgs = self.gen.generate(zs, ys)[:n]
                with self._lat_lock:
                    self._latencies_ms.append(
                        (time.monotonic() - t0) * 1e3)
            except Exception as e:
                # fail only this batch; the worker must survive anything
                for _, _, fut in items:
                    try:
                        if not fut.done():
                            fut.set_exception(e)
                    except Exception:
                        pass
                continue
            self.stats["batches"] += 1
            self.stats["images"] += n
            self.stats["padded_images"] += bucket - n
            off = 0
            for z, _, fut in items:
                k = z.shape[0]
                try:
                    fut.set_result(imgs[off:off + k])
                except Exception:
                    pass  # request failed/cancelled concurrently (e.g. a
                    # close() that gave up on a long batch) — never let a
                    # future race kill the worker
                off += k


class _Handler(BaseHTTPRequestHandler):
    engine: BatchingEngine = None  # set by make_server
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _reply(self, code: int, body: bytes, ctype: str,
               extra_headers=None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj, extra_headers=None) -> None:
        self._reply(code, json.dumps(obj).encode(), "application/json",
                    extra_headers)

    def do_GET(self):
        if self.path == "/healthz":
            g = self.engine.gen
            self._reply_json(200, {
                "ok": True,
                "model": {"nz": g.nz, "image_size": g.image_size,
                          "channels": g.channels,
                          "conditional": g.conditional},
                "stats": dict(self.engine.stats),
                "latency": self.engine.latency_summary(),
            })
        elif self.path == "/metrics":
            st = self.engine.stats
            lat = self.engine.latency_summary()
            lines = [f"tpugan_{k} {v}" for k, v in st.items()]
            lines += [f"tpugan_batch_latency_{k.replace('_ms', '')}_ms {v}"
                      for k, v in lat.items()]
            self._reply(200, ("\n".join(lines) + "\n").encode(),
                        "text/plain; version=0.0.4")
        else:
            self._reply_json(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        if self.path != "/sample":
            self._reply_json(404, {"error": f"no route {self.path}"})
            return
        # Validate the whole request BEFORE any device work so malformed
        # requests cost nothing; backend failures are 500s, not 400s.
        try:
            length = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(length) or b"{}")
            n = int(req.get("n", 1))
            g = self.engine.gen
            # flat-4096 allowed ~6.5 GB of response buffers per request at
            # 256px; cap by response size so concurrent handler threads
            # can't OOM the serving host (queue_depth only bounds pending
            # latents, not response buffers)
            budget = MAX_RESPONSE_MB * (1 << 20)
            n_cap = min(4096, max(1, budget // (
                g.image_size * g.image_size * g.channels * 4)))
            if not 1 <= n <= n_cap:
                raise ValueError(
                    f"n out of range: {n} (max {n_cap} at "
                    f"{g.image_size}px; {MAX_RESPONSE_MB} MB response cap)")
            seed = int(req.get("seed", 0))
            labels = req.get("labels")
            if labels is not None:
                if not self.engine.gen.conditional:
                    raise ValueError("unconditional model: labels not "
                                     "accepted")
                if len(labels) != n:
                    raise ValueError(f"labels length {len(labels)} != n {n}")
                labels = [int(v) for v in labels]  # non-numeric -> 400 here
                n_classes = self.engine.gen.n_classes
                bad = [v for v in labels if not 0 <= v < n_classes]
                if bad:
                    raise ValueError(
                        f"labels out of range [0, {n_classes}): {bad[:5]}")
            fmt = req.get("format", "png")
            if fmt not in ("png", "npy"):
                raise ValueError(f"unknown format {fmt!r}")
            nrow = int(req.get("nrow", 8))
            if nrow < 1:
                raise ValueError(f"nrow must be >= 1, got {nrow}")
        except Exception as e:
            self._reply_json(400, {"error": f"{type(e).__name__}: {e}"})
            return
        fut = None
        try:
            fut = self.engine.sample(n, seed, labels)
            imgs = fut.result(timeout=self.engine.request_timeout_s)
        except EngineOverloadedError as e:
            self._reply_json(503, {"error": str(e)},
                             extra_headers={"Retry-After": "1"})
            return
        except (TimeoutError, FuturesTimeoutError):
            # Shed, don't abandon: fail the queued future(s) so the worker
            # drops the device work — otherwise a retrying client's
            # timeouts pile load on instead of shedding it.
            self.engine.shed(fut)
            self._reply_json(504, {"error": "request timed out after "
                                   f"{self.engine.request_timeout_s}s"})
            return
        except Exception as e:
            self._reply_json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        if fmt == "npy":
            buf = io.BytesIO()
            np.save(buf, imgs)
            self._reply(200, buf.getvalue(), "application/octet-stream")
        else:  # png (fmt pre-validated above)
            grid = make_grid(to_uint8(imgs), nrow=min(nrow, n))
            self._reply(200, encode_png(grid), "image/png")


def make_server(engine: BatchingEngine, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server; ``port=0`` picks a free
    port (``server.server_address[1]`` has the real one)."""
    handler = type("BoundHandler", (_Handler,), {"engine": engine})
    return ThreadingHTTPServer((host, port), handler)


def serve_forever(engine: BatchingEngine, host: str = "0.0.0.0",
                  port: int = 8000) -> None:
    """Run until SIGTERM/SIGINT, then drain: stop accepting, finish
    in-flight batches, close the engine — the production shutdown path."""
    import signal

    srv = make_server(engine, host, port)
    print(f"tpugan_torch serving on http://{host}:{srv.server_address[1]} "
          f"(POST /sample, GET /healthz, GET /metrics)")

    def _shutdown(signum, frame):
        # shutdown() blocks until serve_forever returns — call it from a
        # helper thread, not the signal handler's (main) thread
        threading.Thread(target=srv.shutdown, daemon=True).start()

    prev = {s: signal.signal(s, _shutdown)
            for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        srv.serve_forever()
        print("tpugan_torch server draining...")
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
        srv.server_close()
        engine.close()
