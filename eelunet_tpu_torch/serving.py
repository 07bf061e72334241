"""Online inference serving: dynamic micro-batching over the Predictor
(counterpart of ``eelunet_tpu/serving.py``, ported nearly verbatim: the
batcher and the HTTP layer are numpy and threads).

Concurrent requests coalesce into device batches that ride the Predictor's
batch buckets, images travel host->device as uint8 (4x fewer bytes than
float32), and one lock serialises every entry to the device: the batcher's
worker thread and the HTTP threads that run pre-batched requests directly.
The Predictor's ``collect`` is the only place that waits for the device.

Wire protocol (eelunet_tpu_torch.cli.serve):
  POST /v1/predict  body = .npy bytes, uint8/float (H,W,3) or (B,H,W,3)
                    -> .npy float32 probabilities (B,H,W,1), or binary
                       masks with ?output=mask (mask batches threshold ON
                       DEVICE and ship a uint8 wire — 4x fewer readback
                       bytes)
  POST /v1/predict  body = PNG/JPEG (any PIL format) -> L-mode PNG mask
                    {0,255}, resized like the folder dataset (BILINEAR);
                    with --tile, the mask comes back at the image's NATIVE
                    resolution (fixed-shape sliding windows, no resize)
  GET  /v1/healthz  -> {"status": "ok", "model": ..., "image_size": ...}
  GET  /v1/stats    -> batching counters (requests, batches, avg_batch) and
                       the CUDA kernels' launch counts since start
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from eelunet_tpu_torch.ops.fft_cuda import LAUNCHES


class Overloaded(RuntimeError):
    """Raised when the server sheds a request because the pending-work bound
    (``max_pending``) is reached — mapped to HTTP 503 + Retry-After."""


class DeadlineExceeded(RuntimeError):
    """Raised when a request's deadline expires while it is still queued
    (never after its batch has started) — mapped to HTTP 504."""


class MicroBatcher:
    """Coalesces concurrent single-image requests into device batches.

    One worker thread drains a queue: it blocks for the first item, then
    gathers more until ``max_batch`` items are pending or ``window_ms`` has
    elapsed since the first, stacks them, and runs one forward. Under load
    the window never idles (the queue already holds items); a lone request
    pays at most the window latency.
    """

    def __init__(self, run_batch, max_batch: int = 16, window_ms: float = 5.0,
                 run_batch_mask=None, dispatch_batch=None,
                 dispatch_batch_mask=None, collect=None,
                 max_pending: int = 0):
        # ``run_batch_mask``: optional uint8-wire mask program
        # (Predictor.predict_mask_wire) — used for a coalesced batch when
        # EVERY queued request wants a mask, cutting the device->host
        # readback 4x.
        #
        # ``dispatch_batch``/``dispatch_batch_mask``/``collect``: optional
        # two-phase forms of the same programs (Predictor.dispatch_proba /
        # dispatch_mask_wire / collect). When provided, the worker runs
        # DOUBLE-BUFFERED: it dispatches batch N+1 (async H2D + compute)
        # before forcing batch N's readback, overlapping transfers with
        # compute.
        self._run = run_batch
        self._run_mask = run_batch_mask
        self._dispatch = dispatch_batch
        self._dispatch_mask = dispatch_batch_mask
        self._collect = collect
        self.max_batch = int(max_batch)
        self.window_s = float(window_ms) / 1e3
        # Backpressure: ``max_pending`` bounds TOTAL admitted-but-unfinished
        # work — coalesce-queue depth plus direct jobs waiting on the device
        # lock. 0 = unbounded (library default; cli.serve sets a real bound).
        # Beyond the bound, submit()/run_exclusive raise Overloaded and the
        # HTTP layer sheds with 503 + Retry-After instead of letting queue
        # memory and tail latency grow without limit.
        self.max_pending = int(max_pending)
        self._pending_lock = threading.Lock()
        self._direct_waiting = 0
        self.shed = 0      # requests rejected at the admission bound
        self.expired = 0   # requests whose deadline passed while queued
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._submit_lock = threading.Lock()
        # Serializes every device entry — the worker's coalesced batches AND
        # run_direct calls from HTTP handler threads, so CUDA work is only
        # ever enqueued by one thread at a time.
        self._device_lock = threading.Lock()
        self.requests = 0
        self.batches = 0
        self.batched_items = 0
        # Bounded tail-latency samples: per-request wall latency (enqueue ->
        # result set) and per-batch device time. Ring buffers so a long-lived
        # server reports RECENT percentiles, not lifetime averages.
        self.latency_ms: "deque" = deque(maxlen=2048)
        self.device_ms: "deque" = deque(maxlen=2048)
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def _admit(self, items: int = 1):
        """Admission control: raise Overloaded if accepting ``items`` more
        units of pending work would exceed ``max_pending`` (queued singles +
        direct jobs waiting on the device). Caller must hold _pending_lock."""
        existing = self._q.qsize() + self._direct_waiting
        # A lone oversized batch (items > max_pending on an idle server) is
        # still admitted — the bound limits GROWTH of pending work, it is not
        # a max request size.
        if self.max_pending and existing and existing + items > self.max_pending:
            self.shed += items
            raise Overloaded(
                f"server overloaded: {existing} pending + {items} new > "
                f"max_pending={self.max_pending}"
            )

    def submit(self, image: np.ndarray, want: str = "proba",
               deadline_s: Optional[float] = None) -> Future:
        """Enqueue one image; the Future resolves to ``(kind, row)`` where
        ``kind`` is "proba" (float probabilities) or "mask" (uint8 mask —
        only when want="mask" and the whole coalesced batch wanted masks).

        Raises Overloaded when the pending bound is hit. ``deadline_s``
        (relative) fails the Future with DeadlineExceeded if the request is
        still queued when it expires; once its batch starts it always runs."""
        fut: Future = Future()
        with self._submit_lock:
            if self._stop.is_set():
                fut.set_exception(RuntimeError("MicroBatcher is stopped"))
                return fut
            with self._pending_lock:
                self._admit()
                now = time.monotonic()
                deadline = now + deadline_s if deadline_s else None
                self._q.put((image, fut, now, want, deadline))
        return fut

    def run_direct(self, batch: np.ndarray,
                   deadline_s: Optional[float] = None) -> np.ndarray:
        """Run a pre-assembled batch under the device lock (bypasses
        coalescing but not the single-device-owner invariant)."""
        return self.run_exclusive(lambda: self._run(batch),
                                  items=int(batch.shape[0]),
                                  deadline_s=deadline_s)

    def run_exclusive(self, thunk, items: int = 1,
                      deadline_s: Optional[float] = None,
                      record: bool = True):
        """Run an arbitrary device job under the device lock with the same
        accounting as coalesced batches — /v1/stats must cover ALL traffic
        (pre-batched npy, float singles, and tiled native-resolution jobs
        route through here). Direct jobs count toward ``max_pending`` while
        they wait for the device; an expired ``deadline_s`` fails the job
        with DeadlineExceeded if the wait outlived it. ``record=False`` for
        admin jobs (weight hot-swap) that must not skew the request/batch/
        latency counters."""
        with self._pending_lock:
            self._admit(items)
            self._direct_waiting += items
        t0 = time.monotonic()
        deadline = t0 + deadline_s if deadline_s else None
        try:
            with self._device_lock:
                if deadline is not None and time.monotonic() > deadline:
                    self.expired += items
                    raise DeadlineExceeded(
                        f"deadline expired after {deadline_s * 1e3:.0f} ms "
                        "waiting for the device"
                    )
                td = time.monotonic()
                out = thunk()
        finally:
            with self._pending_lock:
                self._direct_waiting -= items
        if record:
            now = time.monotonic()
            self.requests += int(items)
            self.batches += 1
            self.batched_items += int(items)
            self.device_ms.append((now - td) * 1e3)
            self.latency_ms.append((now - t0) * 1e3)
        return out

    def stop(self):
        with self._submit_lock:
            self._stop.set()
        self._worker.join(timeout=5)
        # Fail anything still queued — otherwise waiters block forever in
        # Future.result() (submit() rejects new work once _stop is set).
        while True:
            try:
                _, fut, _, _, _ = self._q.get_nowait()
            except queue.Empty:
                break
            fut.set_exception(RuntimeError("MicroBatcher stopped before request ran"))

    def _resolve(self, batch):
        """Force a dispatched batch's readback and resolve its futures.
        Caller must hold the device lock."""
        kind, handle, items, td = batch
        try:
            out = self._collect(handle)
            now = time.monotonic()
            self.device_ms.append((now - td) * 1e3)
            for (_, f, t0, _, _), i in zip(items, range(len(items))):
                self.latency_ms.append((now - t0) * 1e3)
                f.set_result((kind, out[i]))
        except Exception as e:
            for _, f, _, _, _ in items:
                f.set_exception(e)

    def _expire(self, item) -> bool:
        """Fail a queued item whose deadline has passed; True if expired."""
        _, fut, _, _, dl = item
        if dl is not None and time.monotonic() > dl:
            self.expired += 1
            fut.set_exception(DeadlineExceeded(
                "deadline expired while queued"))
            return True
        return False

    def _loop(self):
        pipelined = self._dispatch is not None and self._collect is not None
        pending = None  # dispatched-but-uncollected batch (pipelined mode)
        while not self._stop.is_set():
            try:
                # With a batch in flight, only linger briefly for new work
                # before forcing its readback — a lone request must not wait
                # out the full idle poll for its result.
                first = self._q.get(timeout=0.002 if pending else 0.05)
            except queue.Empty:
                if pending is not None:
                    with self._device_lock:
                        self._resolve(pending)
                    pending = None
                continue
            if self._expire(first):
                continue
            items = [first]
            window_end = time.monotonic() + self.window_s
            while len(items) < self.max_batch:
                left = window_end - time.monotonic()
                if left <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if not self._expire(nxt):
                    items.append(nxt)
            images = [im for im, _, _, _, _ in items]
            futs = [f for _, f, _, _, _ in items]
            # uint8 mask wire iff every request in THIS batch wants a mask
            # (mixed batches run the proba program; mask requesters then
            # threshold on host — same values, just more readback bytes).
            use_mask = self._run_mask is not None and all(
                w == "mask" for _, _, _, w, _ in items
            )
            self.requests += len(items)
            self.batches += 1
            self.batched_items += len(items)
            kind = "mask" if use_mask else "proba"
            try:
                td = time.monotonic()
                with self._device_lock:
                    if pipelined and not (
                        use_mask and self._dispatch_mask is None
                    ):
                        handle = (
                            self._dispatch_mask if use_mask else self._dispatch
                        )(np.stack(images))
                        if pending is not None:
                            # batch N's readback overlaps batch N+1's
                            # (already dispatched) H2D + compute
                            self._resolve(pending)
                        pending = (kind, handle, items, td)
                        continue
                    out = (self._run_mask if use_mask else self._run)(
                        np.stack(images)
                    )
                now = time.monotonic()
                self.device_ms.append((now - td) * 1e3)
                for (_, f, t0, _, _), i in zip(items, range(len(items))):
                    self.latency_ms.append((now - t0) * 1e3)
                    f.set_result((kind, out[i]))
            except Exception as e:  # propagate to every waiter in the batch
                for f in futs:
                    f.set_exception(e)
        if pending is not None:  # stop() mid-flight: never strand waiters
            with self._device_lock:
                self._resolve(pending)


class SegmentationService:
    """Predictor + micro-batcher + input decoding at a fixed serving size."""

    def __init__(
        self,
        predictor,
        image_size: Tuple[int, int],
        max_batch: int = 16,
        window_ms: float = 5.0,
        threshold: Optional[float] = None,
        tile: int = 0,
        tile_overlap: int = 64,
        max_pending: int = 0,
        deadline_ms: float = 0.0,
    ):
        # ``predictor`` is anything with predict_proba(batch)->probs
        # (inference.Predictor). Normalization happens inside the predictor,
        # on the device, never here.
        self.predictor = predictor
        self.image_size = tuple(image_size)
        # tile > 0: NATIVE-resolution serving — inputs keep their original
        # size and run as fixed-shape sliding windows
        # (Predictor.predict_proba_tiled); image_size then only names the
        # model's training scale in /v1/healthz.
        self.tile = int(tile)
        self.tile_overlap = int(tile_overlap)
        # Server-wide default deadline (0 = none); per-request override via
        # ?deadline_ms=. Converted to relative seconds at request entry.
        self.deadline_ms = float(deadline_ms)
        if self.tile and not hasattr(predictor, "predict_proba_tiled"):
            raise ValueError(
                "tiled serving needs a predictor with predict_proba_tiled"
            )
        self.threshold = (
            threshold if threshold is not None
            else getattr(predictor, "threshold", 0.5)
        )
        self._n_classes = int(getattr(predictor, "out_channels", 1) or 1)
        # Mask requests (PNG responses, ?output=mask) run a device-side
        # threshold/argmax program with a uint8 wire when the predictor
        # supports it (others fall back to host thresholding).
        mask_wire = getattr(predictor, "predict_mask_wire", None)
        run_mask = (
            (lambda batch: mask_wire(batch, threshold=self.threshold))
            if mask_wire is not None else None
        )
        # Two-phase dispatch/collect (double-buffered batcher) when the
        # predictor supports it; others run the plain synchronous path.
        two_phase = all(
            hasattr(predictor, a)
            for a in ("dispatch_proba", "dispatch_mask_wire", "collect")
        )
        self.batcher = MicroBatcher(
            predictor.predict_proba, max_batch=max_batch, window_ms=window_ms,
            run_batch_mask=run_mask,
            dispatch_batch=predictor.dispatch_proba if two_phase else None,
            dispatch_batch_mask=(
                (lambda batch: predictor.dispatch_mask_wire(
                    batch, threshold=self.threshold))
                if two_phase else None
            ),
            collect=predictor.collect if two_phase else None,
            max_pending=max_pending,
        )
        # Checkpoint hot-reload state (reload_checkpoint / POST /v1/reload).
        self._reload_lock = threading.Lock()
        self.reloads = 0
        self.loaded_checkpoint: Optional[str] = None

    def _deadline_s(self, deadline_ms: Optional[float]) -> Optional[float]:
        ms = self.deadline_ms if deadline_ms is None else float(deadline_ms)
        return (ms / 1e3) if ms > 0 else None

    def reload_checkpoint(self, checkpoint: str) -> dict:
        """Hot-swap the Predictor's weights from ``checkpoint`` WITHOUT
        dropping in-flight requests (the reference re-imports the model per
        run, test.py:82-86 — no online counterpart exists upstream).

        Two phases: ``Predictor.stage`` does all the slow work (disk IO,
        conversion, BN folding) off the serving path while traffic
        keeps flowing on the old weights; ``Predictor.commit`` uploads and
        swaps the model under the MicroBatcher's device lock, so no batch
        observes a half-swapped model. Batches dispatched before the swap
        hold references to the old weights and complete normally;
        every batch dispatched after serves the new weights."""
        if not hasattr(self.predictor, "stage"):
            raise ValueError(
                "hot reload needs a checkpoint-backed Predictor"
            )
        with self._reload_lock:  # serialize concurrent reload requests
            staged = self.predictor.stage(checkpoint)
            self.batcher.run_exclusive(
                lambda: self.predictor.commit(staged), items=0, record=False
            )
            self.reloads += 1
            self.loaded_checkpoint = checkpoint
        return {"status": "ok", "reloads": self.reloads,
                "checkpoint": checkpoint}

    def close(self):
        self.batcher.stop()

    # -- input handling -----------------------------------------------------

    def _check_array(self, arr: np.ndarray) -> np.ndarray:
        h, w = self.image_size
        if arr.ndim == 3:
            arr = arr[None]
        if arr.ndim != 4 or arr.shape[-1] != 3 or (
            not self.tile and arr.shape[1:] != (h, w, 3)
        ):
            # tiled mode accepts any (B,H,W,3) — windows are fixed-shape
            want = "(B,H,W,3) or (H,W,3)" if self.tile else (
                f"(B,{h},{w},3) or ({h},{w},3)"
            )
            raise ValueError(f"expected {want}, got {arr.shape}")
        if arr.dtype == np.uint8:
            return arr          # device-side scale+normalize (Predictor)
        if np.issubdtype(arr.dtype, np.floating):
            return arr.astype(np.float32)  # caller pre-normalized
        raise ValueError(f"expected uint8 or float array, got {arr.dtype}")

    def _decode_image(self, data: bytes) -> np.ndarray:
        from PIL import Image

        img = Image.open(io.BytesIO(data)).convert("RGB")
        if not self.tile:  # tiled mode keeps the native resolution
            h, w = self.image_size
            img = img.resize((w, h), Image.BILINEAR)  # dataset.py resize parity
        return np.asarray(img, np.uint8)

    def _run_tiled(self, batch: np.ndarray,
                   deadline_s: Optional[float] = None) -> np.ndarray:
        return self.batcher.run_exclusive(
            lambda: self.predictor.predict_proba_tiled(
                batch, tile=self.tile, overlap=self.tile_overlap
            ),
            items=int(batch.shape[0]),
            deadline_s=deadline_s,
        )

    # -- request entry points ----------------------------------------------

    def predict_npy(self, body: bytes, output: str = "proba",
                    deadline_ms: Optional[float] = None) -> bytes:
        arr = np.load(io.BytesIO(body), allow_pickle=False)
        batch = self._check_array(arr)
        dl = self._deadline_s(deadline_ms)
        out = None  # (B,H,W,1) mask already computed on device, or None
        if self.tile:
            probs = self._run_tiled(batch, deadline_s=dl)
        elif batch.shape[0] == 1 and batch.dtype == np.uint8:
            kind, row = self.batcher.submit(
                batch[0], want=output, deadline_s=dl).result()
            if kind == "mask":
                out = row[None]
            else:
                probs = row[None]
        else:
            # Pre-batched requests run directly (stacking them into other
            # requests would reorder rows). Float singles do too: coalescing
            # a float row with queued uint8 rows would promote the stack to
            # float32 and skip the uint8 rows' on-device scale+normalize.
            # run_direct / run_exclusive still serialize on the device lock.
            run_mask = self.batcher._run_mask
            if output == "mask" and run_mask is not None:
                out = self.batcher.run_exclusive(
                    lambda: run_mask(batch), items=int(batch.shape[0]),
                    deadline_s=dl,
                )
            else:
                probs = self.batcher.run_direct(batch, deadline_s=dl)
        if output == "mask" and out is None:
            from eelunet_tpu_torch.inference import _probs_to_mask

            out = _probs_to_mask(probs, self.threshold)
        buf = io.BytesIO()
        np.save(buf, np.asarray(out if output == "mask" else probs, np.float32))
        return buf.getvalue()

    def predict_png(self, body: bytes,
                    deadline_ms: Optional[float] = None) -> bytes:
        from PIL import Image

        rgb = self._decode_image(body)
        dl = self._deadline_s(deadline_ms)
        mask = None
        if self.tile:
            probs = self._run_tiled(rgb[None], deadline_s=dl)[0]
        else:
            kind, row = self.batcher.submit(
                rgb, want="mask", deadline_s=dl).result()
            if kind == "mask":  # device-computed uint8: {0,1} or class ids
                mask = row[..., 0]
                if self._n_classes == 1:
                    mask = (mask * 255).astype(np.uint8)
            else:
                probs = row
        if mask is None:
            if probs.shape[-1] > 1:  # multi-class: raw class ids (cli.predict parity)
                mask = np.argmax(probs, axis=-1).astype(np.uint8)
            else:
                mask = ((probs[..., 0] > self.threshold) * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(mask, mode="L").save(buf, format="PNG")  # cli.predict export parity
        return buf.getvalue()

    def stats(self) -> dict:
        b = self.batcher

        def pct(samples, qs=(50, 95, 99)):
            if not samples:
                return None
            vals = np.percentile(np.asarray(list(samples), np.float64), qs)
            return {f"p{q}": round(float(v), 2) for q, v in zip(qs, vals)}

        return {
            "requests": b.requests,
            "tile": self.tile or None,
            "batches": b.batches,
            "avg_batch": round(b.batched_items / b.batches, 3) if b.batches else 0.0,
            "max_batch": b.max_batch,
            "window_ms": b.window_s * 1e3,
            # Backpressure: admission bound, current depth, and shed/expired
            # counters (503s and queued-past-deadline 504s).
            "max_pending": b.max_pending or None,
            "queue_depth": b._q.qsize() + b._direct_waiting,
            "shed": b.shed,
            "expired": b.expired,
            "deadline_ms": self.deadline_ms or None,
            # Hot-reload: completed weight swaps and the active checkpoint
            # (None until the first reload — the boot checkpoint is the
            # Predictor's).
            "reloads": self.reloads,
            "checkpoint": self.loaded_checkpoint,
            # Tail latency over the last <=2048 samples: request wall time
            # (enqueue -> result) and per-batch device time.
            "latency_ms": pct(b.latency_ms),
            "device_ms": pct(b.device_ms),
            # Devices a batch is split across (the mesh's data axis; 1 for
            # one device or an exported artifact).
            "data_size": getattr(self.predictor, "data_size", 1),
            # Launches of each hand-written kernel since the process started
            # (2 per forward for each high-pass kernel; 0 on a CPU device).
            "kernel_launches": dict(LAUNCHES),
        }


def make_server(service: SegmentationService, model_name: str,
                host: str = "127.0.0.1", port: int = 0) -> ThreadingHTTPServer:
    """HTTP front end over a SegmentationService; port=0 binds ephemeral."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet; stats live at /v1/stats
            pass

        def _json(self, code: int, obj: dict, headers: Optional[dict] = None):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _bytes(self, body: bytes, ctype: str):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/v1/healthz":
                h, w = service.image_size
                self._json(200, {"status": "ok", "model": model_name,
                                 "image_size": [h, w],
                                 "tile": service.tile or None})
            elif self.path == "/v1/stats":
                self._json(200, service.stats())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            from urllib.parse import parse_qs

            path, _, query = self.path.partition("?")
            n = int(self.headers.get("Content-Length", 0))
            if path == "/v1/reload":
                # Admin: hot-swap weights. Body = {"checkpoint": "<file>"};
                # in-flight and concurrent requests are never dropped.
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                    ckpt = req.get("checkpoint")
                    if not ckpt:
                        return self._json(
                            400, {"error": 'body must be {"checkpoint": file}'})
                    return self._json(200, service.reload_checkpoint(ckpt))
                except (ValueError, FileNotFoundError) as e:
                    return self._json(400, {"error": str(e)})
                except Exception as e:
                    return self._json(
                        500, {"error": f"{type(e).__name__}: {e}"})
            if path != "/v1/predict":
                return self._json(404, {"error": f"no route {path}"})
            body = self.rfile.read(n)
            ctype = (self.headers.get("Content-Type") or "").lower()
            try:
                q = parse_qs(query)
                # per-request deadline override (ms); falls back to the
                # server-wide default when absent
                dl = q.get("deadline_ms")
                deadline_ms = float(dl[0]) if dl else None
                if ctype.startswith("image/"):
                    self._bytes(service.predict_png(body, deadline_ms),
                                "image/png")
                else:
                    output = ("mask" if q.get("output", [""])[0] == "mask"
                              else "proba")
                    self._bytes(service.predict_npy(body, output, deadline_ms),
                                "application/octet-stream")
            except Overloaded as e:
                # shed: client should back off and retry
                self._json(503, {"error": str(e)}, {"Retry-After": "1"})
            except DeadlineExceeded as e:
                self._json(504, {"error": str(e)})
            except ValueError as e:
                self._json(400, {"error": str(e)})
            except Exception as e:
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)
