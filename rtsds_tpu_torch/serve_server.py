"""Serving server: concurrent clients -> micro-batched GPU inference.

Counterpart of ``rtsds_tpu/serve_server.py``.  Many clients submit single
frames; a collector thread coalesces them into the predictor's batch (up
to ``max_batch`` frames or ``max_wait_ms``, whichever comes first), runs
ONE device call, and resolves each client's future with its own mask.
Device utilization grows with load while a frame's latency stays bounded
by ``max_wait_ms`` plus one batch time.

Two layers:

* :class:`MicroBatcher`, the in-process batching engine over any
  predictor-like object (``predict(frames) -> masks``);
* :func:`make_http_server` and :func:`main`, a stdlib ThreadingHTTPServer
  on top of it: ``POST /predict`` takes a PNG (-> PNG trainId or colour
  mask) or, as ``application/octet-stream``, the raw H*W*3 uint8 bytes of
  a frame at the served size (-> H*W uint8 mask bytes); ``GET /healthz``
  and ``GET /stats``.  PIL is imported only to decode and encode PNGs, so
  the raw path serves where PIL is not installed.  ``--quantize int8``
  serves the W8A8 model, its activation scales calibrated on
  ``--calib_images`` (PNGs) or read from a QAT checkpoint's sidecar.

The forward runs under ``torch.inference_mode``, which is thread-local:
:meth:`rtsds_tpu_torch.serve.Predictor._predict` enters it itself, on
whichever thread (the collector's) calls it.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError

import numpy as np


class Overloaded(RuntimeError):
    """Raised by :meth:`MicroBatcher.submit` when the pending queue
    exceeds ``max_queue`` (mapped to HTTP 503 by the server)."""


class MicroBatcher:
    """Coalesce concurrent single-frame requests into device batches.

    Args:
      predictor: object with ``predict(frames: (N,H,W,3) uint8) -> (N,H,W)``
        and (for sizing) ``batch_size``/``image_size`` attributes.
      max_batch: largest coalesced batch (default: ``predictor.batch_size``,
        so no padding is wasted).
      max_wait_ms: how long the collector waits to fill a batch after the
        first request arrives.  0 = greedy (take whatever is queued).
      pad_to_max: zero-pad every coalesced batch to ``max_batch`` before
        the device call (results are sliced back), so the device always
        runs one batch shape.
      max_queue: backpressure: :meth:`submit` refuses new work with
        :class:`Overloaded` at this queue depth (None = unbounded), which
        turns overload into fast rejections instead of growing latency.
    """

    def __init__(self, predictor, max_batch: int | None = None,
                 max_wait_ms: float = 2.0, pad_to_max: bool = True,
                 max_queue: int | None = None):
        self.pad_to_max = bool(pad_to_max)
        self.predictor = predictor
        self.max_batch = int(max_batch or getattr(predictor, "batch_size", 8))
        self.max_wait = max(float(max_wait_ms), 0.0) / 1e3
        self.max_queue = None if max_queue is None else int(max_queue)
        self._queue: queue.Queue = queue.Queue()
        self._closed = threading.Event()
        # recent coalesced batch sizes and request latencies (bounded) and
        # monotonic counters; _stats_lock guards every mutation and the
        # stats() snapshot (iterating a deque while the collector appends
        # raises RuntimeError)
        self._stats_lock = threading.Lock()
        self.batch_sizes = collections.deque(maxlen=1024)
        self.latencies = collections.deque(maxlen=4096)
        self._requests = 0
        self._errors = 0
        self._batches = 0
        self._rejected = 0
        self._thread = threading.Thread(target=self._collector, daemon=True)
        self._thread.start()

    def submit(self, frame: np.ndarray) -> Future:
        """(H, W, 3) uint8 -> Future resolving to the (H, W) int32 mask."""
        if self._closed.is_set():
            raise RuntimeError("MicroBatcher is closed")
        frame = np.asarray(frame, dtype=np.uint8)
        if frame.ndim != 3:
            raise ValueError(f"submit() takes one HWC frame, got shape "
                             f"{frame.shape}")
        # a frame of another size inside a coalesced batch would fail the
        # whole batch for the other clients: refuse it here
        expected = getattr(self.predictor, "image_size", None)
        if expected is not None and frame.shape[:2] != tuple(expected):
            raise ValueError(
                f"predictor compiled for {tuple(expected)}, got "
                f"{frame.shape[:2]}")
        if (self.max_queue is not None
                and self._queue.qsize() >= self.max_queue):
            with self._stats_lock:
                self._rejected += 1
            raise Overloaded(
                f"queue depth {self._queue.qsize()} >= max_queue "
                f"{self.max_queue}; retry later")
        fut: Future = Future()
        with self._stats_lock:
            self._requests += 1
        self._queue.put((frame, fut, time.monotonic()))
        if self._closed.is_set():
            # close() may have drained the queue between the check and the
            # put: sweep again so this future is never stranded
            self._drain_failed()
        return fut

    def predict(self, frame: np.ndarray) -> np.ndarray:
        """Blocking form of :meth:`submit`."""
        return self.submit(frame).result()

    def _collect_one_batch(self):
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return None
        if first is None:
            return None
        batch = [first]
        t_end = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = t_end - time.monotonic()
            try:
                item = self._queue.get(timeout=max(remaining, 0.0))
            except queue.Empty:
                break
            if item is None:
                self._queue.put(None)  # re-post the shutdown token
                break
            batch.append(item)
        return batch

    @staticmethod
    def _fail(futures, exc):
        for fut in futures:
            try:
                fut.set_exception(exc)
            except InvalidStateError:
                pass  # already resolved or cancelled

    def _collector(self):
        while not self._closed.is_set():
            futures = []
            try:
                batch = self._collect_one_batch()
                if not batch:
                    continue
                # claim the futures: a client's cancel after this point can
                # no longer race the delivery of its result
                claimed = [(frame, fut, t0) for frame, fut, t0 in batch
                           if fut.set_running_or_notify_cancel()]
                if not claimed:
                    continue
                futures = [fut for _, fut, _ in claimed]
                frames = np.stack([frame for frame, _, _ in claimed])
                with self._stats_lock:
                    self.batch_sizes.append(len(claimed))
                    self._batches += 1
                n = frames.shape[0]
                if self.pad_to_max and n < self.max_batch:
                    pad = np.zeros((self.max_batch - n, *frames.shape[1:]),
                                   np.uint8)
                    frames = np.concatenate([frames, pad])
                masks = self.predictor.predict(frames)[:n]
                done = time.monotonic()
                for (_, fut, t0), mask in zip(claimed, masks):
                    fut.set_result(np.asarray(mask))
                    with self._stats_lock:
                        self.latencies.append(done - t0)
            except Exception as e:
                # the collector must outlive any failure (a dead collector
                # strands every future); the failed batch's clients get
                # the error
                with self._stats_lock:
                    self._errors += len(futures)
                self._fail(futures, e)

    def _drain_failed(self):
        """Fail everything still queued (idempotent, thread-safe)."""
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not None and item[1].set_running_or_notify_cancel():
                item[1].set_exception(RuntimeError("MicroBatcher is closed"))

    def stats(self) -> dict:
        """Serving statistics (``GET /stats``): monotonic request, batch,
        error and rejection counters, the queue depth, and over a recent
        window the mean coalesced batch size and the p50/p99 end-to-end
        request latency."""
        with self._stats_lock:
            lat = sorted(self.latencies)
            sizes = list(self.batch_sizes)
            requests, batches = self._requests, self._batches
            errors, rejected = self._errors, self._rejected

        def pct(p):
            return (round(lat[min(int(len(lat) * p), len(lat) - 1)] * 1e3, 3)
                    if lat else None)

        return {
            "requests": requests,
            "batches": batches,
            "errors": errors,
            "rejected": rejected,
            "queued": self._queue.qsize(),
            "max_batch": self.max_batch,
            "mean_batch_size": (round(sum(sizes) / len(sizes), 2)
                                if sizes else None),
            "latency_p50_ms": pct(0.50),
            "latency_p99_ms": pct(0.99),
        }

    def close(self):
        """Stop the collector; pending and late requests fail fast."""
        self._closed.set()
        self._queue.put(None)
        self._thread.join(timeout=5)
        self._drain_failed()


def make_http_server(batcher: MicroBatcher, host: str = "127.0.0.1",
                     port: int = 8000, colored: bool = False):
    """ThreadingHTTPServer: ``POST /predict`` (PNG in -> PNG mask out, or
    raw octet-stream in -> raw mask bytes out), ``GET /healthz``, ``GET
    /stats``.  PNG frames are resized on the host to the served size; a
    raw frame must be at that size.  Every failure of a request is
    answered with an error status: 400 for a raw body of the wrong length,
    503 when the batcher is overloaded, 500 for any other error (its
    message in the status line)."""
    import io
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    size = tuple(batcher.predictor.image_size)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet by default
            pass

        def _reply(self, body: bytes, content_type: str):
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(b"ok", "text/plain")
            elif self.path == "/stats":
                self._reply(json.dumps(batcher.stats()).encode(),
                            "application/json")
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path != "/predict":
                self.send_error(404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                ctype = self.headers.get("Content-Type", "")
                raw = ctype.startswith("application/octet-stream")
                if raw:
                    # exactly H*W*3 uint8 bytes at the served size; the
                    # reply is the H*W uint8 mask: no PNG codec either way
                    expected = size[0] * size[1] * 3
                    if length != expected:
                        self.send_error(
                            400, f"octet-stream body must be exactly "
                                 f"{expected} bytes (H*W*3 uint8 at the "
                                 f"compiled size {size})")
                        return
                    frame = np.frombuffer(self.rfile.read(length),
                                          np.uint8).reshape(*size, 3)
                else:
                    from PIL import Image

                    img = Image.open(io.BytesIO(self.rfile.read(length)))
                    img = img.convert("RGB")
                    if img.size != (size[1], size[0]):
                        img = img.resize((size[1], size[0]), Image.BILINEAR)
                    frame = np.asarray(img, dtype=np.uint8)
                mask = batcher.submit(frame).result(timeout=60)
                if raw:
                    self._reply(np.ascontiguousarray(
                        mask.astype(np.uint8)).tobytes(),
                        "application/octet-stream")
                    return
                from PIL import Image

                if colored:
                    from rtsds_tpu_torch.serve import colorize_masks

                    out = Image.fromarray(colorize_masks(mask))
                else:
                    out = Image.fromarray(mask.astype(np.uint8), mode="L")
                buf = io.BytesIO()
                out.save(buf, "PNG")
                self._reply(buf.getvalue(), "image/png")
            except Overloaded as e:
                self.send_error(503, " ".join(str(e).split())[:200])
            except Exception as e:
                # the client gets every failure as a 500; one line only,
                # since a newline would split the HTTP status line
                msg = " ".join(str(e).split())[:200] or "internal error"
                self.send_error(500, msg)

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    """``python -m rtsds_tpu_torch.serve_server --port 8000 [--checkpoint
    PATH]``: segmentation as a service on one GPU."""
    import argparse

    from rtsds_tpu_torch.config import parse_int_list
    from rtsds_tpu_torch.serve import Predictor, protocol_kwargs_from_flags

    parser = argparse.ArgumentParser(
        description="RTSDS micro-batching inference server (PyTorch/CUDA)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--checkpoint", default=None,
                        help="a ModelCheckpoint directory or an "
                             "export_torch .pth")
    parser.add_argument("--model", default="bisenet",
                        choices=["bisenet", "deeplab"])
    parser.add_argument("--backbone", default="resnet18")
    parser.add_argument("--size", default="1024, 2048")
    parser.add_argument("--batch", type=int, default=8,
                        help="micro-batch size of each device call")
    parser.add_argument("--max_wait_ms", type=float, default=2.0)
    parser.add_argument("--max_queue", type=int, default=None,
                        help="backpressure: reject (HTTP 503) when this "
                             "many requests are already queued; default "
                             "unbounded")
    parser.add_argument("--colored", action="store_true")
    parser.add_argument("--protocol", default="plain",
                        choices=["plain", "ensemble", "sliding"],
                        help="inference protocol (see rtsds_tpu_torch.serve)")
    parser.add_argument("--scales", default="0.75, 1.0, 1.25",
                        help='ensemble scales "s1, s2, ..."')
    parser.add_argument("--window", default="512, 1024",
                        help='sliding window "H, W"')
    parser.add_argument("--stride", default="",
                        help='sliding stride "H, W" (default 3/4 window)')
    parser.add_argument("--window_chunk", type=int, default=0,
                        help="max sliding windows stacked per forward; "
                             "0 = all windows in one batched forward")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    parser.add_argument("--quantize", default=None, choices=["int8"],
                        help="serve through the W8A8 quantized path "
                             "(needs --calib_images)")
    parser.add_argument("--calib_images", nargs="*", default=None,
                        metavar="PNG",
                        help="representative frames to calibrate the int8 "
                             "activation scales (resized to --size)")
    parser.add_argument("--calib_stat", default="max",
                        choices=["max", "percentile"],
                        help="activation-scale statistic: max-abs or an "
                             "outlier-robust percentile")
    parser.add_argument("--calib_percentile", type=float, default=99.9,
                        help="percentile for --calib_stat percentile")
    parser.add_argument("--recalibrate", action="store_true",
                        help="ignore a QAT act-scales sidecar in the "
                             "checkpoint and recalibrate from "
                             "--calib_images (otherwise the sidecar takes "
                             "precedence over --calib_stat/"
                             "--calib_percentile)")
    for flag in ("--artifact", "--mesh"):
        parser.add_argument(flag, default=None, help="not yet ported")
    args = parser.parse_args(argv)

    for flag in ("artifact", "mesh"):
        if getattr(args, flag) is not None:
            parser.error(f"--{flag} is not yet ported to rtsds_tpu_torch")
    if args.quantize and not args.calib_images:
        if args.recalibrate:
            parser.error("--recalibrate needs --calib_images to calibrate "
                         "from")
        # a QAT write-back checkpoint may carry its own scales sidecar;
        # without one, Predictor.from_checkpoint refuses
        if not args.checkpoint:
            parser.error("--quantize needs --calib_images (or a QAT "
                         "checkpoint carrying qat_act_scales.json)")

    kwargs = dict(model_name=args.model,
                  image_size=tuple(parse_int_list(args.size)),
                  batch_size=args.batch, backbone=args.backbone,
                  protocol=args.protocol,
                  protocol_kwargs=protocol_kwargs_from_flags(
                      args.protocol, args.scales, args.window, args.stride,
                      args.window_chunk),
                  device=args.device)
    if args.quantize:
        kwargs.update(quantize=args.quantize, calib_stat=args.calib_stat,
                      calib_percentile=args.calib_percentile)
        if args.calib_images:
            from rtsds_tpu_torch.data.pipeline import decode_image

            kwargs["calib_frames"] = np.stack(
                [decode_image(p, kwargs["image_size"])
                 for p in args.calib_images])
        if args.recalibrate and args.checkpoint:
            kwargs["use_qat_scales"] = False
    if args.checkpoint:
        predictor = Predictor.from_checkpoint(args.checkpoint, **kwargs)
    else:
        print("serve_server: no --checkpoint, serving RANDOM weights")
        predictor = Predictor(**kwargs)
    # the first batch pays cuDNN's and the allocator's set-up; requests
    # never do
    print("serve_server: warming up...")
    predictor.warmup()

    batcher = MicroBatcher(predictor, max_batch=args.batch,
                           max_wait_ms=args.max_wait_ms,
                           max_queue=args.max_queue)
    server = make_http_server(batcher, host=args.host, port=args.port,
                              colored=args.colored)
    restore_sigterm = _install_graceful_shutdown(server)
    print(f"serving on http://{args.host}:{args.port}/predict "
          f"(micro-batch <= {args.batch}, wait {args.max_wait_ms} ms)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        batcher.close()
        restore_sigterm()


def _install_graceful_shutdown(server):
    """SIGTERM -> stop accepting, drain in-flight requests, exit 0.  The
    handler calls ``shutdown()`` from another thread: signals arrive on the
    main thread, which is inside ``serve_forever``, and a shutdown from
    that thread deadlocks.  Returns a restore function; a no-op when not on
    the main thread (e.g. under a test runner's worker thread)."""
    import signal

    if threading.current_thread() is not threading.main_thread():
        return lambda: None

    def handler(signum, frame):
        print("serve_server: SIGTERM -- draining in-flight requests "
              "and shutting down")
        threading.Thread(target=server.shutdown, daemon=True).start()

    previous = signal.signal(signal.SIGTERM, handler)
    return lambda: signal.signal(signal.SIGTERM, previous)


if __name__ == "__main__":
    main()
