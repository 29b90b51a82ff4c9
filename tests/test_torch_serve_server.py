"""The port's micro-batching server (``rtsds_tpu_torch/serve_server.py``):
each behaviour that ``test_serve_server.py`` checks of the JAX package's
server (request coalescing, per-client routing, errors, refusals,
cancelled futures, statistics, backpressure, the HTTP surface, SIGTERM),
except its mesh cases (the port's batch mesh is in
test_torch_parallel.py; its int8 flags are in
test_torch_quant_serving.py); and the port's
server over the port's ``Predictor`` against the JAX package's
``MicroBatcher`` over its ``Predictor`` on the same weights and frames."""

import io
import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rtsds_tpu import serve as jax_serve
from rtsds_tpu import serve_server as jax_server
from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
from rtsds_tpu.ops.preprocess import normalize as jax_normalize
from rtsds_tpu_torch import serve_server
from rtsds_tpu_torch.data.synthetic import SyntheticSegDataset
from rtsds_tpu_torch.serve import Predictor
from rtsds_tpu_torch.serve_server import (
    MicroBatcher, Overloaded, _install_graceful_shutdown, make_http_server)


class _FakePredictor:
    """Records batch sizes; mask = mean of each frame (identifies it)."""

    batch_size = 4
    image_size = (8, 12)

    def __init__(self, fail: bool = False, delay: float = 0.0):
        self.fail = fail
        self.delay = delay
        self.batches = []

    def predict(self, frames):
        if self.fail:
            raise RuntimeError("device on fire")
        if self.delay:
            time.sleep(self.delay)
        self.batches.append(frames.shape[0])
        fill = frames.reshape(frames.shape[0], -1).mean(axis=1).astype(
            np.int32)
        return np.broadcast_to(fill[:, None, None],
                               (frames.shape[0], *self.image_size)).copy()


def _frame(v):
    return np.full((8, 12, 3), v, np.uint8)


@pytest.fixture
def http():
    """``start(batcher) -> base url`` of a server on an ephemeral port in a
    thread; every server started is shut down and its batcher closed."""
    started = []

    def start(batcher, **kwargs):
        server = make_http_server(batcher, host="127.0.0.1", port=0,
                                  **kwargs)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        started.append((server, batcher, thread))
        return f"http://127.0.0.1:{server.server_address[1]}"

    yield start
    for server, batcher, thread in started:
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def _post(url, body, content_type=None, timeout=30):
    headers = {"Content-Type": content_type} if content_type else {}
    req = urllib.request.Request(url, data=body, headers=headers)
    return urllib.request.urlopen(req, timeout=timeout)


def _png(array):
    buf = io.BytesIO()
    Image.fromarray(array).save(buf, format="PNG")
    return buf.getvalue()


def test_microbatcher_routes_results_to_the_right_client():
    mb = MicroBatcher(_FakePredictor(delay=0.02), max_wait_ms=20)
    try:
        futures = {v: mb.submit(_frame(v)) for v in (3, 60, 200, 117, 9)}
        for v, fut in futures.items():
            mask = fut.result(timeout=10)
            assert mask.shape == (8, 12)
            assert int(mask[0, 0]) == v
    finally:
        mb.close()


def test_microbatcher_coalesces_under_load():
    pred = _FakePredictor(delay=0.05)
    mb = MicroBatcher(pred, max_batch=4, max_wait_ms=30)
    try:
        futures = [mb.submit(_frame(i)) for i in range(12)]
        for fut in futures:
            fut.result(timeout=20)
        sizes = list(mb.batch_sizes)
        assert len(sizes) < 12 and max(sizes) <= 4 and sum(sizes) == 12
        assert set(pred.batches) == {4}  # padded to one batch shape
    finally:
        mb.close()


def test_microbatcher_propagates_errors():
    mb = MicroBatcher(_FakePredictor(fail=True), max_wait_ms=1)
    try:
        with pytest.raises(RuntimeError, match="device on fire"):
            mb.submit(_frame(1)).result(timeout=10)
        # the collector survives a failing batch and serves the next one
        with pytest.raises(RuntimeError, match="device on fire"):
            mb.submit(_frame(2)).result(timeout=10)
        assert mb._thread.is_alive()
    finally:
        mb.close()


def test_microbatcher_rejects_batched_input_and_close():
    mb = MicroBatcher(_FakePredictor(), max_wait_ms=1)
    with pytest.raises(ValueError, match="HWC"):
        mb.submit(np.zeros((2, 8, 12, 3), np.uint8))
    with pytest.raises(ValueError, match="compiled for"):
        mb.submit(np.zeros((16, 24, 3), np.uint8))
    mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(_frame(1))


def test_microbatcher_survives_cancelled_futures():
    mb = MicroBatcher(_FakePredictor(delay=0.05), max_wait_ms=20)
    try:
        futs = [mb.submit(_frame(v)) for v in (1, 2, 3)]
        futs[1].cancel()  # may or may not land before the claim
        for i, fut in enumerate(futs):
            if not fut.cancelled():
                assert int(fut.result(timeout=10)[0, 0]) == i + 1
        assert int(mb.predict(_frame(77))[0, 0]) == 77
    finally:
        mb.close()


def test_http_server_end_to_end(http):
    url = http(MicroBatcher(_FakePredictor(), max_wait_ms=1))
    with urllib.request.urlopen(f"{url}/healthz", timeout=10) as r:
        assert r.read() == b"ok"
    with _post(f"{url}/predict", _png(_frame(42))) as r:
        assert r.headers["Content-Type"] == "image/png"
        mask = np.asarray(Image.open(io.BytesIO(r.read())))
    assert mask.shape == (8, 12) and int(mask[0, 0]) == 42
    # a PNG of another size is resized on the host, not refused
    with _post(f"{url}/predict",
               _png(np.full((30, 40, 3), 90, np.uint8))) as r:
        assert np.asarray(Image.open(io.BytesIO(r.read()))).shape == (8, 12)
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{url}/nowhere", timeout=10)
    assert e.value.code == 404


def test_http_colored_png(http):
    url = http(MicroBatcher(_FakePredictor(), max_wait_ms=1), colored=True)
    with _post(f"{url}/predict", _png(_frame(5))) as r:
        out = np.asarray(Image.open(io.BytesIO(r.read())))
    assert out.shape == (8, 12, 3)
    np.testing.assert_array_equal(out, jax_serve.colorize_masks(
        np.full((8, 12), 5)))


def test_stats_counters_and_latency():
    mb = MicroBatcher(_FakePredictor(), max_wait_ms=1.0)
    try:
        for f in [mb.submit(_frame(i)) for i in range(6)]:
            f.result(timeout=10)
        s = mb.stats()
        assert s["requests"] == 6 and s["errors"] == 0
        assert s["batches"] >= 2 and s["max_batch"] == 4
        assert 1 <= s["mean_batch_size"] <= 4
        assert 0 < s["latency_p50_ms"] <= s["latency_p99_ms"] + 1e-9
    finally:
        mb.close()
    mb = MicroBatcher(_FakePredictor(fail=True), max_wait_ms=0.0)
    try:
        with pytest.raises(RuntimeError):
            mb.submit(_frame(1)).result(timeout=10)
        assert mb.stats()["errors"] == 1
    finally:
        mb.close()


def test_http_stats_endpoint(http):
    url = http(MicroBatcher(_FakePredictor(), max_wait_ms=0.0))
    _post(f"{url}/predict", _png(_frame(3))).read()
    with urllib.request.urlopen(f"{url}/stats", timeout=10) as r:
        stats = json.loads(r.read())
    assert stats["requests"] == 1 and stats["errors"] == 0
    assert stats["latency_p50_ms"] is not None


def test_sigterm_graceful_shutdown():
    """SIGTERM calls server.shutdown() from another thread, and the
    previous handler is restored afterwards."""
    done = threading.Event()

    class FakeServer:
        def shutdown(self):
            done.set()

    previous = signal.getsignal(signal.SIGTERM)
    restore = _install_graceful_shutdown(FakeServer())
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert done.wait(timeout=10)
    finally:
        restore()
    assert signal.getsignal(signal.SIGTERM) is previous


def test_http_raw_octet_stream_roundtrip(http):
    """H*W*3 uint8 in, H*W uint8 out, no PNG codec; a body of the wrong
    length is a 400, not a poisoned batch."""
    url = http(MicroBatcher(_FakePredictor(), max_wait_ms=0.0))
    with _post(f"{url}/predict", _frame(37).tobytes(),
               "application/octet-stream") as r:
        assert r.headers["Content-Type"] == "application/octet-stream"
        mask = np.frombuffer(r.read(), np.uint8).reshape(8, 12)
    assert int(mask[0, 0]) == 37
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{url}/predict", b"\x00" * 10, "application/octet-stream")
    assert e.value.code == 400


@pytest.mark.parametrize("content_type", [None, "application/octet-stream"])
def test_http_answers_a_failed_batch_with_a_500(http, content_type):
    """A failure inside the predictor reaches the client as an HTTP error
    that names it, never as a 200 or a dropped connection."""
    url = http(MicroBatcher(_FakePredictor(fail=True), max_wait_ms=0.0))
    body = (_frame(1).tobytes() if content_type else _png(_frame(1)))
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{url}/predict", body, content_type)
    assert e.value.code == 500 and "device on fire" in e.value.reason


def test_backpressure_rejects_when_queue_full():
    mb = MicroBatcher(_FakePredictor(delay=0.2), max_batch=2,
                      max_wait_ms=0.0, max_queue=3)
    try:
        futs, rejected = [], 0
        for v in range(20):
            try:
                futs.append(mb.submit(_frame(v % 200)))
            except Overloaded:
                rejected += 1
        assert rejected > 0
        for f in futs:
            f.result(timeout=30)
        assert mb.stats()["rejected"] == rejected
        assert mb.predict(_frame(5)) is not None
    finally:
        mb.close()


def test_backpressure_http_503(http):
    url = http(MicroBatcher(_FakePredictor(delay=0.3), max_batch=1,
                            max_wait_ms=0.0, max_queue=1))
    results = []

    def worker():
        try:
            with _post(f"{url}/predict", _frame(9).tobytes(),
                       "application/octet-stream") as r:
                results.append(r.status)
        except urllib.error.HTTPError as e:
            results.append(e.code)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert 503 in results and 200 in results


def test_stats_is_safe_under_concurrent_mutation():
    """``stats()`` hammered from one thread while a flood of submits makes
    the collector append: an unguarded deque would raise 'deque mutated
    during iteration'."""
    mb = MicroBatcher(_FakePredictor(), max_wait_ms=0.0)
    stop = threading.Event()
    snapshots = []

    def hammer_stats():
        while not stop.is_set():
            snapshots.append(mb.stats()["requests"])

    t = threading.Thread(target=hammer_stats)
    t.start()
    try:
        for fut in [mb.submit(_frame(v % 251)) for v in range(400)]:
            fut.result(timeout=30)
    finally:
        stop.set()
        t.join(timeout=10)
        mb.close()
    assert not t.is_alive() and snapshots
    assert mb.stats()["requests"] == 400


@pytest.mark.parametrize("flag", ["--mesh", "--quantize"])
def test_server_main_refuses_what_is_not_ported(flag, capsys):
    """``--mesh spatial`` and ``--mesh batch`` are ported
    (test_torch_spatial.py, test_torch_parallel.py) and refuse an artifact,
    as the JAX package's server does; ``--quantize`` is ported, and
    refuses only an int8 server with nothing to calibrate from
    (``--artifact`` is served: test_torch_serve_export.py)."""
    if flag == "--quantize":
        argv = [flag, "int8"]
    else:
        argv = [flag, "spatial", "--artifact", "m.rtsds"]
    with pytest.raises(SystemExit):
        serve_server.main([*argv, "--device", "cpu"])
    err = capsys.readouterr().err
    if flag == "--quantize":
        assert "--quantize needs --calib_images" in err
    else:
        assert "--mesh is live multi-chip serving" in err


def test_server_main_serves_one_request(monkeypatch, capsys):
    """``main`` on the CPU from random init: one raw request round-trips
    (``serve_forever`` stubbed to a single ``handle_request``)."""
    served = {}
    real_make = serve_server.make_http_server

    def one_shot_make(batcher, host, port, colored=False):
        server = real_make(batcher, host=host, port=0, colored=colored)

        def one_request_then_drain():
            server.handle_request()
            for _ in range(600):
                if "status" in served or "error" in served:
                    return
                time.sleep(0.1)

        server.serve_forever = one_request_then_drain
        # shutdown() waits for the real serve_forever loop, stubbed out
        server.shutdown = lambda: None
        served["server"] = server
        return server

    monkeypatch.setattr(serve_server, "make_http_server", one_shot_make)

    def post():
        for _ in range(600):
            if "server" in served:
                break
            time.sleep(0.1)
        port = served["server"].server_address[1]
        try:
            with _post(f"http://127.0.0.1:{port}/predict",
                       np.zeros((32, 64, 3), np.uint8).tobytes(),
                       "application/octet-stream", timeout=120) as r:
                served["body"] = r.read()
                served["status"] = r.status
        except OSError as e:  # surfaced by the assert below
            served["error"] = repr(e)

    t = threading.Thread(target=post, daemon=True)
    t.start()
    serve_server.main(["--host", "127.0.0.1", "--port", "0", "--size",
                       "32, 64", "--batch", "2", "--device", "cpu"])
    t.join(timeout=120)
    assert "error" not in served, served["error"]
    assert served["status"] == 200 and len(served["body"]) == 32 * 64
    assert "serving RANDOM weights" in capsys.readouterr().out


def test_port_server_matches_the_jax_server():
    """The port's HTTP server over the port's float32 ``Predictor`` (the
    weights bridged from a Flax tree) and the JAX package's
    ``MicroBatcher`` over its ``Predictor`` answer the same frames with the
    same masks, wherever the top two logits are more than 1e-3 apart."""
    size = (64, 128)
    variables = jax.tree_util.tree_map(np.asarray, FlaxBiSeNet(
        num_classes=19).init(jax.random.key(0),
                             jnp.zeros((1, *size, 3)), train=False))
    ds = SyntheticSegDataset(6, size, seed=1, fixed_tints=True)
    frames = np.stack([ds[i][0] for i in range(6)])
    from chip_smoke import calibrate_batch_stats
    calibrate_batch_stats(variables, frames[:4])

    ref_pred = jax_serve.Predictor(variables=variables, image_size=size,
                                   batch_size=2, dtype=jnp.float32)
    ref = jax_server.MicroBatcher(ref_pred, max_wait_ms=5)
    ours = Predictor(variables=variables, image_size=size, batch_size=2,
                     dtype=torch.float32, device="cpu")
    mb = MicroBatcher(ours, max_wait_ms=5)
    server = make_http_server(mb, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/predict"
        want = np.stack([f.result(timeout=300) for f in
                         [ref.submit(frame) for frame in frames]])
        got = []
        for frame in frames:
            with _post(url, frame.tobytes(), "application/octet-stream",
                       timeout=300) as r:
                got.append(np.frombuffer(r.read(), np.uint8).reshape(size))
    finally:
        server.shutdown()
        server.server_close()
        mb.close()
        ref.close()
        thread.join(timeout=10)
    logits = np.asarray(ref_pred.model.apply(
        ref_pred.variables, jax_normalize(jnp.asarray(frames, jnp.float32)),
        train=False))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-3
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(np.stack(got)[clear], want[clear])
    assert len(np.unique(want)) > 1
