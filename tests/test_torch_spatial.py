"""Spatial (height-band) serving of the port (``parallel/spatial.py``,
``Predictor(mesh=, sharding="spatial")``, ``--mesh spatial``) against one
device and against the JAX package's spatial ``Predictor``.

* Float64, batch 2, on 2 and 4 CPU "devices" (a mesh that lists the CPU
  n times): BiSeNet-R18 through the ``Predictor`` and a thin DeepLabV2
  ([1, 1, 1, 1]) through the engine, logits within rtol 1e-10 of one
  device's (atol 1e-13 of their peak magnitude: the pooled sums add in
  another order) and masks identical.  The heights include one
  where H / 32 does not divide over the bands (BiSeNet at 96: 3 rows at
  1/32 over 2 or 4 bands, one band holding none) and one where DeepLab's
  ASPP halo (24 rows at 1/8) is wider than a band (48: 7 rows at 1/8).
* The ensemble protocol under bands, float64, at the same limits (its
  antialiased shrinking resizes included).
* int8: the masks of the one-device int8 ``Predictor``, exactly, also
  below the height JAX's int8 guard needs (BiSeNet 64 on 4 bands: 2 rows
  at 1/32; DeepLab 16 on 4 bands: 2 rows at 1/8).
* Against JAX's own spatial ``Predictor`` on 2 of conftest's 8 virtual CPU
  devices, float32: the logits over their peak magnitude (~1e3 from a
  random init) at rtol 1e-4 / atol 1e-4 (tests/test_spatial_sharding.py's
  limit), the masks on all but 1e-3 of the pixels.
* The sliding protocol on bands (``eval/sliding.py:
  make_banded_sliding_predict``), float64, on 2 and 4 CPU devices: the
  masks of one device's sliding ``Predictor`` exactly, and a thin
  DeepLab's mean probabilities within rtol 1e-10 (atol 1e-13 of the peak)
  of one device's, with windows that span up to three bands.
* JAX's errors: a height that does not divide over the mesh, an unknown
  sharding; ops with no banded form (a flip, a cumulative sum or an
  argmax over H, a plain tensor varying along H, a sum over H alone) are
  refused, asking for the map to be gathered first.
* ``from_checkpoint`` and ``predict_iter`` on bands; ``--mesh spatial``
  through the serve CLI and the server.
"""

import threading
import time

import numpy as np
import pytest
import torch

from rtsds_tpu_torch import serve, serve_server
from rtsds_tpu_torch.eval.ensemble import make_ensemble_predict
from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2
from rtsds_tpu_torch.parallel import spatial
from rtsds_tpu_torch.parallel.mesh import Mesh, shard_spatial, row_starts
from rtsds_tpu_torch.serve import Predictor

RTOL = 1e-10
# an absolute limit, over the logits' peak magnitude (a random init's
# logits reach ~1e3, and a sum over the bands in another order leaves an
# element near zero at 1e-12 apart)
ATOL_OF_PEAK = 1e-13
JAX = dict(rtol=1e-4, atol=1e-4)
THIN = (1, 1, 1, 1)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _frames(n, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                np.uint8)


def _close(got, want):
    torch.testing.assert_close(
        got, want, rtol=RTOL,
        atol=ATOL_OF_PEAK * float(want.abs().max()))


def _one_device_logits(predictor, frames):
    from rtsds_tpu_torch.ops.preprocess import normalize

    x = normalize(torch.from_numpy(frames), False).permute(0, 3, 1, 2)
    with torch.inference_mode():
        return predictor.model(x.to(predictor.dtype))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("height", [64, 96])
def test_bisenet_predictor_on_bands_equals_one_device(height, n):
    frames = _frames(2, height, 64)
    kw = dict(image_size=(height, 64), batch_size=2, dtype=torch.float64)
    one = Predictor(device="cpu", **kw)
    banded = Predictor(mesh=Mesh(["cpu"] * n), sharding="spatial", **kw)
    assert len(banded.replicas) == n
    want = _one_device_logits(one, frames)
    got = banded.spatial_logits(frames)
    _close(got, want)
    np.testing.assert_array_equal(banded.predict(frames),
                                  one.predict(frames))
    # a short batch is padded, as on one device
    np.testing.assert_array_equal(banded.predict(frames[:1]),
                                  one.predict(frames[:1]))


def _thin_deeplab():
    torch.manual_seed(3)
    model = DeepLabV2(layers=THIN, output_f32=False).double().eval()
    with torch.no_grad():  # BN statistics off the identity
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    return model


def _engine(model, x, n):
    """``model`` on n bands of the NCHW ``x`` (CPU devices), gathered."""
    eng = spatial.SpatialModel([model] * n, ["cpu"] * n)
    bands = spatial.bands_of(spatial.split_rows(x, eng.devices,
                                                starts=row_starts(
                                                    x.shape[-2], n)),
                             eng.layout())
    with torch.inference_mode():
        return spatial.gather(eng(bands))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("height", [48, 64])
def test_thin_deeplab_on_bands_equals_one_device(height, n):
    """At 48 rows DeepLab's 1/8 map has 7, fewer than the ASPP's halo of
    24 on either side: every band reads rows from all the others."""
    model = _thin_deeplab()
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 3, height, 40)))
    with torch.inference_mode():
        want = model(x)
    got = _engine(model, x, n)
    _close(got, want)
    assert torch.equal(got.argmax(1), want.argmax(1))


@pytest.mark.parametrize("n", [2, 4])
def test_ensemble_on_bands_equals_one_device(n):
    """BiSeNet through the ``Predictor``'s ensemble, thin DeepLab through
    the engine: scales that shrink (antialiased) and enlarge, and flips."""
    frames = _frames(2, 64, 96, seed=2)
    kw = dict(image_size=(64, 96), batch_size=2, dtype=torch.float64,
              protocol="ensemble", protocol_kwargs={"scales": (0.5, 1.25)})
    one = Predictor(device="cpu", **kw)
    banded = Predictor(mesh=Mesh(["cpu"] * n), sharding="spatial", **kw)
    np.testing.assert_array_equal(banded.predict(frames),
                                  one.predict(frames))

    model = _thin_deeplab()
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 3, 64,
                                                                 96)))
    probs = make_ensemble_predict(model, (64, 96), scales=(0.75, 1.25),
                                  return_probs=True)
    with torch.inference_mode():
        want = probs(x)
    eng = spatial.SpatialModel([model] * n, ["cpu"] * n)
    banded_probs = make_ensemble_predict(eng, (64, 96), scales=(0.75, 1.25),
                                         return_probs=True)
    bands = spatial.bands_of(spatial.split_rows(
        x, eng.devices, starts=row_starts(64, n)), eng.layout())
    with torch.inference_mode():
        got = spatial.gather(banded_probs(bands))
    _close(got, want)


@pytest.mark.parametrize("n", [2, 4])
def test_sliding_on_bands_equals_one_device(n):
    """BiSeNet through the ``Predictor``'s sliding protocol (masks), thin
    DeepLab's mean probabilities through the banded predict (40-row
    windows over 16-row bands: a window reads three bands)."""
    from rtsds_tpu_torch.eval.sliding import (
        make_banded_sliding_predict, make_sliding_predict)

    frames = _frames(2, 64, 96, seed=8)
    kw = dict(image_size=(64, 96), batch_size=2, dtype=torch.float64,
              protocol="sliding", protocol_kwargs={"window": (32, 48)})
    one = Predictor(device="cpu", **kw)
    banded = Predictor(mesh=Mesh(["cpu"] * n), sharding="spatial", **kw)
    np.testing.assert_array_equal(banded.predict(frames),
                                  one.predict(frames))

    model = _thin_deeplab()
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(2, 3, 64,
                                                                 96)))
    grid = dict(window=(40, 48), stride=(12, 36), return_probs=True)
    with torch.inference_mode():
        want = make_sliding_predict(model, (64, 96), **grid)(x)
        bands = spatial.bands_of(spatial.split_rows(
            x, ["cpu"] * n, starts=row_starts(64, n)),
            spatial.SpatialModel([model] * n, ["cpu"] * n).layout())
        got = make_banded_sliding_predict([model] * n, (64, 96),
                                          window_chunk=2, **grid)(bands)
    _close(spatial.gather(got), want)
    assert torch.equal(spatial.gather(got).argmax(1), want.argmax(1))


@pytest.mark.parametrize("model,height,n", [
    ("bisenet", 64, 2), ("bisenet", 64, 4), ("deeplab", 32, 2),
    ("deeplab", 16, 4)])
def test_int8_on_bands_equals_the_one_device_int8_predictor(model, height,
                                                            n):
    """BiSeNet at 64 on 4 bands and DeepLab at 16 on 4 bands lie below
    the height JAX's int8 guard asks for (its deepest map must keep a row
    per device); the bands need no guard."""
    frames = _frames(2, height, 64, seed=6)
    kw = dict(model_name=model, image_size=(height, 64), batch_size=2,
              quantize="int8", calib_frames=frames)
    one = Predictor(device="cpu", **kw)
    banded = Predictor(mesh=Mesh(["cpu"] * n), sharding="spatial", **kw)
    assert banded.act_scales == one.act_scales
    np.testing.assert_array_equal(banded.predict(frames),
                                  one.predict(frames))


def test_spatial_predict_iter_and_from_checkpoint(tmp_path):
    """A checkpoint served on bands: ``from_checkpoint`` passes the mesh
    on, and ``predict_iter`` yields what ``predict`` gives, batch by
    batch, each the one device's masks."""
    from rtsds_tpu_torch.callbacks.checkpoint import CheckpointManager
    from rtsds_tpu_torch.models.bisenet import BiSeNet
    from rtsds_tpu_torch.train.optim import make_optimizer
    from rtsds_tpu_torch.train.state import TrainState

    torch.manual_seed(11)
    model = BiSeNet()
    CheckpointManager(str(tmp_path)).save(0, {"model": TrainState(
        model, make_optimizer("SGD", model.parameters(), 0.01))})
    kw = dict(image_size=(64, 64), batch_size=2, dtype=torch.float64)
    banded = Predictor.from_checkpoint(
        str(tmp_path), mesh=Mesh(["cpu"] * 2), sharding="spatial", **kw)
    one = Predictor.from_checkpoint(str(tmp_path), device="cpu", **kw)
    batches = [_frames(2, 64, 64, seed=s) for s in (1, 2)] + [
        _frames(1, 64, 64, seed=3)]
    streamed = list(banded.predict_iter(iter(batches)))
    for got, frames in zip(streamed, batches):
        np.testing.assert_array_equal(got, banded.predict(frames))
        np.testing.assert_array_equal(got, one.predict(frames))


def test_spatial_predictor_matches_jax_on_two_devices():
    import jax
    import jax.numpy as jnp

    from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
    from rtsds_tpu.ops.preprocess import normalize as jax_normalize
    from rtsds_tpu.parallel import mesh as jax_mesh
    from rtsds_tpu.serve import Predictor as JaxPredictor

    frames = _frames(2, 64, 64, seed=8)
    model = FlaxBiSeNet(num_classes=19)
    variables = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False))
    mesh = jax_mesh.make_mesh(jax.devices()[:2])
    want_masks = JaxPredictor(variables=variables, image_size=(64, 64),
                              batch_size=2, dtype=jnp.float32, mesh=mesh,
                              sharding="spatial").predict(frames)
    x = jax_mesh.shard_spatial(
        jax_normalize(jnp.asarray(frames, jnp.float32)), mesh)
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, x)).transpose(0, 3, 1, 2)

    ours = Predictor(variables=variables, image_size=(64, 64), batch_size=2,
                     dtype=torch.float32, mesh=Mesh(["cpu", "cpu"]),
                     sharding="spatial")
    got = ours.spatial_logits(frames).float().numpy()
    # over the peak magnitude: float32 rounding of logits near 1e3
    peak = np.abs(want).max()
    np.testing.assert_allclose(got / peak, want / peak, **JAX)
    assert (ours.predict(frames) == want_masks).mean() >= 1 - 1e-3


def test_jax_errors_and_what_has_no_banded_form():
    with pytest.raises(ValueError, match="image height 100 must divide "
                                         "over the 3-device mesh"):
        Predictor(image_size=(100, 64), mesh=Mesh(["cpu"] * 3),
                  sharding="spatial")
    with pytest.raises(ValueError, match="unknown serving sharding"):
        Predictor(image_size=(64, 64), mesh=Mesh(["cpu"] * 2),
                  sharding="rows")
    # the sliding protocol is banded now (test_sliding_on_bands_...)
    Predictor(image_size=(64, 64), mesh=Mesh(["cpu"] * 2),
              sharding="spatial", protocol="sliding",
              protocol_kwargs={"window": (32, 32)}, device="cpu")
    x = torch.zeros(1, 3, 8, 8)
    eng = spatial.SpatialModel([torch.nn.Identity()] * 2, ["cpu"] * 2)
    bands = spatial.bands_of(spatial.split_rows(x, eng.devices),
                             eng.layout())
    assert bands.shape == x.shape
    for fn in (lambda b: b.flip(-2), lambda b: torch.cumsum(b, 2),
               lambda b: b.argmax(-2), lambda b: b * torch.ones(1, 1, 8, 1),
               lambda b: b.sum(dim=2)):
        with pytest.raises(NotImplementedError,
                           match="no height-band form: gather the map "
                                 "first"):
            fn(bands)


def test_shard_spatial_gives_each_device_its_band():
    frames = torch.arange(2 * 8 * 4 * 3).reshape(2, 8, 4, 3)
    parts = shard_spatial(frames, Mesh(["cpu"] * 4))
    assert [tuple(p.shape) for p in parts] == [(2, 2, 4, 3)] * 4
    assert torch.equal(torch.cat(parts, dim=1), frames)


def test_serve_cli_mesh_spatial_writes_the_single_device_masks(
        tmp_path, monkeypatch):
    from PIL import Image

    monkeypatch.setenv("RTSDS_CPU_DEVICES", "2")
    frames = _frames(2, 32, 64, seed=5)
    paths = []
    for i, frame in enumerate(frames):
        paths.append(str(tmp_path / f"f{i}.png"))
        Image.fromarray(frame).save(paths[-1])
    serve.main([*paths, "--size", "32, 64", "--out", str(tmp_path / "mesh"),
                "--device", "cpu", "--mesh", "spatial"])
    serve.main([*paths, "--size", "32, 64", "--out", str(tmp_path / "one"),
                "--device", "cpu"])
    for i in range(2):
        a = np.asarray(Image.open(tmp_path / "mesh" / f"f{i}_mask.png"))
        b = np.asarray(Image.open(tmp_path / "one" / f"f{i}_mask.png"))
        np.testing.assert_array_equal(a, b)


def test_server_mesh_spatial_replies_equal_predict(monkeypatch):
    """``serve_server --mesh spatial`` over two CPU devices answers a raw
    request with the single-device predictor's mask (``serve_forever``
    stubbed to one request)."""
    import urllib.request

    monkeypatch.setenv("RTSDS_CPU_DEVICES", "2")
    frame = _frames(1, 32, 64, seed=9)[0]
    served = {}
    real_make = serve_server.make_http_server

    def one_shot_make(batcher, host, port, colored=False):
        server = real_make(batcher, host=host, port=0, colored=colored)
        served["predictor"] = batcher.predictor

        def one_request_then_drain():
            server.handle_request()
            for _ in range(600):
                if "status" in served or "error" in served:
                    return
                time.sleep(0.1)

        server.serve_forever = one_request_then_drain
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
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict", data=frame.tobytes(),
            headers={"Content-Type": "application/octet-stream"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                served["body"] = r.read()
                served["status"] = r.status
        except OSError as e:
            served["error"] = repr(e)

    t = threading.Thread(target=post, daemon=True)
    t.start()
    serve_server.main(["--host", "127.0.0.1", "--port", "0", "--size",
                       "32, 64", "--batch", "2", "--device", "cpu",
                       "--mesh", "spatial"])
    t.join(timeout=120)
    assert "error" not in served, served["error"]
    assert served["predictor"].mesh.size == 2
    assert served["predictor"].sharding == "spatial"
    mask = np.frombuffer(served["body"], np.uint8).reshape(32, 64)
    want = Predictor(image_size=(32, 64), batch_size=1,
                     device="cpu").predict(frame)
    np.testing.assert_array_equal(mask, want)


def test_spatial_serving_refuses_to_fall_back_to_the_cpu(monkeypatch):
    """``--mesh spatial`` builds its mesh over the GPUs and raises without
    one, unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serving_mesh("spatial", 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_server.main(["--size", "32, 64", "--batch", "1", "--mesh",
                           "spatial"])
    mesh = serve.serving_mesh("spatial", 1, device="cpu")
    assert mesh["sharding"] == "spatial" and mesh["mesh"].size >= 1
