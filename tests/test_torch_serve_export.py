"""Serving artifacts of the port (``rtsds_tpu_torch/serve_export.py``)
against the live ``Predictor`` and the JAX package's ``serve_export``.

The artifact's masks equal ``Predictor.predict``'s exactly on the CPU, in
float32 and bf16, under each protocol and in int8; the header holds the
JAX package's keys with the same values; each package refuses the other's
artifact.  The float32 artifact agrees with the JAX package's artifact of
the same Flax weights on >= 0.999 of pixels (near-ties of the argmax may
flip between libraries, as in test_torch_serve.py).
"""

import json
import struct
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rtsds_tpu import serve as jax_serve
from rtsds_tpu import serve_export as jax_export
from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
from rtsds_tpu_torch import serve, serve_server
from rtsds_tpu_torch.data.synthetic import SyntheticSegDataset
from rtsds_tpu_torch.serve import Predictor
from rtsds_tpu_torch.serve_export import (
    ExportedPredictor, _batch_bound, _export, export_predictor,
    load_predictor)
from test_torch_serve_server import _post

SIZE = (64, 128)
# the largest batch whose (N, 19, 64, 128) logits have fewer than 2^31
# elements, where ops/resize.py changes kernels
LOGITS_BOUND = -(-(2 ** 31 - 1) // (19 * 64 * 128)) - 1


@pytest.fixture(scope="module")
def variables():
    v = FlaxBiSeNet(num_classes=19).init(
        jax.random.key(0), jnp.zeros((1, *SIZE, 3), jnp.float32),
        train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(3)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.1, 0.5, a.shape).astype(np.float32),
        v["batch_stats"])
    return v


@pytest.fixture(scope="module")
def frames():
    ds = SyntheticSegDataset(5, SIZE, seed=0, fixed_tints=True)
    return np.stack([ds[i][0] for i in range(5)])


@pytest.fixture(scope="module")
def predictor(variables):
    return Predictor(variables=variables, image_size=SIZE, batch_size=2,
                     dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def artifact(predictor, tmp_path_factory):
    """The float32 predictor exported with a dynamic batch."""
    return export_predictor(
        predictor, str(tmp_path_factory.mktemp("art") / "dyn.rtsds"))


@pytest.fixture(scope="module")
def jax_artifact(variables, tmp_path_factory):
    p = jax_serve.Predictor(variables=variables, image_size=SIZE,
                            batch_size=2, dtype=jnp.float32)
    path = str(tmp_path_factory.mktemp("jax_art") / "jax.rtsds")
    return p, jax_export.export_predictor(p, path, platforms=("cpu",),
                                          batch="dynamic")


def _meta(path):
    with open(path, "rb") as f:
        data = f.read()
    magic_end = data.index(b"\n") + 1
    (hlen,) = struct.unpack("<I", data[magic_end:magic_end + 4])
    return data, magic_end, json.loads(data[magic_end + 4:
                                            magic_end + 4 + hlen])


@pytest.mark.parametrize("n", [1, 2, 3])
def test_dynamic_float32_artifact_is_exact(artifact, predictor, frames, n):
    ep = load_predictor(artifact, device="cpu")
    assert isinstance(ep, ExportedPredictor)
    assert ep.image_size == SIZE and ep.batch == "dynamic"
    # the largest batch whose 19x64x128 logits stay below 2^31 elements
    assert ep.max_batch == LOGITS_BOUND
    masks = ep.predict(frames[:n])
    assert masks.shape == (n, *SIZE) and masks.dtype == np.int32
    np.testing.assert_array_equal(masks, predictor.predict(frames[:n]))
    assert len(np.unique(masks)) > 1


def test_a_bounded_batch_is_served_in_chunks(artifact, predictor, frames):
    ep = load_predictor(artifact, device="cpu")
    ep.max_batch = 2  # as if the export had bounded the batch at 2
    seen = []
    call = ep._call

    def recorded(batch):
        seen.append(batch.shape[0])
        return call(batch)

    ep._call = recorded
    np.testing.assert_array_equal(ep.predict(frames),
                                  predictor.predict(frames))
    assert seen == [2, 2, 1]


class _Branching(torch.nn.Module):
    """Takes another route from 5 frames on, as ``ops/resize.py`` does at
    2^31 output elements."""

    def forward(self, x):
        if x.shape[0] >= 5:
            x = x.contiguous()
        return x.float() * 2


def test_a_branch_on_the_batch_bounds_it():
    x = torch.zeros(2, 3, 4, 5, dtype=torch.uint8).permute(0, 2, 3, 1)
    exported = _export(_Branching(), x, dynamic=True)
    assert _batch_bound(exported) == 4
    module = exported.module()
    for n in (1, 4):
        out = module(torch.zeros(n, 4, 5, 3, dtype=torch.uint8))
        assert tuple(out.shape) == (n, 4, 5, 3)
    with pytest.raises(AssertionError):
        module(torch.zeros(5, 4, 5, 3, dtype=torch.uint8))
    assert _batch_bound(_export(_Branching(), x, dynamic=False)) is None


def test_single_frame_colour_and_wrong_size(artifact, predictor, frames):
    ep = load_predictor(artifact, device="cpu")
    one = ep.predict(frames[0])
    assert one.shape == SIZE
    np.testing.assert_array_equal(one, predictor.predict(frames[0]))
    np.testing.assert_array_equal(ep.predict_colored(frames[:2]),
                                  predictor.predict_colored(frames[:2]))
    with pytest.raises(ValueError, match="built for"):
        ep.predict(np.zeros((1, 32, 32, 3), np.uint8))


def test_the_artifact_agrees_with_the_jax_artifact(artifact, jax_artifact,
                                                   frames):
    _, path = jax_artifact
    want = jax_export.load_predictor(path).predict(frames)
    got = load_predictor(artifact, device="cpu").predict(frames)
    assert (got == want).mean() >= 0.999


def test_meta_holds_the_jax_keys_and_values(artifact, jax_artifact):
    _, _, ours = _meta(artifact)
    _, _, theirs = _meta(jax_artifact[1])
    assert ours == theirs == {
        "image_size": list(SIZE), "batch": "dynamic", "platforms": ["cpu"],
        "num_classes": 19, "model": "BiSeNet",
        "correct_preprocessing": False, "protocol": "plain",
        "quantize": None}


def test_static_batch_pads_and_chunks(predictor, frames, tmp_path):
    path = export_predictor(predictor, str(tmp_path / "b2.rtsds"), batch=2)
    ep = load_predictor(path, device="cpu")
    assert ep.batch == 2 and ep.max_batch == 2
    seen = []
    call = ep._call

    def recorded(batch):
        seen.append(batch.shape[0])
        return call(batch)

    ep._call = recorded
    np.testing.assert_array_equal(ep.predict(frames),   # 2 + 2 + 1 (pad)
                                  predictor.predict(frames))
    assert seen == [2, 2, 2]
    with pytest.raises(ValueError, match="'dynamic' or >= 1"):
        export_predictor(predictor, str(tmp_path / "b0.rtsds"), batch=0)


@pytest.mark.parametrize("protocol,kwargs,batch,dtype", [
    ("sliding", {"window": (32, 64)}, "dynamic", torch.float32),
    ("ensemble", {"scales": (1.0, 1.5), "flip": True}, 2, torch.bfloat16),
])
def test_protocol_artifacts_are_exact(variables, frames, tmp_path, protocol,
                                      kwargs, batch, dtype):
    p = Predictor(variables=variables, image_size=SIZE, batch_size=2,
                  dtype=dtype, protocol=protocol, protocol_kwargs=kwargs,
                  device="cpu")
    path = export_predictor(p, str(tmp_path / "p.rtsds"), batch=batch)
    ep = load_predictor(path, device="cpu")
    assert ep.meta["protocol"] == protocol
    np.testing.assert_array_equal(ep.predict(frames[:3]),
                                  p.predict(frames[:3]))


def test_int8_artifact_is_exact(variables, frames, tmp_path):
    """A dynamic batch through the int8 walk: the GEMM's row padding is
    taken for every batch where the rows may be 16 or fewer, so only the
    logits' resize bounds the batch."""
    p = Predictor(variables=variables, image_size=SIZE, batch_size=2,
                  quantize="int8", calib_frames=frames[:2], device="cpu")
    path = export_predictor(p, str(tmp_path / "q.rtsds"))
    ep = load_predictor(path, device="cpu")
    assert ep.meta["quantize"] == "int8" and ep.max_batch == LOGITS_BOUND
    for n in (1, 3):
        np.testing.assert_array_equal(ep.predict(frames[:n]),
                                      p.predict(frames[:n]))


def test_each_package_refuses_the_others_artifact(artifact, jax_artifact,
                                                  tmp_path):
    with pytest.raises(ValueError, match="JAX package"):
        load_predictor(jax_artifact[1], device="cpu")
    with pytest.raises(ValueError, match="artifact"):
        jax_export.load_predictor(artifact)
    bad = tmp_path / "bad.rtsds"
    bad.write_bytes(b"not an artifact")
    with pytest.raises(ValueError, match="not an RTSDS serving artifact"):
        load_predictor(str(bad), device="cpu")
    trunc = tmp_path / "trunc.rtsds"
    trunc.write_bytes(b"RTSDS-TORCH1\n\x09")   # the magic, then 1 byte
    with pytest.raises(ValueError, match="truncated"):
        load_predictor(str(trunc), device="cpu")


def test_another_device_raises_naming_both(artifact, tmp_path):
    data, magic_end, meta = _meta(artifact)
    (hlen,) = struct.unpack("<I", data[magic_end:magic_end + 4])
    meta["platforms"] = ["cuda"]
    head = json.dumps(meta).encode()
    moved = tmp_path / "cuda.rtsds"
    moved.write_bytes(data[:magic_end] + struct.pack("<I", len(head)) + head
                      + data[magic_end + 4 + hlen:])
    with pytest.raises(ValueError, match=r"\['cuda'\], not for 'cpu'"):
        load_predictor(str(moved), device="cpu")


def test_serve_cli_exports_and_serves_an_artifact(tmp_path, frames, capsys):
    """``--export`` from random init, then ``--artifact``: the masks
    written equal the live predictor's; the JAX CLI's flag checks stand."""
    art = str(tmp_path / "model.rtsds")
    serve.main(["--size", "64, 128", "--export", art, "--device", "cpu"])
    assert f"exported serving artifact to {art}" in capsys.readouterr().out
    img = tmp_path / "frame.png"
    Image.fromarray(frames[3]).save(str(img))
    serve.main([str(img), "--artifact", art, "--out", str(tmp_path),
                "--device", "cpu"])
    mask = np.asarray(Image.open(str(tmp_path / "frame_mask.png")))
    want = Predictor(image_size=SIZE, device="cpu").predict(frames[3])
    np.testing.assert_array_equal(mask, want)
    for argv, message in (
            (["--export", art, "--artifact", art], "needs a live model"),
            ([str(img), "--artifact", art, "--protocol", "sliding"],
             "baked into an artifact"),
            ([str(img), "--artifact", art, "--quantize", "int8"],
             "--quantize happens at predictor build time"),
            ([str(img), "--artifact", art, "--mesh", "batch"],
             "single-device programs")):
        with pytest.raises(SystemExit):
            serve.main([*argv, "--device", "cpu"])
        assert message in capsys.readouterr().err


def test_server_serves_an_artifact(artifact, predictor, frames, monkeypatch,
                                   capsys):
    """``serve_server --artifact``: one raw request, answered with the
    artifact's mask (``serve_forever`` stubbed to one request)."""
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
        server.shutdown = lambda: None
        served["server"] = server
        served["batch"] = batcher.max_batch
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
                       frames[4].tobytes(), "application/octet-stream",
                       timeout=120) as r:
                served["body"] = r.read()
                served["status"] = r.status
        except OSError as e:  # surfaced by the assert below
            served["error"] = repr(e)

    t = threading.Thread(target=post, daemon=True)
    t.start()
    serve_server.main(["--host", "127.0.0.1", "--port", "0", "--artifact",
                       artifact, "--batch", "3", "--device", "cpu"])
    t.join(timeout=120)
    assert "error" not in served, served["error"]
    assert served["status"] == 200 and served["batch"] == 3
    mask = np.frombuffer(served["body"], np.uint8).reshape(SIZE)
    np.testing.assert_array_equal(mask, predictor.predict(frames[4]))
    with pytest.raises(SystemExit):
        serve_server.main(["--artifact", artifact, "--quantize", "int8",
                           "--calib_images", "x.png", "--device", "cpu"])
    assert "already a compiled program" in capsys.readouterr().err
