"""int8 serving in the port (``Predictor(quantize="int8")``, the serve CLI
and the HTTP server's int8 flags) against the JAX package's.

Tolerances:
  * the Predictor's calibrated scales: within 2^-5 relative of JAX's
    Predictor's (both calibrate with a bf16 forward, whose rounding can
    move the bound of a deep activation by a few bf16 steps);
  * the masks of the port's int8 Predictor fed JAX's scales: at least 97%
    of pixels equal to the JAX int8 Predictor's (0.985 measured; both
    serve bf16, whose rounding differs between XLA and ATen and can flip
    an activation code or a near-tie argmax; the two packages' bf16
    Predictors agree on 0.993 of these pixels);
  * a protocol where it must equal the plain forward (a window covering
    the frame; one scale without flip): exactly;
  * the sidecar's scales: served exactly.
"""

import json
import os
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rtsds_tpu import serve as jax_serve
from rtsds_tpu.models import bisenet_int8 as jax_bisenet_int8
from rtsds_tpu.ops.preprocess import normalize as jax_normalize
from rtsds_tpu_torch import serve_server
from rtsds_tpu_torch.callbacks.checkpoint import CheckpointManager
from rtsds_tpu_torch.data.synthetic import SyntheticSegDataset
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.serve import Predictor, main
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.qat import SCALES_SIDECAR
from rtsds_tpu_torch.train.state import TrainState
from test_torch_quant import flax_bisenet

SIZE = (64, 128)
SCALE_RTOL = 2.0 ** -5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def frames():
    ds = SyntheticSegDataset(4, SIZE, seed=3, fixed_tints=True)
    return np.stack([ds[i][0] for i in range(4)])


@pytest.fixture(scope="module")
def served(frames):
    """The JAX int8 Predictor of a BiSeNet tree, its masks, and the scales
    its calibration gives."""
    variables = flax_bisenet(7)
    jax_pred = jax_serve.Predictor(variables=variables, image_size=SIZE,
                                   batch_size=2, quantize="int8",
                                   calib_frames=frames)
    scales = jax_bisenet_int8.calibrate(
        variables, [jax_normalize(jnp.asarray(frames[i:i + 2], jnp.float32))
                    for i in (0, 2)])
    return {"variables": variables, "jax_masks": jax_pred.predict(frames),
            "jax_q8": jax_pred.variables["q8"], "scales": scales}


def test_int8_predictor_calibrates_as_jax_does(served, frames):
    pred = Predictor(variables=served["variables"], image_size=SIZE,
                     batch_size=2, quantize="int8", calib_frames=frames,
                     device="cpu")
    assert set(pred.act_scales) == set(served["scales"])
    for name, s in served["scales"].items():
        assert pred.act_scales[name] == pytest.approx(s, rel=SCALE_RTOL), name
    q8 = pred.model.qtree["q8"]
    assert set(q8) == set(served["jax_q8"])
    for name, entry in served["jax_q8"].items():
        assert float(q8[name][2]) == pytest.approx(float(entry[2]),
                                                   rel=SCALE_RTOL)


def test_int8_predictor_matches_jax_masks(served, frames):
    pred = Predictor(variables=served["variables"], image_size=SIZE,
                     batch_size=2, quantize="int8",
                     act_scales=served["scales"], device="cpu")
    masks = pred.predict(frames)
    assert masks.dtype == np.int32 and masks.shape == (4, *SIZE)
    agree = (masks == served["jax_masks"]).mean()
    assert agree >= 0.97, agree
    # one frame, and a short batch padded to the served batch
    np.testing.assert_array_equal(pred.predict(frames[0]), masks[0])
    assert list(pred.predict_iter([frames[:2], frames[2:3]]))[1].shape == \
        (1, *SIZE)


@pytest.mark.parametrize("model_name,size,window", [
    ("bisenet", SIZE, (32, 64)), ("deeplab", (32, 64), (17, 33))])
def test_int8_composes_with_the_protocols(model_name, size, window, frames):
    """Sliding and ensemble run the int8 model; where a protocol must
    give the plain forward's masks, it does, exactly."""
    calib = frames[:2, :size[0], :size[1]].copy()
    common = dict(model_name=model_name, image_size=size, batch_size=2,
                  quantize="int8", calib_frames=calib, device="cpu")
    plain = Predictor(**common)
    scales = plain.act_scales
    want = plain.predict(calib)
    for protocol, kwargs in (("sliding", {"window": size}),
                             ("ensemble", {"scales": (1.0,), "flip": False})):
        pred = Predictor(protocol=protocol, protocol_kwargs=kwargs,
                         **{**common, "act_scales": scales})
        np.testing.assert_array_equal(pred.predict(calib), want)
    for protocol, kwargs in (
            ("sliding", {"window": window}),
            ("ensemble", {"scales": (0.75, 1.0, 1.25)})):
        pred = Predictor(protocol=protocol, protocol_kwargs=kwargs,
                         **common)
        assert pred.act_scales == scales
        masks = pred.predict(calib)
        assert masks.shape == (2, *size)
        assert masks.min() >= 0 and masks.max() < 19


def test_act_scales_must_match_the_topology(served):
    common = dict(variables=served["variables"], image_size=SIZE,
                  quantize="int8", device="cpu")
    scales = served["scales"]
    with pytest.raises(ValueError, match="unknown names"):
        Predictor(act_scales={**scales, "not/a/conv": 0.1}, **common)
    trimmed = dict(scales)
    trimmed.pop("ffm/convblock:p1")
    with pytest.raises(ValueError, match="missing convs"):
        Predictor(act_scales=trimmed, **common)
    with pytest.raises(ValueError, match="missing convs"):
        Predictor(act_scales={}, **common)
    with pytest.raises(ValueError, match="calib_frames"):
        Predictor(image_size=SIZE, quantize="int8", device="cpu")
    with pytest.raises(ValueError, match="unknown quantize mode"):
        Predictor(image_size=SIZE, quantize="int4", device="cpu")
    with pytest.raises(TypeError):
        Predictor(image_size=SIZE, quantize="int8", act_scales=scales,
                  use_qat_scales=False, device="cpu")


def _checkpoint_with_sidecar(root, scales):
    """A port checkpoint of a BiSeNet and a QAT sidecar holding ``scales``
    (the JAX package's sidecar layout)."""
    model = BiSeNet()
    CheckpointManager(str(root)).save(0, {"model": TrainState(
        model, make_optimizer("SGD", model.parameters(), 0.01))},
        monitor=0.5)
    (root / SCALES_SIDECAR).write_text(json.dumps({
        "model": "bisenet", "calib_stat": "percentile",
        "calib_percentile": 99.0, "scales": scales}))
    return str(root)


def test_from_checkpoint_serves_the_sidecar_unless_told_not_to(
        tmp_path, frames, served, capsys):
    sidecar = {k: 1.5 * v for k, v in served["scales"].items()}
    ckpt = _checkpoint_with_sidecar(tmp_path / "qat", sidecar)
    common = dict(image_size=SIZE, batch_size=2, quantize="int8",
                  device="cpu")
    pred = Predictor.from_checkpoint(ckpt, calib_frames=frames, **common)
    assert pred.act_scales == sidecar
    assert "serving the QAT activation scales" in capsys.readouterr().out
    for name, entry in pred.model.qtree["q8"].items():
        assert float(entry[2]) == float(np.float32(sidecar[name]))
    recal = Predictor.from_checkpoint(ckpt, use_qat_scales=False,
                                      calib_frames=frames, **common)
    assert recal.act_scales != sidecar
    assert "QAT activation scales" not in capsys.readouterr().out
    given = {k: 2 * v for k, v in sidecar.items()}
    assert Predictor.from_checkpoint(ckpt, act_scales=given,
                                     **common).act_scales == given
    # without quantize the sidecar is not read
    assert not hasattr(Predictor.from_checkpoint(
        ckpt, image_size=SIZE, device="cpu"), "act_scales")


def _pngs(tmp_path, frames):
    paths = []
    for i, f in enumerate(frames):
        path = tmp_path / f"f{i}.png"
        Image.fromarray(f).save(path)
        paths.append(str(path))
    return paths


def test_serve_cli_quantizes(tmp_path, frames, served, capsys):
    paths = _pngs(tmp_path, frames[:2])
    out = tmp_path / "out"
    size = f"{SIZE[0]}, {SIZE[1]}"
    main([*paths, "--size", size, "--quantize", "int8", "--protocol",
          "sliding", "--window", "32, 64", "--out", str(out), "--device",
          "cpu"])
    masks = np.asarray(Image.open(out / "f0_mask.png"))
    assert masks.shape == SIZE and masks.max() < 19
    ckpt = _checkpoint_with_sidecar(tmp_path / "qat", served["scales"])
    capsys.readouterr()
    main([*paths, "--size", size, "--quantize", "int8", "--checkpoint",
          ckpt, "--out", str(out), "--device", "cpu"])
    assert "serving the QAT activation scales" in capsys.readouterr().out
    main([*paths, "--size", size, "--quantize", "int8", "--checkpoint",
          ckpt, "--recalibrate", "--calib_stat", "percentile",
          "--calib_percentile", "99.0", "--out", str(out), "--device",
          "cpu"])
    assert "QAT activation scales" not in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(["--quantize", "int8", "--device", "cpu"])
    assert "--quantize needs input images" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        main([*paths, "--calib_stat", "p99", "--device", "cpu"])


def test_server_flags(tmp_path, frames, served, monkeypatch, capsys):
    """The server's int8 refusals, and an int8 server (calibrated on
    PNGs, and from a QAT checkpoint's sidecar) answering a raw request."""
    with pytest.raises(SystemExit):
        serve_server.main(["--quantize", "int8", "--recalibrate",
                           "--device", "cpu"])
    assert "--recalibrate needs --calib_images" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve_server.main(["--quantize", "int8", "--device", "cpu"])
    assert "qat_act_scales.json" in capsys.readouterr().err
    # a checkpoint without a sidecar: the predictor refuses to guess scales
    bare = _checkpoint_with_sidecar(tmp_path / "bare", {})
    os.remove(os.path.join(bare, SCALES_SIDECAR))
    with pytest.raises(ValueError, match="needs calib_frames"):
        serve_server.main(["--quantize", "int8", "--checkpoint", bare,
                           "--device", "cpu"])

    answers = []
    real_make = serve_server.make_http_server

    def one_shot_make(batcher, host, port, colored=False):
        server = real_make(batcher, host="127.0.0.1", port=0)

        def one_request():
            port = server.server_address[1]
            done = threading.Event()

            def post():
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/predict",
                    data=frames[0].tobytes(),
                    headers={"Content-Type": "application/octet-stream"})
                with urllib.request.urlopen(req, timeout=120) as r:
                    answers.append(np.frombuffer(r.read(), np.uint8))
                done.set()

            threading.Thread(target=post, daemon=True).start()
            server.handle_request()
            done.wait(120)

        server.serve_forever = one_request
        server.shutdown = lambda: None
        return server

    monkeypatch.setattr(serve_server, "make_http_server", one_shot_make)
    size = f"{SIZE[0]}, {SIZE[1]}"
    pngs = _pngs(tmp_path, frames[:2])
    serve_server.main(["--size", size, "--batch", "2", "--quantize", "int8",
                       "--calib_images", *pngs, "--calib_stat",
                       "percentile", "--device", "cpu"])
    ckpt = _checkpoint_with_sidecar(tmp_path / "qat", served["scales"])
    serve_server.main(["--size", size, "--batch", "2", "--quantize", "int8",
                       "--checkpoint", ckpt, "--device", "cpu"])
    assert "serving the QAT activation scales" in capsys.readouterr().out
    assert len(answers) == 2
    assert all(a.shape == (SIZE[0] * SIZE[1],) and a.max() < 19
               for a in answers)
