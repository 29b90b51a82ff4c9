"""The sliding-window and multi-scale/flip ensemble protocols against the
JAX package's, on a thin ([1, 1, 1, 1]) DeepLabV2 from one Flax tree, and
DeepLab serving against the JAX ``Predictor``.

Probabilities are compared at rtol 1e-5 / atol 1e-7 in float32; served
masks agree on at least 99.9% of pixels, as test_torch_serve.py holds
BiSeNet's (near-ties in the argmax may flip a few pixels).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsds_tpu import serve as jax_serve
from rtsds_tpu.eval.ensemble import make_ensemble_predict as jax_ensemble
from rtsds_tpu.eval.sliding import make_sliding_predict as jax_sliding
from rtsds_tpu.models.deeplabv2 import DeepLabV2 as FlaxDeepLab
from rtsds_tpu_torch import serve
from rtsds_tpu_torch.data.synthetic import SyntheticSegDataset
from rtsds_tpu_torch.eval.ensemble import (
    ensemble_sizes, make_ensemble_eval_step, make_ensemble_predict)
from rtsds_tpu_torch.eval.sliding import (
    _positions, make_sliding_eval_step, make_sliding_predict)
from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2
from rtsds_tpu_torch.models.pretrained import load_flax_variables
from rtsds_tpu_torch.utils.metrics import fast_hist
from test_torch_deeplab import THIN, flax_tree

# 0.75 of this size snaps to (96, 192): a real downscale, so the image
# resize antialiases; 1.25 gives (160, 320), whose logits antialias back
BASE = (128, 256)
WINDOW = (64, 128)
RTOL, ATOL = 1e-5, 1e-7


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def models():
    variables = flax_tree(THIN, (1, 64, 64, 3), seed=2)
    flax_model = FlaxDeepLab(num_classes=19, layers=THIN)
    port = load_flax_variables(DeepLabV2(layers=THIN), variables).eval()
    return flax_model, variables, port


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(4)
    return rng.normal(size=(2, *BASE, 3)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def test_positions_cover_and_clamp_to_the_edge():
    assert _positions(100, 100, 10) == [0]
    assert _positions(100, 120, 10) == [0]
    assert _positions(100, 40, 30) == [0, 30, 60]
    assert _positions(100, 40, 40) == [0, 40, 60]
    for total, window, stride in ((1024, 512, 384), (2048, 1024, 768),
                                  (97, 31, 7)):
        pos = _positions(total, window, stride)
        covered = np.zeros(total, bool)
        for p in pos:
            covered[p:p + window] = True
        assert covered.all() and pos[-1] + window == total
        assert all(b - a <= stride for a, b in zip(pos, pos[1:]))


def test_stride_larger_than_the_window_raises():
    with pytest.raises(ValueError, match="exceeds window"):
        make_sliding_predict(lambda x: x, (64, 128), window=(32, 64),
                             stride=(40, 32))
    with pytest.raises(ValueError, match="must be positive"):
        make_sliding_predict(lambda x: x, (64, 128), stride=(0, 8))
    with pytest.raises(ValueError, match="window_chunk"):
        make_sliding_predict(lambda x: x, (64, 128), window_chunk=0)


def test_sliding_probabilities_match_jax(models, images):
    flax_model, variables, port = models
    want = np.asarray(jax_sliding(flax_model.apply, BASE, window=WINDOW,
                                  return_probs=True)(variables,
                                                     jnp.asarray(images)))
    with torch.no_grad():
        got = make_sliding_predict(port, BASE, window=WINDOW,
                                   return_probs=True)(_nchw(images))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.sum(dim=1).numpy(), 1.0, rtol=1e-6)


def test_window_chunk_schedules_agree(models, images):
    _, _, port = models
    calls = []

    def forward(x):
        calls.append(x.shape[0])
        return port(x)

    x = _nchw(images)
    probs = {}
    with torch.no_grad():
        for chunk in (None, 1, 4):
            calls.clear()
            probs[chunk] = make_sliding_predict(
                forward, BASE, window=WINDOW, return_probs=True,
                window_chunk=chunk)(x)
            # 3 x 3 windows of 2 frames each
            assert calls == {None: [18], 1: [2] * 9, 4: [8, 8, 2]}[chunk]
    for chunk in (1, 4):
        torch.testing.assert_close(probs[chunk], probs[None], rtol=1e-6,
                                   atol=1e-7)


def test_ensemble_probabilities_match_jax(models, images):
    flax_model, variables, port = models
    want = np.asarray(jax_ensemble(flax_model.apply, BASE,
                                   scales=(0.75, 1.0, 1.25), flip=True,
                                   return_probs=True)(variables,
                                                      jnp.asarray(images)))
    with torch.no_grad():
        got = make_ensemble_predict(port, BASE, scales=(0.75, 1.0, 1.25),
                                    flip=True, return_probs=True)(
            _nchw(images))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=RTOL, atol=ATOL)


def test_ensemble_drops_duplicate_sizes_and_pairs_flips(models, images):
    assert ensemble_sizes(BASE, (0.75, 1.0, 1.25)) == [
        (96, 192), (128, 256), (160, 320)]
    assert ensemble_sizes((64, 128), (1.0, 1.01, 0.99, 1.25)) == [
        (64, 128), (64, 160)]
    _, _, port = models
    shapes = []

    def forward(x):
        shapes.append(tuple(x.shape))
        return port(x)

    with torch.no_grad():
        make_ensemble_predict(forward, BASE, scales=(1.0, 1.01, 0.75),
                              flip=True)(_nchw(images))
        assert shapes == [(4, 3, *BASE), (4, 3, 96, 192)]
        shapes.clear()
        one = make_ensemble_predict(forward, BASE, scales=(1.0,), flip=False,
                                    return_probs=True)(_nchw(images))
        assert shapes == [(2, 3, *BASE)]
        plain = torch.softmax(port(_nchw(images)), dim=1)
    torch.testing.assert_close(one, plain, rtol=0, atol=0)


@pytest.mark.parametrize("protocol", ["sliding", "ensemble"])
def test_protocol_eval_steps_count_through_the_histogram(models, protocol):
    _, _, port = models
    ds = SyntheticSegDataset(2, (64, 128), seed=1, fixed_tints=True)
    images = torch.from_numpy(np.stack([ds[i][0] for i in range(2)])
                              ).float() / 255.0
    labels = torch.from_numpy(np.stack([ds[i][1] for i in range(2)]))
    if protocol == "sliding":
        step = make_sliding_eval_step(port, (64, 128), 19, window=(32, 64),
                                      return_preds=True)
        predict = make_sliding_predict(port, (64, 128), window=(32, 64))
    else:
        step = make_ensemble_eval_step(port, (64, 128), 19,
                                       return_preds=True)
        predict = make_ensemble_predict(port, (64, 128))
    hist = torch.ones((19, 19), dtype=torch.int32)
    new_hist, preds = step(images, labels, hist)
    with torch.no_grad():
        want = predict(images.permute(0, 3, 1, 2))
    assert torch.equal(preds.to(torch.int32), want)
    assert torch.equal(new_hist - hist, fast_hist(labels, preds, 19))
    assert int(hist.sum()) == 19 * 19  # the histogram passed in is kept


@pytest.fixture
def thin_predictors(monkeypatch):
    """Both packages' ``Predictor`` with a thin DeepLabV2 (the serving
    code is the same at any depth)."""
    monkeypatch.setattr(jax_serve, "DeepLabV2",
                        functools.partial(FlaxDeepLab, layers=THIN))
    monkeypatch.setattr(serve, "DeepLabV2",
                        functools.partial(DeepLabV2, layers=THIN))


@pytest.mark.parametrize("protocol,kwargs", [
    ("plain", {}),
    ("sliding", {"window": (32, 64)}),
    ("ensemble", {"scales": (0.75, 1.0, 1.25)}),
])
def test_deeplab_masks_match_the_jax_predictor(thin_predictors, protocol,
                                               kwargs):
    size = (64, 128)
    variables = flax_tree(THIN, (1, *size, 3), seed=3)
    ds = SyntheticSegDataset(3, size, seed=0, fixed_tints=True)
    frames = np.stack([ds[i][0] for i in range(3)])
    common = dict(model_name="deeplab", variables=variables,
                  image_size=size, batch_size=2, protocol=protocol,
                  protocol_kwargs=kwargs)
    ours = serve.Predictor(dtype=torch.float32, device="cpu",
                           **common).predict(frames)
    want = jax_serve.Predictor(dtype=jnp.float32, **common).predict(frames)
    assert ours.shape == want.shape == (3, *size) and ours.dtype == np.int32
    assert (ours == want).mean() >= 0.999
    assert len(np.unique(want)) > 1


def test_protocol_flags_parse_like_jax():
    for args in (("ensemble", "0.5, 1.0"), ("sliding", "", "256, 512",
                                            "128, 256", 3),
                 ("sliding",), ("plain",)):
        assert serve.protocol_kwargs_from_flags(*args) == \
            jax_serve.protocol_kwargs_from_flags(*args)


@pytest.mark.parametrize("argv", [
    [], ["--protocol", "sliding", "--window", "32, 64", "--window_chunk",
         "4"], ["--protocol", "ensemble", "--scales", "0.75, 1.25"]])
def test_serve_cli_runs_deeplab(tmp_path, argv):
    from PIL import Image
    frame = SyntheticSegDataset(1, (64, 128), seed=2, fixed_tints=True)[0][0]
    path = tmp_path / "frame.png"
    Image.fromarray(frame).save(path)
    serve.main([str(path), "--size", "64, 128", "--model", "deeplab",
                "--out", str(tmp_path / "out"), "--device", "cpu", *argv])
    mask = np.asarray(Image.open(tmp_path / "out" / "frame_mask.png"))
    assert mask.shape == (64, 128) and mask.max() < 19
