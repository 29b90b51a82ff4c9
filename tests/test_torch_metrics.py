"""The port's metrics, preprocessing and resizes against the JAX
package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsds_tpu.ops import preprocess as jax_preprocess
from rtsds_tpu.ops import resize as jax_resize
from rtsds_tpu.utils import metrics as jax_metrics
from rtsds_tpu_torch.ops.preprocess import normalize
from rtsds_tpu_torch.ops.resize import resize_bilinear, upsample_bilinear
from rtsds_tpu_torch.utils import metrics


def _hist(rng, n=19, empty_classes=(3, 7)):
    hist = rng.integers(0, 5000, (n, n)).astype(np.int32)
    for c in empty_classes:  # absent classes: IoU 0 by the epsilon
        hist[c, :] = 0
        hist[:, c] = 0
    return hist


@pytest.mark.parametrize("fn", ["per_class_iou", "mean_iou",
                                "pixel_accuracy"])
def test_metrics_match_jax(fn, rng):
    hist = _hist(rng)
    got = getattr(metrics, fn)(torch.from_numpy(hist))
    want = np.asarray(getattr(jax_metrics, fn)(jnp.asarray(hist)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_pixel_accuracy_of_an_empty_matrix():
    empty = torch.zeros((19, 19), dtype=torch.int32)
    assert float(metrics.pixel_accuracy(empty)) == 0.0


@pytest.mark.parametrize("correct", [False, True])
def test_normalize_matches_jax(correct, rng):
    image = rng.integers(0, 256, (2, 8, 16, 3)).astype(np.uint8)
    got = normalize(torch.from_numpy(image), correct)
    want = np.asarray(jax_preprocess.normalize(jnp.asarray(image), correct))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("size", [(16, 32), (13, 27)])
def test_resize_bilinear_matches_jax_when_upsampling(size, rng):
    x = rng.normal(size=(2, 4, 8, 5)).astype(np.float32)  # NHWC
    want = np.asarray(jax_resize.resize_bilinear(jnp.asarray(x), size))
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), size)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-6)
    want8 = np.asarray(jax_resize.upsample_bilinear(jnp.asarray(x), 8))
    got8 = upsample_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), 8)
    np.testing.assert_allclose(got8.permute(0, 2, 3, 1).numpy(), want8,
                               rtol=1e-5, atol=1e-6)
