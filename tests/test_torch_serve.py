"""The port's serving path against the JAX package's ``Predictor``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rtsds_tpu import serve as jax_serve
from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
from rtsds_tpu_torch.data.synthetic import SyntheticSegDataset
from rtsds_tpu_torch.serve import (
    Predictor, batched_mask_predict, colorize_masks, main)

SIZE = (64, 128)


@pytest.fixture(scope="module")
def variables():
    v = FlaxBiSeNet(num_classes=19).init(
        jax.random.key(0), jnp.zeros((1, *SIZE, 3), jnp.float32),
        train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    # BN statistics away from the identity, so the masks are not trivial
    rng = np.random.default_rng(3)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.1, 0.5, a.shape).astype(np.float32),
        v["batch_stats"])
    return v


@pytest.fixture(scope="module")
def frames():
    ds = SyntheticSegDataset(3, SIZE, seed=0, fixed_tints=True)
    return np.stack([ds[i][0] for i in range(3)])


def test_masks_match_the_jax_predictor(variables, frames):
    ours = Predictor(variables=variables, image_size=SIZE, batch_size=2,
                     dtype=torch.float32, device="cpu").predict(frames)
    ref = jax_serve.Predictor(variables=variables, image_size=SIZE,
                              batch_size=2, dtype=jnp.float32)
    want = ref.predict(frames)
    assert ours.shape == want.shape == (3, *SIZE)
    assert ours.dtype == np.int32
    # near-ties in the argmax may flip a few pixels between libraries
    assert (ours == want).mean() >= 0.999
    assert len(np.unique(want)) > 1


def test_uint8_on_the_device_and_int32_from_predict(variables, frames):
    p = Predictor(variables=variables, image_size=SIZE, batch_size=2,
                  dtype=torch.float32, device="cpu").warmup()
    out = p._predict(frames[:2])
    assert out.dtype == torch.uint8 and tuple(out.shape) == (2, *SIZE)
    masks = p.predict(frames[0])  # a single (H, W, 3) frame
    assert masks.shape == SIZE and masks.dtype == np.int32
    colored = p.predict_colored(frames[:2])
    assert colored.shape == (2, *SIZE, 3) and colored.dtype == np.uint8


def _recording_call(log):
    def call(batch):
        log.append(batch.shape[0])
        return torch.from_numpy(batch[..., 0].copy())
    return call


@pytest.mark.parametrize("n,calls", [(3, [4]), (9, [4, 4, 4]), (4, [4])])
def test_pad_and_chunk_rules(n, calls, rng):
    frames = rng.integers(0, 256, (n, 4, 6, 3)).astype(np.uint8)
    log = []
    out = batched_mask_predict(_recording_call(log), frames, (4, 6), 4)
    assert log == calls
    np.testing.assert_array_equal(out, frames[..., 0].astype(np.int32))
    assert out.dtype == np.int32
    jax_out = jax_serve.batched_mask_predict(
        lambda b: b[..., 0], frames, (4, 6), 4)
    np.testing.assert_array_equal(out, jax_out)


def test_single_frame_and_size_check(rng):
    frame = rng.integers(0, 256, (4, 6, 3)).astype(np.uint8)
    log = []
    out = batched_mask_predict(_recording_call(log), frame, (4, 6), 2)
    assert log == [2] and out.shape == (4, 6)
    np.testing.assert_array_equal(out, frame[..., 0])
    with pytest.raises(ValueError, match="built for"):
        batched_mask_predict(_recording_call([]), frame, (5, 6), 2)


def test_colorize_masks_matches_jax(rng):
    masks = rng.integers(-2, 25, (2, 5, 7))
    np.testing.assert_array_equal(colorize_masks(masks),
                                  jax_serve.colorize_masks(masks))
    np.testing.assert_array_equal(colorize_masks(masks[0]),
                                  jax_serve.colorize_masks(masks[0]))


@pytest.mark.parametrize("kwargs", [{"mesh": "batch"},
                                    {"model_name": "deeplab",
                                     "mesh": "spatial"},
                                    {"quantize": "int8"}])
def test_unported_options_raise(kwargs):
    """A mesh is not ported; int8 is, and raises without its calibration
    frames or scales, as the JAX package's does."""
    if "quantize" in kwargs:
        with pytest.raises(ValueError, match="calib_frames"):
            Predictor(image_size=SIZE, device="cpu", **kwargs)
        return
    with pytest.raises(NotImplementedError, match="not yet ported"):
        Predictor(image_size=SIZE, device="cpu", **kwargs)


def test_cli_writes_masks(tmp_path, frames):
    path = tmp_path / "frame.png"
    Image.fromarray(frames[0]).save(path)
    main([str(path), "--size", "64, 128", "--out", str(tmp_path / "out"),
          "--device", "cpu"])
    mask = np.asarray(Image.open(tmp_path / "out" / "frame_mask.png"))
    assert mask.shape == SIZE and mask.max() < 19
    with pytest.raises(SystemExit):
        main([str(path), "--size", "64, 128", "--checkpoint", "ckpt",
              "--device", "cpu"])
    # a frame at another size than --size is resized on the host
    main([str(path), "--size", "32, 64", "--out", str(tmp_path / "small"),
          "--device", "cpu"])
    mask = np.asarray(Image.open(tmp_path / "small" / "frame_mask.png"))
    assert mask.shape == (32, 64) and mask.max() < 19
