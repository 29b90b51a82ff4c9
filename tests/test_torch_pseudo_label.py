"""The port's offline pseudo-label sweep (``rtsds_tpu_torch/pseudo_label.py``)
against the JAX package's (``rtsds_tpu/pseudo_label.py``).

Tolerances:
  * the label path plan and its refusals: exactly JAX's;
  * the float32 sweep of the same weights: at least 99% of the written
    label pixels equal to JAX's, and the coverage within 0.01 (a pixel
    whose confidence sits within rounding of the threshold, or whose top
    two logits tie within rounding, can go either way);
  * the in-memory core: its uint8 masks exactly ``pseudo_labels`` of the
    model's logits;
  * the int8 sweep with CBST thresholds: the thresholds those of
    ``calibrate_class_thresholds`` on the int8 model, exactly.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from realdata_fixtures import make_cityscapes_tree
from rtsds_tpu import pseudo_label as jax_pl
from rtsds_tpu.callbacks.checkpoint import CheckpointManager as JaxManager
from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
from rtsds_tpu.train.optim import make_optimizer as jax_make_optimizer
from rtsds_tpu.train.state import create_train_state
from rtsds_tpu_torch import pseudo_label
from rtsds_tpu_torch.callbacks.checkpoint import CheckpointManager
from rtsds_tpu_torch.data.indexing import build_cityscapes_index
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.pretrained import load_flax_variables
from rtsds_tpu_torch.ops.preprocess import normalize
from rtsds_tpu_torch.ops.quant import QuantizedSegmentor
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.self_training import (
    calibrate_class_thresholds, pseudo_labels)
from rtsds_tpu_torch.train.state import TrainState

HW = (32, 64)          # inference size
DISK = (48, 96)        # the fixture images' size on disk


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A Cityscapes-layout tree, and the same BiSeNet weights as a JAX
    checkpoint and as a port checkpoint."""
    root = tmp_path_factory.mktemp("pl")
    dirs = make_cityscapes_tree(str(root / "cs"), n_train=5, n_val=2,
                                disk_size=DISK)
    state = create_train_state(
        FlaxBiSeNet(num_classes=19, context_path="resnet18",
                    output_f32=False),
        jax.random.key(0), jnp.zeros((1, *HW, 3)),
        jax_make_optimizer("Adam", 0.01))
    mgr = JaxManager(str(root / "jax_ckpt"))
    mgr.save(1, {"model": state}, monitor=0.5)
    mgr.close()
    variables = jax.tree_util.tree_map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats})
    model = load_flax_variables(BiSeNet(), variables)
    CheckpointManager(str(root / "ckpt")).save(1, {"model": TrainState(
        model, make_optimizer("SGD", model.parameters(), 0.01))},
        monitor=0.5)
    return {"root": root, "images": dirs["images_train_dir"],
            "jax_ckpt": str(root / "jax_ckpt"), "ckpt": str(root / "ckpt")}


def test_label_plan_and_refusals_match_jax(tmp_path):
    images = str(tmp_path / "img")
    paths = [os.path.join(images, "a", "aachen_000001_000019_leftImg8bit.png"),
             os.path.join(images, "b", "bochum_000002_000019_x.png")]
    want = jax_pl._plan_label_paths(str(tmp_path / "out"), images, paths)
    assert pseudo_label._plan_label_paths(str(tmp_path / "out"), images,
                                          paths) == want
    for bad in ([paths[0], paths[0].replace("leftImg8bit", "other")],
                [os.path.join(images, "aachen_000001_000019.png")]):
        with pytest.raises(SystemExit) as theirs:
            jax_pl._plan_label_paths(str(tmp_path), images, bad)
        with pytest.raises(SystemExit) as ours:
            pseudo_label._plan_label_paths(str(tmp_path), images, bad)
        assert str(ours.value) == str(theirs.value)


def _labels(out, images):
    return {os.path.basename(s.image): np.asarray(Image.open(s.label))
            for s in build_cityscapes_index(out, images)}


def test_float_sweep_matches_jax(setup):
    s = setup
    kwargs = dict(image_size=HW, batch_size=2, threshold=0.5)
    want = jax_pl.generate_pseudo_labels(
        s["jax_ckpt"], s["images"], str(s["root"] / "jax_out"), **kwargs)
    got = pseudo_label.generate_pseudo_labels(
        s["ckpt"], s["images"], str(s["root"] / "out"), device="cpu",
        **kwargs)
    assert set(got) == set(want)
    assert got["images"] == want["images"] == 5
    assert got["coverage"] == pytest.approx(want["coverage"], abs=0.01)
    assert got["threshold"] == want["threshold"]
    theirs = _labels(str(s["root"] / "jax_out"), s["images"])
    ours = _labels(str(s["root"] / "out"), s["images"])
    assert set(ours) == set(theirs) and len(ours) == 5
    for name, mask in ours.items():
        assert mask.shape == DISK and mask.dtype == np.uint8
    agree = np.mean([(ours[k] == theirs[k]).mean() for k in ours])
    assert agree >= 0.99, agree


def test_in_memory_core_is_pseudo_labels_of_the_logits(setup):
    from rtsds_tpu_torch.serve import load_checkpoint_state

    state = load_checkpoint_state(setup["ckpt"])
    frames = np.random.default_rng(0).integers(0, 256, (2, *HW, 3),
                                               dtype=np.uint8)
    model, thr = pseudo_label.sweep_model("bisenet", state, [frames],
                                          calibrate=True, device="cpu")
    masks = pseudo_label.infer_masks(model, torch.from_numpy(frames), thr)
    with torch.no_grad():
        logits = model(normalize(torch.from_numpy(frames)).permute(0, 3, 1, 2))
    want, _ = pseudo_labels(logits, thr, 19)
    assert masks.dtype == torch.uint8
    assert torch.equal(masks, want.to(torch.uint8))


def test_int8_sweep_with_cbst_thresholds(setup):
    from rtsds_tpu_torch.data.pipeline import decode_image
    from rtsds_tpu_torch.serve import load_checkpoint_state

    s = setup
    stats = pseudo_label.generate_pseudo_labels(
        s["ckpt"], s["images"], str(s["root"] / "out_q8"), image_size=HW,
        batch_size=2, quantize="int8", calibrate=True, calib_batches=1,
        device="cpu")
    assert stats["quantize"] == "int8" and stats["images"] == 5
    frames = np.stack([decode_image(p, HW) for p in
                       pseudo_label._image_paths(s["images"])[:2]])
    model, thr = pseudo_label.sweep_model(
        "bisenet", load_checkpoint_state(s["ckpt"]), [frames],
        quantize="int8", calibrate=True, device="cpu")
    assert isinstance(model, QuantizedSegmentor)
    want = calibrate_class_thresholds(
        model, [normalize(torch.from_numpy(frames))], 19)
    np.testing.assert_array_equal(thr, want)
    assert stats["threshold"] == np.asarray(want).round(4).tolist()
    ours = _labels(str(s["root"] / "out_q8"), s["images"])
    assert len(ours) == 5 and all(m.shape == DISK for m in ours.values())


def test_cli_and_refusals(setup, tmp_path, capsys):
    s = setup
    out = str(tmp_path / "cli")
    pseudo_label.main(["--checkpoint_dir", s["ckpt"], "--images",
                       s["images"], "--out", out, "--size", "32, 64",
                       "--batch", "2", "--threshold", "0.0", "--model_res",
                       "--device", "cpu"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["coverage"] == 1.0 and stats["images"] == 5
    assert all(m.shape == HW for m in _labels(out, s["images"]).values())
    with pytest.raises(SystemExit, match="no .png images"):
        pseudo_label.generate_pseudo_labels(s["ckpt"], str(tmp_path / "e"),
                                            out, device="cpu")
    with pytest.raises(SystemExit, match="not supported"):
        pseudo_label.generate_pseudo_labels(s["ckpt"], s["images"], out,
                                            quantize="int4", device="cpu")
    with pytest.raises(SystemExit, match="uint8"):
        pseudo_label.generate_pseudo_labels(s["ckpt"], s["images"], out,
                                            ignore_index=300, device="cpu")
