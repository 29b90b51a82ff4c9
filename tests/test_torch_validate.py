"""The port's validation loop against the JAX package's, same weights and
batches, in f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsds_tpu.eval.validate import make_eval_step as jax_make_eval_step
from rtsds_tpu.eval.validate import validate as jax_validate
from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
from rtsds_tpu.ops.preprocess import normalize as jax_normalize
from rtsds_tpu_torch.callbacks.base import Callback
from rtsds_tpu_torch.data.synthetic import SyntheticSegDataset
from rtsds_tpu_torch.eval.validate import make_eval_step, val_GTA5, validate
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.pretrained import load_flax_variables
from rtsds_tpu_torch.utils.colors import CLASS_NAMES
from rtsds_tpu_torch.utils.metrics import fast_hist

SIZE = (64, 128)


@pytest.fixture(scope="module")
def setup():
    flax_model = FlaxBiSeNet(num_classes=19)
    variables = jax.tree_util.tree_map(np.asarray, flax_model.init(
        jax.random.key(0), jnp.zeros((1, *SIZE, 3), jnp.float32),
        train=False))
    ds = SyntheticSegDataset(4, SIZE, seed=1, fixed_tints=True)
    batches = []
    for b in range(2):
        images = np.stack([ds[2 * b + i][0] for i in range(2)])
        labels = np.stack([ds[2 * b + i][1] for i in range(2)])
        labels[:, :4] = 255  # a band of void pixels
        batches.append((np.array(jax_normalize(jnp.asarray(images))),
                        labels))
    return flax_model, variables, batches


def test_miou_matches_jax(setup):
    flax_model, variables, batches = setup
    step = jax_make_eval_step(flax_model.apply, 19)
    want, _ = jax_validate(
        variables, iter([(jnp.asarray(x), jnp.asarray(y))
                         for x, y in batches]), 19, eval_step=step)

    model = load_flax_variables(BiSeNet(), variables)
    inner = make_eval_step(model.eval(), 19, return_preds=True)
    steps = []

    def checked_step(images, labels, hist):
        new_hist, preds = inner(images, labels, hist)
        assert torch.equal(new_hist - hist, fast_hist(labels, preds, 19))
        steps.append(int((new_hist - hist).sum()))
        return new_hist, preds

    got, _ = validate(model, iter(batches), 19, eval_step=checked_step,
                      device="cpu")
    assert abs(got - want) <= 1e-3
    assert steps == [int((y < 19).sum()) for _, y in batches]


class _Recorder(Callback):
    def __init__(self):
        self.batch_losses, self.end, self.samples = [], None, []

    def on_validation_batch_end(self, batch, logs=None):
        self.batch_losses.append(logs)

    def on_validation_end(self, logs=None, data=None):
        self.end = (logs, data)

    def set_epoch(self, epoch):
        self.epoch = epoch

    def add_sample(self, inputs, targets, preds):
        self.samples.append((inputs.shape, targets.shape, preds.shape))


def test_val_gta5_reports_every_class(setup, capsys):
    _, variables, batches = setup
    model = load_flax_variables(BiSeNet(), variables).train()
    rec = _Recorder()
    miou, per_class = val_GTA5(2, model, iter(batches), 19, CLASS_NAMES,
                               callbacks=[rec], device="cpu")
    assert [name for name, _ in per_class] == CLASS_NAMES
    assert model.training  # the caller's mode is restored
    assert len(rec.batch_losses) == 2
    assert all(0.0 <= loss <= 1.0 for loss in rec.batch_losses)
    assert rec.end[0] == {"validation_mIoU": miou} and rec.end[1] == per_class
    assert rec.samples == [((2, *SIZE, 3), (2, *SIZE), (2, *SIZE))] * 2
    out = capsys.readouterr().out
    assert "Validation mIoU for Epoch 3" in out and "traffic light" in out
