"""The port's pipe axis: the GPipe schedule (``parallel/pipeline.py``) and
the pipelined DeepLabV2 step (``train/pipelined.py``), on stage devices
that are all the CPU.

* ``pipeline_apply`` equals the blocks applied in sequence (eval mode), and
  in train mode the schedule advances each block's BatchNorm statistics as
  a loop over the microbatches does; M < P, M = P and M > P.
* The pipelined step of a thin DeepLabV2 ((1, 1, 3, 1): two homogeneous
  layer3 blocks over two stages) in float64 equals the port's accumulating
  step over the same M microbatches: the loss, the parameters and the BN
  running statistics at rtol 1e-9 (atol 1e-12), for M = 2 and M = 4; and
  JAX's ``make_pipelined_train_step`` on a 2-device pipe mesh at rtol 1e-6
  / atol 1e-10, with M = 4.
* The CLI with ``mesh: {pipe: 2}`` trains DeepLabV2-R101 through the
  pipelined step and validates the placed model, and refuses what the JAX
  CLI refuses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from rtsds_tpu.models.deeplabv2 import DeepLabV2 as FlaxDeepLab
from rtsds_tpu.models.deeplabv2 import frozen_bn_mask
from rtsds_tpu.parallel.mesh import make_mesh_from_config as jax_mesh_config
from rtsds_tpu.train.optim import make_optimizer as jax_make_optimizer
from rtsds_tpu.train.pipelined import (
    make_pipelined_train_step as jax_pipelined_step)
from rtsds_tpu.train.state import TrainState as JaxTrainState
from rtsds_tpu_torch import cli
from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2, frozen_bn_parameters
from rtsds_tpu_torch.models.pretrained import state_dict_from_flax
from rtsds_tpu_torch.parallel.mesh import Mesh
from rtsds_tpu_torch.parallel.pipeline import (
    pipeline_apply, pipeline_apply_stateful, place_stages)
from rtsds_tpu_torch.train import pipelined
from rtsds_tpu_torch.train.accumulate import (
    make_accumulating_train_step, split_microbatches)
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.state import TrainState
from test_torch_deeplab import flax_tree
from test_torch_multihost import _config_with

PIPE_LAYERS = (1, 1, 3, 1)
SIZE = (32, 48)
LR = 0.01


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _blocks(n: int) -> list:
    torch.manual_seed(0)
    return [nn.Sequential(nn.Conv2d(4, 4, 3, padding=1), nn.BatchNorm2d(4),
                          nn.ReLU()).double() for _ in range(n)]


@pytest.mark.parametrize("n_blocks,stages,micro", [
    (4, 2, 1), (4, 2, 2), (4, 2, 4), (4, 4, 2), (6, 3, 6)])
def test_pipeline_apply_equals_the_blocks_in_sequence(n_blocks, stages,
                                                      micro):
    blocks = _blocks(n_blocks)
    for b in blocks:
        b.eval()
    mesh = Mesh(["cpu"] * stages, ("pipe",))
    place_stages(blocks, mesh)
    x = torch.randn(6 if micro != 4 else 8, 4, 5, 7, dtype=torch.float64)
    want = x
    for b in blocks:
        want = b(want)
    got = pipeline_apply(blocks, x, mesh, num_microbatches=micro)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("stages,micro", [(2, 3), (3, 2)])
def test_the_schedule_advances_bn_statistics_in_microbatch_order(stages,
                                                                micro):
    blocks, loop = _blocks(6), _blocks(6)
    mesh = Mesh(["cpu"] * stages, ("pipe",))
    place_stages(blocks, mesh)
    xs = list(torch.randn(micro, 2, 4, 5, 7, dtype=torch.float64))
    got = pipeline_apply_stateful(blocks, xs, mesh)
    for k, x in enumerate(xs):
        for b in loop:
            x = b(x)
        torch.testing.assert_close(got[k], x, rtol=1e-12, atol=1e-14)
    for b, want in zip(blocks, loop):
        for k, v in want.state_dict().items():
            torch.testing.assert_close(b.state_dict()[k], v, rtol=1e-12,
                                       atol=1e-14)


def test_blocks_that_do_not_split_over_the_stages_are_refused():
    with pytest.raises(ValueError, match="5 blocks do not split over 2"):
        place_stages(_blocks(5), Mesh(["cpu", "cpu"], ("pipe",)))
    with pytest.raises(ValueError, match="valid pipe sizes: \\[1, 2\\]"):
        pipelined.make_pipelined_train_step(
            DeepLabV2(layers=PIPE_LAYERS), Mesh(["cpu"] * 3, ("pipe",)))
    with pytest.raises(ValueError, match="DeepLabV2 only"):
        pipelined.make_pipelined_train_step(
            nn.Linear(2, 2), Mesh(["cpu"] * 2, ("pipe",)))


# --- the pipelined DeepLab step --------------------------------------------

@pytest.fixture(scope="module")
def tree():
    v = flax_tree(PIPE_LAYERS, (1, *SIZE, 3), seed=3)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)


def _batch():
    rng = np.random.default_rng(4)
    images = rng.normal(size=(4, *SIZE, 3))
    labels = rng.integers(0, 20, size=(4, *SIZE)).astype(np.int64)
    return images, labels


def _port_state(tree) -> TrainState:
    model = DeepLabV2(layers=PIPE_LAYERS).double()
    model.load_state_dict(state_dict_from_flax(tree))
    return TrainState(model, make_optimizer(
        "SGD", model.parameters(), LR, momentum=0.9,
        frozen=frozen_bn_parameters(model)))


def _pipelined(tree, micro: int):
    state = _port_state(tree)
    step = pipelined.make_pipelined_train_step(
        state.model, Mesh(["cpu", "cpu"], ("pipe",)), ignore_index=19,
        num_microbatches=micro)
    images, labels = _batch()
    metrics = step(state, torch.from_numpy(images), torch.from_numpy(labels))
    return metrics, state


@pytest.mark.parametrize("micro", [2, 4])
def test_pipelined_step_equals_the_accumulating_step(tree, micro):
    got_metrics, got = _pipelined(tree, micro)
    want = _port_state(tree)
    images, labels = _batch()
    want_metrics = make_accumulating_train_step(19)(
        want, split_microbatches(torch.from_numpy(images), micro),
        split_microbatches(torch.from_numpy(labels), micro))
    np.testing.assert_allclose(float(got_metrics["train_loss"]),
                               float(want_metrics["train_loss"]), rtol=1e-9)
    assert int(got_metrics["correct"]) == int(want_metrics["correct"])
    assert got_metrics["total"] == want_metrics["total"]
    assert got.step == want.step == 1
    new, ref = got.model.state_dict(), want.model.state_dict()
    for k in ref:
        np.testing.assert_allclose(new[k].numpy(), ref[k].numpy(),
                                   rtol=1e-9, atol=1e-12, err_msg=k)
    # the plain forward of the placed model still runs
    got.model.eval()
    with torch.no_grad():
        out = got.model(torch.from_numpy(images[:1]).permute(0, 3, 1, 2))
    assert out.shape == (1, 19, *SIZE)


def test_pipelined_step_matches_jax_on_a_pipe_mesh(tree):
    micro = 4
    images, labels = _batch()
    mesh = jax_mesh_config({"pipe": 2}, devices=jax.devices()[:2])
    tx = jax_make_optimizer("SGD", LR, momentum=0.9,
                            frozen_mask=frozen_bn_mask)
    model = FlaxDeepLab(num_classes=19, layers=PIPE_LAYERS)
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(jnp.asarray, tree["params"])
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                               tree["batch_stats"]),
            opt_state=tx.init(params), apply_fn=model.apply, tx=tx)
        step = jax_pipelined_step(model, mesh, ignore_index=19,
                                  num_microbatches=micro, donate=False)
        new, metrics = step(state, jnp.asarray(images),
                            jnp.asarray(labels, jnp.int32))
        after = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            {"params": new.params, "batch_stats": new.batch_stats})
    got_metrics, got = _pipelined(tree, micro)
    np.testing.assert_allclose(float(got_metrics["train_loss"]),
                               float(metrics["train_loss"]), rtol=1e-6)
    assert int(got_metrics["correct"]) == int(metrics["correct"])
    new_sd = got.model.state_dict()
    for k, v in state_dict_from_flax(after).items():
        np.testing.assert_allclose(new_sd[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-10, err_msg=k)


# --- the CLI ---------------------------------------------------------------

def test_cli_trains_deeplab_through_the_pipe(tmp_path, monkeypatch):
    monkeypatch.setenv("RTSDS_CPU_DEVICES", "2")
    made = []
    real = pipelined.make_pipelined_train_step

    def recorded(model, mesh, **kwargs):
        made.append((mesh.axis_names, mesh.size, kwargs["num_microbatches"]))
        return real(model, mesh, **kwargs)

    monkeypatch.setattr(pipelined, "make_pipelined_train_step", recorded)
    config = _config_with(tmp_path, {"mesh": {"pipe": 2}})
    history = cli.main(["--config", config, "--synthetic", "--dataset",
                        "gta5", "--model", "deeplab"])
    assert made == [(("pipe",), 2, 2)]
    assert [e["epoch"] for e in history] == [0]
    assert np.isfinite(history[0]["train_loss"])
    assert 0.0 <= history[0]["validation_mIoU"] <= 1.0


@pytest.mark.parametrize("argv,extra,match", [
    (["--model", "bisenet"], {}, "--model deeplab required"),
    (["--domain_adaptation"], {}, "supports supervised DeepLab training "
                                  "only"),
    ([], {"training": {"segmentation": {"accumulate_steps": 2}}},
     "set training.segmentation.pipe_microbatches instead"),
    ([], {"training": {"segmentation": {"distillation": {
        "enabled": True, "teacher": {"checkpoint_dir": "t"}}}}},
     "does not compose with distillation"),
    ([], {"model": {"deeplab": {"bn_eval": True}}},
     "does not support model.deeplab.bn_eval"),
    ([], {"training": {"segmentation": {"pipe_microbatches": 0}}},
     "must be >= 1"),
    ([], {"training": {"segmentation": {"pipe_microbatches": 3}}},
     "batch_size 4 does not split into 3 pipeline microbatches"),
    ([], {"mesh": {"pipe": 3},
          "training": {"segmentation": {"pipe_microbatches": 2}}},
     "valid pipe sizes: \\[1, 2, 11, 22\\]"),
    ([], {"mesh": {"pipe": 4}}, "needs 4 devices, have 3"),
], ids=["bisenet", "domain_adaptation", "accumulate", "distillation",
        "bn_eval", "zero_microbatches", "indivisible_batch", "pipe_3",
        "too_few_devices"])
def test_cli_pipe_refusals(tmp_path, monkeypatch, argv, extra, match):
    monkeypatch.setenv("RTSDS_CPU_DEVICES", "3")
    mesh = extra.pop("mesh", {"pipe": 2})
    config = _config_with(tmp_path, {**extra, "mesh": mesh})
    with pytest.raises((SystemExit, ValueError), match=match):
        cli.main(["--config", config, "--synthetic", "--dataset", "gta5",
                  "--model", "deeplab", *argv])
