"""The port's checkpoint tools: ``ckpt_info`` (what a checkpoint directory
holds) and ``export_torch`` (a checkpoint's weights in the reference
models' layouts), held against the JAX package's ``ckpt_info`` and
``export_torch`` on the same information and the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsds_tpu.ckpt_info import format_report as jax_format_report
from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
from rtsds_tpu.models.pretrained import (
    export_reference_bisenet_state_dict, export_torch_state_dict)
from rtsds_tpu_torch import ckpt_info, export_torch
from rtsds_tpu_torch.callbacks.checkpoint import CheckpointManager
from rtsds_tpu_torch.ckpt_info import describe_checkpoint, format_report
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2
from rtsds_tpu_torch.models.pretrained import load_flax_variables
from rtsds_tpu_torch.train.distill import load_teacher
from rtsds_tpu_torch.train.ema import EMA, ema_init
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.state import TrainState
from test_torch_deeplab import THIN, flax_tree


def _state(model):
    return TrainState(model, make_optimizer("SGD", model.parameters(), 0.01))


def _make_ckpts(tmp_path):
    """A DA run's directory: epochs 0 and 2 of a generator and a
    discriminator, monitored 0.25 and 0.5."""
    d = tmp_path / "m_da"
    mgr = CheckpointManager(str(d))
    torch.manual_seed(0)
    states = {"generator": _state(torch.nn.Linear(2, 2)),
              "discriminator": _state(torch.nn.Linear(2, 1))}
    mgr.save(0, states, monitor=0.25)
    mgr.save(2, states, monitor=0.5)
    return str(d)


def test_describe_checkpoint(tmp_path):
    info = describe_checkpoint(_make_ckpts(tmp_path))
    assert [r["step"] for r in info["steps"]] == [0, 2]
    assert info["best_step"] == 2 and info["latest_step"] == 2
    assert info["emergency_step"] is None
    assert info["steps"][0]["items"] == ["discriminator", "generator"]
    np.testing.assert_allclose(info["steps"][0]["monitor"], 0.25)


def test_describe_checkpoint_best_latest_and_no_monitor(tmp_path):
    """A supervised run with an EMA: the best epoch is not the latest, and
    an epoch saved without a monitored value reports none."""
    mgr = CheckpointManager(str(tmp_path / "m"), max_to_keep=5)
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    states = {"model": _state(model), "ema": EMA(ema_init(model))}
    mgr.save(0, states, monitor=0.7)
    mgr.save(1, states, monitor=0.4)
    mgr.save(2, {"model": _state(model)})
    info = describe_checkpoint(str(tmp_path / "m"))
    assert [(r["step"], r["items"], r["monitor"]) for r in info["steps"]] \
        == [(0, ["ema", "model"], 0.7), (1, ["ema", "model"], 0.4),
            (2, ["model"], None)]
    assert info["best_step"] == 0 and info["latest_step"] == 2
    report = format_report("m", info)
    assert "monitor=       -" in report
    assert "<- best" in report and "<- latest" in report


def test_describe_checkpoint_does_not_create_a_missing_directory(tmp_path):
    info = describe_checkpoint(str(tmp_path / "missing"))
    assert info == {"steps": [], "best_step": None, "latest_step": None,
                    "emergency_step": None}
    assert not (tmp_path / "missing").exists()


@pytest.mark.parametrize("emergency", [None, 2])
def test_format_report_is_jaxs(tmp_path, emergency):
    """The same ``info`` dict gives the JAX package's text, the JAX
    package's emergency flag included."""
    info = {**describe_checkpoint(_make_ckpts(tmp_path)),
            "emergency_step": emergency}
    assert format_report("ckpt/m_da", info) == jax_format_report(
        "ckpt/m_da", info)
    assert format_report("x", {"steps": [], "best_step": None,
                               "latest_step": None,
                               "emergency_step": None}) \
        == jax_format_report("x", {"steps": [], "best_step": None,
                                   "latest_step": None,
                                   "emergency_step": None})


def test_cli_main_and_root_descent(tmp_path, capsys):
    _make_ckpts(tmp_path)
    assert ckpt_info.main([str(tmp_path / "m_da")]) == 0
    out = capsys.readouterr().out
    assert "step    0" in out and "step    2" in out
    assert "monitor=  0.5000" in out
    assert "items=[discriminator, generator]" in out
    # a run root: descends into the children that hold checkpoints
    assert ckpt_info.main([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "m_da" in out and "step    2" in out
    empty = tmp_path / "empty"
    empty.mkdir()
    assert ckpt_info.main([str(empty)]) == 1


@pytest.fixture(scope="module")
def bisenet_tree():
    """A Flax BiSeNet-R18 tree with its train-only heads, and an EMA of
    its parameters."""
    variables = jax.tree_util.tree_map(np.asarray, FlaxBiSeNet(
        num_classes=19).init(jax.random.key(2), jnp.zeros((1, 32, 64, 3)),
                             train=True))
    ema = jax.tree_util.tree_map(lambda p: p + np.float32(0.5),
                                 variables["params"])
    return dict(variables), ema


def _save_port_checkpoint(directory, model, ema_params=None):
    states = {"model": _state(model)}
    if ema_params is not None:
        states["ema"] = EMA(ema_params)
    CheckpointManager(str(directory)).save(0, states, monitor=0.5)
    return str(directory)


def _assert_same_state(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)
        assert got[k].dtype == torch.as_tensor(np.asarray(v)).dtype, k


@pytest.mark.parametrize("use_ema", [True, False])
def test_bisenet_export_is_jaxs(tmp_path, bisenet_tree, use_ema):
    """A port checkpoint of the weights of a Flax tree, exported with
    ``--model bisenet``, has exactly the keys and tensors that JAX's
    ``export_reference_bisenet_state_dict`` writes of that tree (the EMA's
    parameters by default, the trained ones with ``--no-ema``)."""
    variables, ema = bisenet_tree
    model = load_flax_variables(BiSeNet(), variables)
    ema_params = load_flax_variables(
        BiSeNet(), {**variables, "params": ema}).state_dict()
    ema_params = {k: ema_params[k] for k, _ in model.named_parameters()}
    path = _save_port_checkpoint(tmp_path / "ckpt", model, ema_params)
    out = str(tmp_path / "bisenet.pth")
    argv = [path, out] + ([] if use_ema else ["--no-ema"])
    assert export_torch.main(argv) == 0
    want = export_reference_bisenet_state_dict(
        {**variables, "params": ema} if use_ema else variables)
    _assert_same_state(torch.load(out, weights_only=True), want)


def test_deeplab_export_with_a_prefix_is_jaxs(tmp_path):
    variables = flax_tree(THIN, (1, 33, 65, 3), seed=3)
    model = load_flax_variables(DeepLabV2(layers=THIN), variables)
    path = _save_port_checkpoint(tmp_path / "ckpt", model)
    out = str(tmp_path / "deeplab.pth")
    n = export_torch.export_checkpoint(path, out, model="deeplab",
                                       prefix="Scale.")
    want = export_torch_state_dict(variables, prefix="Scale.")
    assert n == len(want)
    _assert_same_state(torch.load(out, weights_only=True), want)


def test_raw_export_keeps_the_ports_names(tmp_path):
    torch.manual_seed(0)
    model = BiSeNet()
    path = _save_port_checkpoint(tmp_path / "ckpt", model)
    out = str(tmp_path / "raw.pth")
    export_torch.export_checkpoint(path, out, model="raw", prefix="Scale.")
    got = torch.load(out, weights_only=True)
    assert set(got) == {"Scale." + k for k in model.state_dict()}
    assert any(k.startswith("Scale.spatial_path.") for k in got)


@pytest.mark.parametrize("layout", ["bisenet", "deeplab", "raw"])
def test_load_teacher_reads_an_export_back_exactly(tmp_path, layout):
    """``load_teacher`` on each exported layout gives the checkpoint's EMA
    weights (and its buffers) back, tensor for tensor."""
    torch.manual_seed(1)
    model = BiSeNet()
    ema = {k: v + 1.0 for k, v in ema_init(model).items()}
    path = _save_port_checkpoint(tmp_path / "ckpt", model, ema)
    out = str(tmp_path / f"{layout}.pth")
    export_torch.export_checkpoint(
        path, out, model=layout, prefix="Scale." if layout == "deeplab"
        else "")
    want = {**model.state_dict(), **ema}
    got = load_teacher(out)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
