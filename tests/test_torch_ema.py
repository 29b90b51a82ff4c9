"""The port's EMA of the weights against the JAX package's, and in the
training loops: the supervised and DA fits validate on the EMA, write it as
the checkpoint's ``ema`` item and restore it on ``--resume``; a checkpoint
without one restores the model and restarts the EMA from its parameters,
as the JAX CLI does.

``ema_update`` is held to ``rtsds_tpu.train.ema.ema_update`` in float32 at
rtol 1e-6 / atol 1e-7: both compute ``d * e + (1 - d) * p`` in float32, and
may round the sum once or twice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from rtsds_tpu.train.ema import ema_update as jax_ema_update
from rtsds_tpu_torch import cli
from rtsds_tpu_torch.models.pretrained import ema_from_flax
from rtsds_tpu_torch.train.ema import (
    EMA, ema_init, ema_update, ema_weights, setup_ema, warmup_decay)
from rtsds_tpu_torch.train.loop import supervised_fit
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.state import TrainState
from rtsds_tpu_torch.train.supervised import make_train_step
from test_torch_cli import (  # noqa: F401 -- a fixture
    _config, _da_config, drop_checkpoints)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _trees(rng):
    shapes = {"conv.weight": (8, 3, 3, 3), "bn.weight": (8,),
              "head.bias": (19,)}
    ema = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    return ema, params


@pytest.mark.parametrize("step", [0, 1, 1000, None])
def test_ema_update_matches_jax_in_float32(rng, step):
    ema, params = _trees(rng)
    want = jax_ema_update(jax.tree_util.tree_map(jnp.asarray, ema),
                          jax.tree_util.tree_map(jnp.asarray, params),
                          decay=0.999, step=step)
    got = {k: torch.from_numpy(v.copy()) for k, v in ema.items()}
    out = ema_update(got, {k: torch.from_numpy(v) for k, v in params.items()},
                     0.999, step)
    assert out is got
    for k in ema:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_ema_update_of_float64_weights_computes_in_float32(rng):
    """As the JAX package does: the float64 EMA moves by the float32 sum,
    cast back."""
    ema, params = _trees(rng)
    e64 = {k: torch.from_numpy(v.astype(np.float64)) for k, v in ema.items()}
    p64 = {k: torch.from_numpy(v.astype(np.float64))
           for k, v in params.items()}
    ema_update(e64, p64, 0.99, 5)
    with jax.enable_x64(True):
        want = jax_ema_update(
            {k: jnp.asarray(v, jnp.float64) for k, v in ema.items()},
            {k: jnp.asarray(v, jnp.float64) for k, v in params.items()},
            decay=0.99, step=5)
        want = {k: np.asarray(v) for k, v in want.items()}
    for k in ema:
        assert e64[k].dtype == torch.float64
        np.testing.assert_allclose(e64[k].numpy(), want[k], rtol=1e-7,
                                   atol=1e-8, err_msg=k)


def test_warmup_decay():
    assert warmup_decay(0.999, 0) == np.float32(0.1)
    assert warmup_decay(0.999, 1000) == (np.float32(1001.0)
                                         / np.float32(1010.0))
    assert warmup_decay(0.9, 10 ** 6) == np.float32(0.9)
    assert warmup_decay(0.999) == np.float32(0.999)


class _Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3, padding=1)
        self.bn = nn.BatchNorm2d(4)
        self.head = nn.Conv2d(4, 19, 1)

    def forward(self, x):
        out = self.head(torch.relu(self.bn(self.conv(x))))
        return (out, None, None) if self.training else out


def test_buffers_are_never_averaged():
    torch.manual_seed(0)
    net = _Net()
    ema = ema_init(net)
    assert sorted(ema) == sorted(k for k, _ in net.named_parameters())
    assert not any("running" in k or "num_batches" in k for k in ema)
    # a copy, not an alias
    ema["conv.weight"].add_(1.0)
    assert not torch.equal(ema["conv.weight"], net.conv.weight)


def test_ema_weights_swaps_parameters_only_and_back():
    torch.manual_seed(0)
    net = _Net().eval()
    net.bn.running_mean.fill_(0.3)
    ema = {k: torch.randn_like(p) for k, p in net.named_parameters()}
    own = {k: p.detach().clone() for k, p in net.named_parameters()}
    x = torch.randn((1, 3, 8, 8))
    twin = _Net().eval()
    twin.load_state_dict({**net.state_dict(), **ema})
    with ema_weights(net, ema):
        got = net(x)
        assert torch.equal(net.bn.running_mean, torch.full((4,), 0.3))
    torch.testing.assert_close(got, twin(x), rtol=0, atol=0)
    for k, p in net.named_parameters():
        assert torch.equal(p, own[k]), k
    with pytest.raises(KeyError, match="names differ"):
        with ema_weights(net, {"conv.weight": ema["conv.weight"]}):
            pass


def test_ema_item_round_trips_and_refuses_other_shapes():
    torch.manual_seed(0)
    net = _Net()
    ema = setup_ema(net)
    state = ema.state_dict()
    assert sorted(state) == ["params"]
    other = EMA({k: torch.zeros_like(v) for k, v in ema.params.items()})
    other.load_state_dict(state)
    for k in ema.params:
        assert torch.equal(other.params[k], ema.params[k])
    with pytest.raises(RuntimeError, match="size mismatch"):
        other.load_state_dict({"params": {**state["params"],
                                          "head.bias": torch.zeros(3)}})
    seeded = setup_ema(net, {k: v.double() for k, v in state["params"].items()})
    assert seeded.params["conv.weight"].dtype == torch.float32


def test_flax_params_tree_maps_to_the_ema_dict(rng):
    tree = {"conv": {"kernel": rng.normal(size=(3, 3, 3, 4)),
                     "bias": rng.normal(size=(4,))},
            "layer2_1": {"bn1": {"scale": rng.normal(size=(4,)),
                                 "bias": rng.normal(size=(4,))}}}
    got = ema_from_flax(tree)
    assert sorted(got) == ["conv.bias", "conv.weight", "layer2.1.bn1.bias",
                           "layer2.1.bn1.weight"]
    np.testing.assert_array_equal(got["conv.weight"].numpy(),
                                  tree["conv"]["kernel"].transpose(3, 2, 0, 1))


def test_supervised_fit_validates_on_the_ema():
    """Each validation batch sees the EMA's weights and the model's own BN
    buffers, and the model's weights after the fit are its own."""
    torch.manual_seed(0)
    net = _Net()
    state = TrainState(net, make_optimizer("SGD", net.parameters(), 0.5))
    g = torch.Generator().manual_seed(0)
    batch = (torch.randn((2, 8, 8, 3), generator=g),
             torch.randint(0, 19, (2, 8, 8), generator=g))
    seen = []

    def eval_step(images, labels, hist):
        seen.append({k: p.detach().clone()
                     for k, p in net.named_parameters()})
        return hist

    want = ema_init(net)
    _, history = supervised_fit(
        state, make_train_step(19), lambda e: [batch], lambda e: [batch],
        epochs=2, num_classes=19, device="cpu", eval_step=eval_step,
        ema_decay=0.9)
    assert len(seen) == 2 and len(history) == 2
    # the EMA after the two steps, replayed by hand from the parameters
    torch.manual_seed(0)
    net2 = _Net()
    replay = TrainState(net2, make_optimizer("SGD", net2.parameters(), 0.5))
    step = make_train_step(19)
    for _ in range(2):
        step(replay, *batch)
        ema_update(want, net2, 0.9, replay.step)
    for k, p in net.named_parameters():
        torch.testing.assert_close(seen[1][k], want[k], rtol=0, atol=0)
        assert torch.equal(p, dict(net2.named_parameters())[k])
    assert not torch.equal(seen[1]["head.weight"], net.head.weight)


def _ema_config(tmp_path, da=False):
    if da:
        return _da_config(tmp_path, ", ema: {enabled: true, decay: 0.9}")
    config = _config(tmp_path)
    text = (tmp_path / "config.yaml").read_text().replace(
        "segmentation: {epochs: 2, do_validation: 1}",
        "segmentation: {epochs: 1, do_validation: 1, "
        "ema: {enabled: true, decay: 0.9}}")
    (tmp_path / "config.yaml").write_text(text)
    return config


@pytest.mark.parametrize("da", [False, True])
@pytest.mark.usefixtures("drop_checkpoints")
def test_cli_writes_restores_and_validates_on_the_ema(tmp_path, capsys,
                                                      monkeypatch, da):
    config = _ema_config(tmp_path, da)
    flags = ["--config", config, "--synthetic"] + (
        ["--domain_adaptation"] if da else [])
    history = cli.main(flags)
    assert len(history) == 1
    run = tmp_path / "ckpt" / ("m_da" if da else "m")
    saved = torch.load(run / "epoch_0.pt", weights_only=True)
    net = "generator" if da else "model"
    assert "ema" in saved
    model_params = saved[net]["model"]
    ema = saved["ema"]["params"]
    assert sorted(ema) == sorted(k for k in model_params
                                 if "running_" not in k
                                 and "num_batches" not in k)
    assert any(not torch.equal(ema[k], model_params[k]) for k in ema)

    # --validate_only validates the EMA: the mIoU the run reported
    miou = cli.main(flags + ["--validate_only"])
    assert miou == pytest.approx(history[0]["validation_mIoU"], abs=1e-9)

    # --resume restores the stored EMA exactly before the next epoch
    longer = tmp_path / "longer.yaml"
    longer.write_text((tmp_path / "config.yaml").read_text().replace(
        "epochs: 1", "epochs: 2"))
    restored = {}

    def spy(model, seed=None):
        if seed is not None:
            restored.update({k: v.clone() for k, v in seed.items()})
        return setup_ema(model, seed)

    monkeypatch.setattr("rtsds_tpu_torch.train.loop.setup_ema", spy)
    history = cli.main(["--config", str(longer)] + flags[2:] + ["--resume"])
    assert [h["epoch"] for h in history] == [1]
    assert "Resuming from epoch 1" in capsys.readouterr().out
    assert sorted(restored) == sorted(ema)
    for k in ema:
        assert torch.equal(restored[k], ema[k]), k


@pytest.mark.usefixtures("drop_checkpoints")
def test_checkpoint_without_ema_restores_the_model_and_restarts_the_ema(
        tmp_path, capsys, monkeypatch):
    """A run saved without EMA, resumed with EMA on: the model is restored
    and the EMA starts from its restored parameters."""
    plain = _config(tmp_path)
    text = (tmp_path / "config.yaml").read_text().replace(
        "epochs: 2", "epochs: 1")
    (tmp_path / "config.yaml").write_text(text)
    cli.main(["--config", plain, "--synthetic"])
    saved = torch.load(tmp_path / "ckpt" / "m" / "epoch_0.pt",
                       weights_only=True)
    assert "ema" not in saved

    seeds = []

    def spy(model, seed=None):
        seeds.append(seed)
        ema = setup_ema(model, seed)
        seeds.append({k: v.clone() for k, v in ema.params.items()})
        return ema

    monkeypatch.setattr("rtsds_tpu_torch.train.loop.setup_ema", spy)
    ema_cfg = tmp_path / "ema.yaml"
    ema_cfg.write_text(text.replace(
        "segmentation: {epochs: 1, do_validation: 1}",
        "segmentation: {epochs: 2, do_validation: 1, ema: {enabled: true}}"))
    history = cli.main(["--config", str(ema_cfg), "--synthetic", "--resume"])
    assert [h["epoch"] for h in history] == [1]
    assert "Resuming from epoch 1" in capsys.readouterr().out
    assert seeds[0] is None  # no stored EMA: it restarts ...
    for k, v in seeds[1].items():  # ... from the restored parameters
        assert torch.equal(v, saved["model"]["model"][k]), k
