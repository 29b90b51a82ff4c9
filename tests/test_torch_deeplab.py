"""The port's DeepLabV2 against the Flax model, on the same weights through
the weight bridge.

Eval logits are compared in float32 at rtol 1e-3 / atol 1e-4, the
tolerance of test_golden_deeplab.py, thin ([1, 1, 1, 1]) at 65x97 and at
full depth at 33x65, odd sizes that take the ceil-mode pool's partial
windows.  Train mode (the output and every BN running statistic after one
forward) is compared in float64 at rtol 1e-9 / atol 1e-12, as
test_torch_train.py explains.  remat is held to the step without it
exactly.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rtsds_tpu.models import layers as jax_layers
from rtsds_tpu.models.deeplabv2 import DeepLabV2 as FlaxDeepLab
from rtsds_tpu.models.deeplabv2 import frozen_bn_mask, lr_multiplier_mask
from rtsds_tpu.models.pretrained import (
    convert_torch_state_dict, export_torch_state_dict, merge_pretrained)
from rtsds_tpu_torch.config import load_config
from rtsds_tpu_torch.models import layers
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2, frozen_bn_parameters
from rtsds_tpu_torch.models.pretrained import (
    load_deeplab_pretrained, load_flax_variables, state_dict_from_flax,
    torch_scope)
from rtsds_tpu_torch.ops.losses import segmentation_loss
from rtsds_tpu_torch.train.factory import make_deeplab
from rtsds_tpu_torch.train.optim import head_param_groups

THIN = (1, 1, 1, 1)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def flax_tree(layers_, shape, seed=0):
    """A Flax DeepLabV2 tree (numpy leaves) with BN statistics moved off
    the identity: means ~N(0, 0.1), variances in [0.5, 1.5]."""
    v = FlaxDeepLab(num_classes=19, layers=layers_).init(
        jax.random.key(seed), jnp.zeros(shape, jnp.float32), train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(seed + 1)

    def stat(path, a):
        if path[-1].key == "mean":
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    v["batch_stats"] = jax.tree_util.tree_map_with_path(stat,
                                                        v["batch_stats"])
    return v


def _keys(names):
    return {k for k in names if not k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("layers_,shape", [(THIN, (1, 65, 97, 3)),
                                           ((3, 4, 23, 3), (1, 33, 65, 3))])
def test_eval_logits_match_flax(layers_, shape, rng):
    variables = flax_tree(layers_, shape)
    x = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(FlaxDeepLab(num_classes=19, layers=layers_).apply(
        variables, jnp.asarray(x), train=False))
    model = load_flax_variables(DeepLabV2(layers=layers_), variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-3, atol=1e-4)
    assert np.abs(want).max() > 0.1  # not a dead network
    assert _keys(model.state_dict()) == _keys(export_torch_state_dict(
        variables))


def test_train_mode_output_and_bn_stats_match_flax_in_float64(rng):
    variables = flax_tree(THIN, (2, 33, 65, 3))
    x = rng.normal(size=(2, 33, 65, 3))
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     variables)
        (want, _, _), new = FlaxDeepLab(num_classes=19, layers=THIN).apply(
            v64, jnp.asarray(x), train=True, mutable=["batch_stats"])
        want = np.asarray(want)
        stats = jax.tree_util.tree_map(np.asarray, new["batch_stats"])
    model = DeepLabV2(layers=THIN).double()
    own = model.state_dict()
    for k, v in state_dict_from_flax(variables).items():
        own[k].copy_(v)
    with torch.no_grad():
        got, aux1, aux2 = model.train()(torch.from_numpy(x).permute(0, 3, 1,
                                                                    2))
    assert aux1 is None and aux2 is None and got.dtype == torch.float64
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-9, atol=1e-12)
    state = model.state_dict()
    n = 0
    for k, v in state_dict_from_flax({"batch_stats": stats}).items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-9,
                                   atol=1e-12, err_msg=k)
        n += 1
    assert n == 2 * sum(isinstance(m, torch.nn.BatchNorm2d)
                        for m in model.modules())


def test_bn_eval_uses_and_keeps_the_running_stats(rng):
    """``bn_eval``: train-mode logits equal the eval-mode ones and the Flax
    ``bn_eval`` model's train-mode logits; no running stat moves."""
    variables = flax_tree(THIN, (2, 33, 65, 3))
    x = rng.normal(size=(2, 33, 65, 3)).astype(np.float32)
    (want, _, _), new = FlaxDeepLab(num_classes=19, layers=THIN,
                                    bn_eval=True).apply(
        variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    model = load_flax_variables(DeepLabV2(layers=THIN, bn_eval=True),
                                variables)
    before = copy.deepcopy(model.state_dict())
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got, _, _ = model.train()(xt)
        plain = model.eval()(xt)
    assert model.train().training
    assert not any(m.training for m in model.modules()
                   if isinstance(m, torch.nn.BatchNorm2d))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-3, atol=1e-4)
    assert torch.equal(got, plain)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: bool(np.array_equal(np.asarray(a), b)),
        new["batch_stats"], variables["batch_stats"]))


def _one_step(model, x, labels):
    """One SGD step in train mode: the main logits, the gradients and the
    state after it."""
    opt = torch.optim.SGD(model.parameters(), lr=0.01)
    out = model.train()(x)
    loss = segmentation_loss(out, labels, 19)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    opt.step()
    return out[0].detach(), grads, copy.deepcopy(model.state_dict())


def _remat_models():
    torch.manual_seed(0)
    deeplab = DeepLabV2(layers=(1, 2, 1, 1)).double()
    torch.manual_seed(0)
    bisenet = BiSeNet().double()
    return {"deeplab": (deeplab, (2, 3, 33, 65)),
            "bisenet": (bisenet, (2, 3, 64, 128))}


def _set_remat(model, on):
    for m in model.modules():
        if hasattr(m, "residual"):
            m.remat = on


@pytest.mark.parametrize("name", ["deeplab", "bisenet"])
def test_remat_step_equals_the_step_without_it(name, monkeypatch):
    """Logits, gradients, and every BN running stat and counter after one
    step with remat equal those of the step without it; a plain
    ``checkpoint`` in its place advances the running stats twice."""
    model, shape = _remat_models()[name]
    g = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    labels = torch.randint(0, 20, (shape[0], *shape[2:]), generator=g)
    runs = {}
    for remat in (False, True):
        m = copy.deepcopy(model)
        _set_remat(m, remat)
        runs[remat] = _one_step(m, x, labels)
    (l0, g0, s0), (l1, g1, s1) = runs[False], runs[True]
    assert torch.equal(l0, l1)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-12, atol=1e-15,
                                   msg=k)
    for k in s0:
        assert torch.equal(s1[k], s0[k]), k
    assert int(s1["bn1.num_batches_tracked" if name == "deeplab" else
                  "context_path.bn1.num_batches_tracked"]) == 1

    def plain(module, fn, *args):
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)

    monkeypatch.setattr("rtsds_tpu_torch.models.resnet.rematerialized",
                        plain)
    m = copy.deepcopy(model)
    _set_remat(m, True)
    _, _, s2 = _one_step(m, x, labels)
    twice = [k for k in s0 if "num_batches_tracked" in k
             and int(s2[k]) == 2]
    assert twice and any(not torch.equal(s2[k], s0[k]) for k in s0
                         if "running_mean" in k)


def test_remat_from_the_factories():
    config = load_config(overrides={"model": {"deeplab": {"remat": True},
                                              "bisenet": {"remat": True}}})
    blocks = [m for m in make_deeplab(config.model["deeplab"]).modules()
              if hasattr(m, "residual")]
    assert len(blocks) == 33 and all(b.remat for b in blocks)
    bisenet = BiSeNet(remat=True)
    assert all(m.remat for m in bisenet.context_path.modules()
               if hasattr(m, "residual"))


@pytest.mark.parametrize("size", [(7, 8), (9, 10), (33, 65), (17, 25),
                                  (2, 3)])
@pytest.mark.parametrize("ceil_mode", [True, False])
def test_max_pool_matches_the_jax_hi_pad_rule(size, ceil_mode, rng):
    x = rng.normal(size=(1, *size, 4)).astype(np.float32)
    want = np.asarray(jax_layers.max_pool_3x3_s2(jnp.asarray(x), ceil_mode))
    got = layers.max_pool_3x3_s2(torch.from_numpy(x).permute(0, 3, 1, 2),
                                 ceil_mode)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_frozen_parameters_and_head_match_the_jax_masks():
    variables = FlaxDeepLab(num_classes=19, layers=THIN).init(
        jax.random.key(0), jnp.zeros((1, 33, 33, 3)), train=False)
    params = variables["params"]

    def torch_keys(mask, want):
        out = set()
        for path, v in jax.tree_util.tree_leaves_with_path(mask):
            if v == want:
                *scopes, leaf = [p.key for p in path]
                name = "bias" if leaf == "bias" else "weight"
                out.add(".".join([*map(torch_scope, scopes), name]))
        return out

    model = DeepLabV2(layers=THIN)
    names = {id(p): k for k, p in model.named_parameters()}
    frozen = {names[id(p)] for p in frozen_bn_parameters(model)}
    assert frozen == torch_keys(frozen_bn_mask(params), True)
    assert len(frozen) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d)
                                  for m in model.modules())
    groups = head_param_groups(model, 10.0)
    assert [g["lr_mult"] for g in groups] == [1.0, 10.0]
    head = {names[id(p)] for p in groups[1]["params"]}
    assert head == torch_keys(lr_multiplier_mask(params, 10.0), 10.0)


def _scale_checkpoint():
    """A ``Scale.``-prefixed DeepLab state dict made from a seed, with a
    19 -> 21 class first ASPP branch and an ``fc`` the model lacks."""
    tree = flax_tree(THIN, (1, 33, 33, 3), seed=5)
    state = {k: torch.from_numpy(np.array(v)) for k, v in
             export_torch_state_dict(tree, prefix="Scale.").items()}
    rng = np.random.default_rng(9)
    for leaf in ("weight", "bias"):
        key = f"Scale.layer6.conv2d_list.0.{leaf}"
        shape = (21, *state[key].shape[1:])
        state[key] = torch.from_numpy(rng.normal(size=shape).astype(
            np.float32))
    state["Scale.fc.weight"] = torch.zeros((1000, 2048))
    return state


def test_pretrained_loading_matches_the_jax_path(tmp_path, capsys):
    state = _scale_checkpoint()
    init = flax_tree(THIN, (1, 33, 33, 3), seed=11)
    report = {}
    merged = merge_pretrained(
        init, convert_torch_state_dict(
            {k: v.numpy() for k, v in state.items()}, strip_prefix=True),
        report=report)
    path = tmp_path / "deeplab.pth"
    torch.save(state, path)
    model = load_flax_variables(DeepLabV2(layers=THIN), init)
    got = load_deeplab_pretrained(model, str(path))
    assert got["loaded"] == report["loaded"] == len(state) - 3 - len(
        [k for k in state if k.endswith("num_batches_tracked")])
    assert sorted(got["skipped"]) == [
        "fc.weight",
        "layer6.conv2d_list.0.bias (shape (21,) vs (19,))",
        "layer6.conv2d_list.0.weight (shape (21, 2048, 3, 3) vs "
        "(19, 2048, 3, 3))"]
    assert "pretrained: loaded" in capsys.readouterr().out
    own = model.state_dict()
    for k, v in state_dict_from_flax(merged).items():
        assert torch.equal(own[k], v), k

    # the factory reads both key spellings
    for keys in (("pretrain", "pretrain_model_path"),
                 ("pretrained", "pretrained_path")):
        cfg = dict(load_config().model["deeplab"])
        cfg.pop("pretrain"), cfg.pop("pretrain_model_path")
        cfg.update({keys[0]: True, keys[1]: str(path)})
        full = make_deeplab(cfg)
        assert torch.equal(full.conv1.weight, state["Scale.conv1.weight"])


@pytest.mark.parametrize("train", [True, False])
def test_smoke_weight_tree_has_the_flax_layout(train):
    """chip_smoke.py builds its DeepLab weights with numpy; they must have
    the structure and shapes of a Flax init."""
    variables = jax.eval_shape(
        lambda: FlaxDeepLab(num_classes=19).init(
            jax.random.key(0), jnp.zeros((1, 33, 33, 3)), train=train))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                    dict(variables))
    ours = jax.tree_util.tree_map(lambda a: a.shape,
                                  chip_smoke.random_flax_deeplab(0))
    assert ours == shapes
