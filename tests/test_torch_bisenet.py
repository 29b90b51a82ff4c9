"""The port's BiSeNet and weight bridge against the Flax model.

Logits are compared in f32 on the CPU at rtol 1e-3 / atol 1e-4, the
tolerance of test_golden_bisenet.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
from rtsds_tpu.models.pretrained import export_torch_state_dict
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.pretrained import (
    load_flax_variables, state_dict_from_flax)

SHAPE = (1, 64, 128, 3)


def _init(train, key):
    variables = FlaxBiSeNet(num_classes=19).init(
        key, jnp.zeros(SHAPE, jnp.float32), train=train)
    return jax.tree_util.tree_map(np.asarray, variables)


@pytest.mark.parametrize("fast_head", [True, False])
def test_eval_logits_match_flax(fast_head, key, rng):
    x = rng.normal(size=SHAPE).astype(np.float32)
    flax_model = FlaxBiSeNet(num_classes=19, fast_head=fast_head)
    variables = jax.tree_util.tree_map(
        np.asarray, flax_model.init(key, jnp.asarray(x), train=False))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.1, 0.5, a.shape).astype(np.float32),
        variables["batch_stats"])
    want = np.asarray(flax_model.apply(variables, jnp.asarray(x),
                                       train=False))

    model = load_flax_variables(BiSeNet(fast_head=fast_head), variables)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("train", [True, False])
def test_bridge_loads_strict_from_train_and_eval_trees(train, key):
    variables = _init(train, key)
    model = load_flax_variables(BiSeNet(), variables)
    state = model.state_dict()
    for k, v in state_dict_from_flax(variables).items():
        assert torch.equal(state[k], v), k
    has_heads = "supervision1" in variables["params"]
    assert has_heads == train


def test_bridge_rejects_a_missing_scope(key):
    variables = _init(False, key)
    del variables["params"]["arm1"]
    with pytest.raises(KeyError, match="arm1"):
        load_flax_variables(BiSeNet(), variables)


def test_bridge_rejects_an_unexpected_key(key):
    variables = _init(True, key)
    variables["params"]["extra"] = {"bias": np.zeros(3, np.float32)}
    with pytest.raises(RuntimeError, match="extra"):
        load_flax_variables(BiSeNet(), variables)


def test_state_dict_keys_match_the_jax_export(key):
    variables = _init(True, key)

    def keys(names):
        return {k for k in names if not k.endswith("num_batches_tracked")}

    assert keys(BiSeNet().state_dict()) == keys(
        export_torch_state_dict(variables))


@pytest.mark.parametrize("train", [True, False])
def test_smoke_weight_tree_has_the_flax_layout(train, key):
    """chip_smoke.py builds its weights with numpy; they must have the
    structure and shapes of a Flax init."""
    shapes = jax.tree_util.tree_map(lambda a: a.shape, _init(train, key))
    ours = jax.tree_util.tree_map(lambda a: a.shape,
                                  chip_smoke.random_flax_bisenet(0, 19, train))
    assert ours == shapes


def test_train_mode_returns_three_heads(rng):
    model = BiSeNet().train()
    x = torch.from_numpy(rng.normal(size=(2, 3, 64, 128)).astype(np.float32))
    with torch.no_grad():
        out = model(x)
    assert isinstance(out, tuple) and len(out) == 3
    assert all(o.shape == (2, 19, 64, 128) for o in out)
