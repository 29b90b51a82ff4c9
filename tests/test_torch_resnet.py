"""The port's ResNet context paths against the Flax ones, same weights.

f32 on the CPU; rtol 1e-3 / atol 1e-4 covers summation order across two
conv libraries (the tolerance of test_golden_bisenet.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsds_tpu.models.resnet import ResNetBackbone as FlaxResNet
from rtsds_tpu_torch.models.pretrained import load_flax_variables
from rtsds_tpu_torch.models.resnet import FEATURE_CHANNELS, ResNetBackbone


def _perturbed_stats(variables, rng):
    """Non-trivial BN statistics, so eval-mode BN is not the identity."""
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.1, 0.5, a.shape).astype(np.float32),
        variables["batch_stats"])
    return variables


@pytest.mark.parametrize("arch,shape", [("resnet18", (1, 64, 128, 3)),
                                        ("resnet101", (1, 32, 64, 3))])
def test_context_path_matches_flax(arch, shape, key, rng):
    x = rng.normal(size=shape).astype(np.float32)
    flax_model = FlaxResNet(arch=arch)
    variables = _perturbed_stats(
        flax_model.init(key, jnp.asarray(x), train=False), rng)
    want = [np.asarray(a) for a in
            flax_model.apply(variables, jnp.asarray(x), train=False)]

    model = load_flax_variables(ResNetBackbone(arch), variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    c16, c32 = FEATURE_CHANNELS[arch]
    assert [g.shape[1] for g in got] == [c16, c32, c32]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   rtol=1e-3, atol=1e-4)
