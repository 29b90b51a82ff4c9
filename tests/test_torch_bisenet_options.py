"""BiSeNet's two module options against the Flax model: no final
interpolation (``with_interpolation=False``) and the space-to-depth stem
(``s2d_stem=True``).  Logits in f32 on the CPU at rtol 1e-3 / atol 1e-4,
the tolerance of test_golden_bisenet.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.pretrained import load_flax_variables

SHAPE = (2, 64, 128, 3)


def _flax_logits(options, key, rng):
    x = rng.normal(size=SHAPE).astype(np.float32)
    flax_model = FlaxBiSeNet(num_classes=19, **options)
    variables = jax.tree_util.tree_map(
        np.asarray, flax_model.init(key, jnp.asarray(x), train=False))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.1, 0.5, a.shape).astype(np.float32),
        variables["batch_stats"])
    want = np.asarray(flax_model.apply(variables, jnp.asarray(x),
                                       train=False))
    return x, variables, want


@pytest.mark.parametrize("options", [
    {"with_interpolation": False}, {"s2d_stem": True},
    {"with_interpolation": False, "s2d_stem": True}])
def test_eval_logits_match_flax(options, key, rng):
    x, variables, want = _flax_logits(options, key, rng)
    model = load_flax_variables(BiSeNet(**options), variables)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    scale = 1 if options.get("with_interpolation", True) else 8
    assert want.shape == (SHAPE[0], SHAPE[1] // scale, SHAPE[2] // scale, 19)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-3, atol=1e-4)


def test_without_interpolation_there_is_no_final_conv(key, rng):
    """The Flax tree has no ``conv`` scope; the bridge loads it strictly,
    and refuses it into the default model, which needs one."""
    _, variables, _ = _flax_logits({"with_interpolation": False}, key, rng)
    assert "conv" not in variables["params"]
    model = BiSeNet(with_interpolation=False)
    assert not any(k.startswith("conv.") for k in model.state_dict())
    load_flax_variables(model, variables)
    with pytest.raises(KeyError, match="conv"):
        load_flax_variables(BiSeNet(), variables)
    out = model.train()(torch.zeros(2, 3, 64, 128))
    # train mode: the 1/8 logits and the two full-size auxiliary heads
    assert [tuple(t.shape) for t in out] == [
        (2, 19, 8, 16), (2, 19, 64, 128), (2, 19, 64, 128)]


def test_s2d_stem_keeps_the_parameters_and_the_output(rng):
    x = torch.from_numpy(rng.normal(size=(1, 3, 64, 96)).astype(np.float32))
    torch.manual_seed(0)
    plain = BiSeNet().eval()
    s2d = BiSeNet(s2d_stem=True).eval()
    s2d.load_state_dict(plain.state_dict())
    with torch.no_grad():
        assert torch.equal(plain(x), s2d(x))
