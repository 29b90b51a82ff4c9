"""The port's gradient-accumulation step against the JAX package's
``make_accumulating_train_step``.

One K = 2 step at batch 4 (micro-batches of 2) of BiSeNet-R18 at 64x128 in
float64, from the same Flax tree (through the weight bridge) and the same
numpy batch, SGD with momentum on both: the loss at rtol 1e-8, the pixel
count exactly, parameters and BN running statistics at rtol 1e-6 / atol
1e-10, the JAX package's own limits for its float64 parity runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
from rtsds_tpu.train.accumulate import (
    make_accumulating_train_step as jax_accumulating_step)
from rtsds_tpu.train.accumulate import (
    split_microbatches as jax_split_microbatches)
from rtsds_tpu.train.state import TrainState as JaxTrainState
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.pretrained import load_flax_variables
from rtsds_tpu_torch.train.accumulate import (
    make_accumulating_train_step, split_microbatches)
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.state import TrainState
from test_torch_adversarial import _f64, _leaves, _torch_key, _torch_layout

SIZE = (64, 128)
LR = 0.01
K = 2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _batch():
    rng = np.random.default_rng(11)
    images = rng.normal(size=(4, *SIZE, 3))
    labels = rng.integers(0, 20, size=(4, *SIZE)).astype(np.int32)  # 19 void
    return images, labels


@pytest.fixture(scope="module")
def jax_step():
    """The Flax tree before the step, the metrics, and the tree after."""
    model = FlaxBiSeNet(num_classes=19)
    variables = _f64(dict(jax.jit(lambda k, x: model.init(k, x, train=True))(
        jax.random.key(0), jnp.zeros((2, *SIZE, 3)))))
    images, labels = _batch()
    tx = optax.sgd(LR, momentum=0.9)
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                               variables["batch_stats"]),
            opt_state=tx.init(params), apply_fn=model.apply, tx=tx)
        step = jax_accumulating_step(ignore_index=19, donate=False)
        new, metrics = step(state,
                            jax_split_microbatches(jnp.asarray(images), K),
                            jax_split_microbatches(jnp.asarray(labels), K))
        metrics = {k: np.asarray(v) for k, v in metrics.items()}
        after = _f64({"params": new.params, "batch_stats": new.batch_stats})
        assert int(new.step) == 1
    return variables, metrics, after


def _port_state(variables):
    model = load_flax_variables(BiSeNet().double(), variables)
    return TrainState(model, make_optimizer("SGD", model.parameters(), LR,
                                            momentum=0.9))


def test_accumulated_step_matches_jax_in_float64(jax_step):
    variables, want, after = jax_step
    state = _port_state(variables)
    images, labels = _batch()
    step = make_accumulating_train_step(ignore_index=19)
    got = step(state, split_microbatches(torch.from_numpy(images), K),
               split_microbatches(torch.from_numpy(labels), K))
    np.testing.assert_allclose(float(got["train_loss"]),
                               float(want["train_loss"]), rtol=1e-8)
    assert int(got["correct"]) == int(want["correct"])
    assert got["total"] == int(want["total"]) == labels.size
    new = state.model.state_dict()
    for path, arr in _leaves(after["params"]):
        key = _torch_key(path)
        np.testing.assert_allclose(new[key].numpy(), _torch_layout(arr),
                                   rtol=1e-6, atol=1e-10, err_msg=key)
    for path, arr in _leaves(after["batch_stats"]):
        key = _torch_key(path, stats=True)
        np.testing.assert_allclose(new[key].numpy(), arr, rtol=1e-6,
                                   atol=1e-10, err_msg=key)


def test_bn_counts_advance_k_times_and_the_optimizer_once(jax_step):
    state = _port_state(jax_step[0])
    images, labels = _batch()
    step = make_accumulating_train_step(ignore_index=19)
    step(state, split_microbatches(torch.from_numpy(images), K),
         split_microbatches(torch.from_numpy(labels), K))
    assert state.step == state.optimizer.count == 1
    counts = {int(v) for k, v in state.model.state_dict().items()
              if k.endswith("num_batches_tracked")}
    assert counts == {K}


def test_split_microbatches_refuses_a_batch_k_does_not_divide():
    x = torch.zeros((6, 2, 2, 3))
    assert split_microbatches(x, 3).shape == (3, 2, 2, 2, 3)
    with pytest.raises(ValueError, match="does not split into 4"):
        split_microbatches(x, 4)


def test_a_micro_batch_of_one_frame_is_refused_with_the_reason():
    torch.manual_seed(0)
    model = BiSeNet()
    state = TrainState(model, make_optimizer("SGD", model.parameters(), LR))
    images = torch.zeros((2, 1, 32, 64, 3))
    labels = torch.zeros((2, 1, 32, 64), dtype=torch.int64)
    with pytest.raises(ValueError, match="micro-batches of 1.*fewer "
                                         "accumulate_steps"):
        make_accumulating_train_step()(state, images, labels)
    assert state.step == 0


# --- on height bands (the spatial axis) ------------------------------------

SAME = dict(rtol=1e-9, atol=1e-12)  # bands against one device
BAND_CASES = {"2": (2, False), "4": (4, False), "2_remat": (2, True)}


@pytest.fixture(scope="module")
def band_runs(jax_step):
    """The K = 2 step on one device, and on 2 and 4 height bands (on 4,
    two bands of the 1/32 map hold no row) and on 2 with remat (the
    context path recomputed in the backward, its batch norms' running
    statistics left as they were): the metrics and the state after."""
    from rtsds_tpu_torch.parallel.spatial import split_batch

    variables = jax_step[0]
    images, labels = (torch.from_numpy(a) for a in _batch())
    runs = {}
    for name, (bands, remat) in {"0": (0, False), **BAND_CASES}.items():
        model = load_flax_variables(BiSeNet(remat=remat).double(),
                                    variables)
        state = TrainState(model, make_optimizer(
            "SGD", model.parameters(), LR, momentum=0.9))
        x, y = ((images, labels) if not bands else
                split_batch(images, labels, ["cpu"] * bands))
        got = make_accumulating_train_step(ignore_index=19)(
            state, split_microbatches(x, K), split_microbatches(y, K))
        runs[name] = ({k: float(v) for k, v in got.items()},
                      {k: v.numpy().copy()
                       for k, v in model.state_dict().items()})
    return runs


@pytest.mark.parametrize("case", sorted(BAND_CASES))
def test_accumulated_step_on_bands_equals_one_device_and_jax(band_runs,
                                                             jax_step, case):
    """Micro-batch k is the k-th batch slice of every band: its BatchNorm
    runs over its bands, and ``correct`` sums over them."""
    (got, new), (one, one_new) = band_runs[case], band_runs["0"]
    for k in one:
        np.testing.assert_allclose(got[k], one[k], err_msg=k, **SAME)
    for k in one_new:
        np.testing.assert_allclose(new[k], one_new[k], err_msg=k, **SAME)
    _, want, after = jax_step
    np.testing.assert_allclose(got["train_loss"], float(want["train_loss"]),
                               rtol=1e-8)
    assert got["correct"] == int(want["correct"])
    assert got["total"] == int(want["total"])
    for path, arr in _leaves(after["params"]):
        key = _torch_key(path)
        np.testing.assert_allclose(new[key], _torch_layout(arr), rtol=1e-6,
                                   atol=1e-10, err_msg=key)
    for path, arr in _leaves(after["batch_stats"]):
        key = _torch_key(path, stats=True)
        np.testing.assert_allclose(new[key], arr, rtol=1e-6, atol=1e-10,
                                   err_msg=key)


def test_remat_recompute_on_bands_leaves_the_running_stats_bit_equal():
    """Remat's recompute runs the batch norms with momentum 0
    (``models/layers.py:_running_stats_untouched``): on height bands, as
    in ``nn.BatchNorm2d``, the running statistics come out bit-equal."""
    from rtsds_tpu_torch.models.layers import _running_stats_untouched
    from rtsds_tpu_torch.parallel.spatial import Bands, _Layout, split_rows

    bn = torch.nn.BatchNorm2d(5).double().train()
    with torch.no_grad():
        bn.running_mean.uniform_(-1, 1)
        bn.running_var.uniform_(0.5, 2)
    x = torch.randn((2, 5, 9, 4), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0)) * 3 + 1
    bands = Bands(split_rows(x, ["cpu"] * 2, starts=[0, 4]), [0, 4], 9,
                  _Layout(["cpu"] * 2))
    mean, var = bn.running_mean.clone(), bn.running_var.clone()
    with _running_stats_untouched(bn):
        bn(bands)
    assert torch.equal(bn.running_mean, mean)
    assert torch.equal(bn.running_var, var)
    bn(bands)  # outside the block they advance
    assert not torch.equal(bn.running_mean, mean)
