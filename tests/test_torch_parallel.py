"""The port's data axis (``rtsds_tpu_torch/parallel``) against one process
and against the JAX package on a 2-device data mesh, at small size.

* The meshes: ``make_mesh`` and ``make_mesh_from_config`` give the JAX
  package's axis, device count, warning and error, case by case, on lists
  of as many devices as its virtual CPU devices, the spatial and model
  axes included (their composed rules: test_torch_mesh_nd.py).
* The global-batch BatchNorm on 2 ranks (gloo, CPU) equals one process's
  ``nn.BatchNorm2d`` on the global batch in float64: the output, the
  running statistics and the gradients, at rtol 1e-9 / atol 1e-12.
* One supervised step of BiSeNet-R18 and of a thin DeepLabV2 and one
  accumulating step (K = 2), float64, global batch 4 over 2 ranks, shard 0
  with half its pixels void and shard 1 none: against one process on the
  global batch at rtol 1e-9 / atol 1e-12 (the loss at rtol 1e-9), and
  against JAX's step on a 2-device data mesh at rtol 1e-6 / atol 1e-10.
  Every step sees the same global batch; under accumulation each rank
  holds its share of each of the K micro-batches, as the loader lays it
  out, and for that case shard 0's frames are the half-void ones.  DDP's mean
  of the ranks' mean losses misses JAX's loss on these shards (the gap is
  recorded as the JUnit property ``ddp_mean_of_means_rel_gap``).
* One DA step of v1, the gradient-reversal step and v2 with MinEnt and FDA
  on 2 ranks: against one process at rtol 1e-9 / atol 1e-12 and against
  JAX at test_torch_adversarial.py's limits for each variant (JAX's FDA
  float32 cast widened to float64, as test_torch_fda_entropy.py does).
* Validation on 2 ranks under the plain, sliding and ensemble protocols:
  each rank's matrices sum to the all-reduced one, which equals one
  process's exactly, as does the mIoU, and the plain one JAX's
  ``validate``.
* Serving on a batch mesh of two CPU devices: the masks of one device at
  the per-device batch, exactly (float32), under the plain and sliding
  protocols and int8; the batch-multiple error; the server's and the
  serve CLI's ``--mesh batch``.
"""

import threading
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rtsds_tpu.ops.fda as jax_fda
from rtsds_tpu.eval.validate import make_eval_step as jax_make_eval_step
from rtsds_tpu.eval.validate import validate as jax_validate
from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
from rtsds_tpu.models.deeplabv2 import DeepLabV2 as FlaxDeepLab
from rtsds_tpu.models.deeplabv2 import frozen_bn_mask
from rtsds_tpu.models.discriminator import (
    TinyDomainDiscriminator as FlaxTinyDiscriminator)
from rtsds_tpu.parallel import mesh as jax_mesh
from rtsds_tpu.train.accumulate import (
    make_accumulating_train_step as jax_accumulating_step)
from rtsds_tpu.train.accumulate import (
    split_microbatches as jax_split_microbatches)
from rtsds_tpu.train.adversarial import (
    make_adversarial_step as jax_adversarial_step)
from rtsds_tpu.train.optim import make_optimizer as jax_make_optimizer
from rtsds_tpu.train.state import TrainState as JaxTrainState
from rtsds_tpu.train.supervised import make_train_step as jax_train_step
from rtsds_tpu_torch import serve, serve_server
from rtsds_tpu_torch.data.synthetic import SyntheticSegDataset
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.pretrained import (
    load_flax_variables, state_dict_from_flax)
from rtsds_tpu_torch.ops.losses import segmentation_loss
from rtsds_tpu_torch.ops.preprocess import normalize
from rtsds_tpu_torch.parallel import mesh as port_mesh
from rtsds_tpu_torch.parallel.distributed import shard_positions
from rtsds_tpu_torch.parallel.launch import run_ranks
from rtsds_tpu_torch.serve import Predictor
from test_torch_deeplab import flax_tree
from test_torch_multihost import (
    THIN, TIMEOUT_S, bn_worker, da_worker, load, make_model, numpy_state,
    supervised_worker, validate_worker)

SIZE = (32, 64)
TGT = (32, 48)
WORLD = 2
SAME = dict(rtol=1e-9, atol=1e-12)      # 2 ranks against one process
JAX = dict(rtol=1e-6, atol=1e-10)       # against the JAX package
DA_LIMITS = {"v1": (1e-8, 1e-6, 1e-10), "grl": (1e-8, 1e-6, 1e-10),
             "v2_minent_fda": (1e-6, 1e-4, 1e-6)}
DA_VARIANTS = {
    "v1": dict(variant="v1"),
    "grl": dict(variant="v1", grl_alpha=0.5),
    "v2_minent_fda": dict(variant="v2", lambda_ent=0.05, fda_beta=0.05)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _close(got: dict, want: dict, what: str, **tol):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   err_msg=f"{what} {k}", **tol)


def _ranks_equal(states: list) -> None:
    """Every rank ends the step with the same tensors, bit for bit."""
    for k in states[0]:
        for other in states[1:]:
            np.testing.assert_array_equal(states[0][k], other[k], err_msg=k)


# --- the meshes -----------------------------------------------------------

MESH_CASES = {
    "all_devices": (8, {"data": -1}, 8),
    "trimmed": (8, {"data": -1}, 6),
    "trimmed_prime": (8, {"data": -1}, 7),
    "data_2": (8, {"data": 2}, 8),
    "pipe_2": (8, {"pipe": 2}, 8),
    "pipe_all": (8, {"pipe": -1}, 8),
    "pipe_all_one_device": (1, {"pipe": -1}, 4),
    "pipe_too_many": (8, {"pipe": 9}, 8),
    "pipe_with_data": (8, {"pipe": 2, "data": 2}, 8),
    "pipe_negative": (8, {"pipe": -2}, 8),
    "one_device": (1, {"data": -1}, 3),
}


def _mesh_outcome(build):
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        try:
            mesh = build()
        except ValueError as e:
            return ("error", str(e)), [str(w.message) for w in seen]
    return ((mesh.axis_names, dict(mesh.shape)),
            [str(w.message) for w in seen])


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_mesh_from_config_matches_jax(case):
    n, spec, batch = MESH_CASES[case]
    want = _mesh_outcome(lambda: jax_mesh.make_mesh_from_config(
        spec, devices=jax.devices()[:n], batch_size=batch))
    got = _mesh_outcome(lambda: port_mesh.make_mesh_from_config(
        spec, devices=[torch.device("cpu")] * n, batch_size=batch))
    assert got == want


@pytest.mark.parametrize("batch", [None, 8, 6, 5, 1])
def test_make_mesh_matches_jax(batch):
    want = _mesh_outcome(lambda: jax_mesh.make_mesh(jax.devices()[:8],
                                                    batch_size=batch))
    got = _mesh_outcome(lambda: port_mesh.make_mesh(["cpu"] * 8,
                                                    batch_size=batch))
    assert got == want


def test_make_mesh_of_several_processes_raises_instead_of_trimming(
        monkeypatch):
    monkeypatch.setattr(port_mesh, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="global batch 3 must divide by "
                                         "the total device count 2"):
        port_mesh.make_mesh(["cpu", "cpu"], batch_size=3)
    with pytest.raises(ValueError, match="single-process only"):
        port_mesh.make_mesh_from_config({"pipe": 2}, devices=["cpu"] * 2)


@pytest.mark.parametrize("spec", [{"spatial": 2}, {"model": 2},
                                  {"data": 2, "spatial": 2}])
def test_spatial_and_model_axes_are_not_ported(spec):
    """The spatial and model axes are ported now (ROADMAP 17.3-17.4): the
    port builds JAX's mesh for each spec (test_torch_mesh_nd.py holds
    the composed rules case by case; the CLI runs every extra on them,
    test_torch_spatial_extras_composed.py)."""
    want = _mesh_outcome(lambda: jax_mesh.make_mesh_from_config(
        spec, devices=jax.devices()[:4]))
    got = _mesh_outcome(lambda: port_mesh.make_mesh_from_config(
        spec, devices=["cpu"] * 4))
    assert got == want


def test_shard_batch_gives_each_device_its_chunk():
    mesh = port_mesh.Mesh(["cpu", "cpu"])
    x = torch.arange(8).reshape(4, 2)
    chunks = port_mesh.shard_batch((x, x + 1), mesh)
    assert [c[0].tolist() for c in chunks] == [[[0, 1], [2, 3]],
                                               [[4, 5], [6, 7]]]
    with pytest.raises(ValueError, match="multiple of the 2-device mesh"):
        port_mesh.shard_batch(torch.zeros(3), mesh)
    # inputs split over data and are replicated on a pipe mesh, as in JAX
    assert port_mesh.input_sharding(mesh).spec == ("data",)
    pipe = port_mesh.Mesh(["cpu", "cpu"], ("pipe",))
    assert port_mesh.input_sharding(pipe).spec == ()
    jax_data = jax_mesh.make_mesh(jax.devices()[:2])
    jax_pipe = jax_mesh.make_mesh_from_config({"pipe": 2},
                                              devices=jax.devices()[:2])
    assert tuple(jax_mesh.input_sharding(jax_data).spec) == ("data",)
    assert tuple(jax_mesh.input_sharding(jax_pipe).spec) == ()


# --- the global-batch BatchNorm --------------------------------------------

def test_global_batchnorm_on_two_ranks_equals_one_process():
    rng = np.random.default_rng(0)
    x = rng.normal(2.0, 3.0, size=(4, 5, 6, 7))
    x[:2] += 10.0  # the shards' statistics differ
    dy = rng.normal(size=x.shape)
    ranks = run_ranks(bn_worker, WORLD, (x, dy), timeout_s=TIMEOUT_S)

    bn = torch.nn.BatchNorm2d(5).double()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator()
                           .manual_seed(1))
        bn.bias.uniform_(-0.5, 0.5, generator=torch.Generator()
                         .manual_seed(2))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt)
    (y * torch.from_numpy(dy)).sum().backward()
    got = {"y": np.concatenate([r["y"] for r in ranks]),
           "x_grad": np.concatenate([r["x_grad"] for r in ranks]),
           "weight_grad": sum(r["weight_grad"] for r in ranks),
           "bias_grad": sum(r["bias_grad"] for r in ranks),
           "running_mean": ranks[0]["running_mean"],
           "running_var": ranks[0]["running_var"]}
    want = {"y": y.detach().numpy(), "x_grad": xt.grad.numpy(),
            "weight_grad": bn.weight.grad.numpy(),
            "bias_grad": bn.bias.grad.numpy(),
            "running_mean": bn.running_mean.numpy(),
            "running_var": bn.running_var.numpy()}
    _close(got, want, "bn", **SAME)
    for k in ("running_mean", "running_var"):
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
    assert ranks[0]["count"] == ranks[1]["count"] == 1


# --- the supervised and accumulating steps --------------------------------

def _void_batch(k: int = 1, seed: int = 11):
    """Global batch 4: shard 0 half void, shard 1 none, where shard r is
    what rank r holds for a K-step accumulation (frames 0, 1 for K = 1;
    0, 2 for K = 2)."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(4, *SIZE, 3))
    labels = rng.integers(0, 19, size=(4, *SIZE)).astype(np.int64)
    labels[shard_positions(4, 0, WORLD, k), :, : SIZE[1] // 2] = 19
    return images, labels


@pytest.fixture(scope="module")
def trees():
    bisenet = FlaxBiSeNet(num_classes=19)
    gen = jax.jit(lambda key, x: bisenet.init(key, x, train=True))(
        jax.random.key(0), jnp.zeros((2, *SIZE, 3)))
    dis = FlaxTinyDiscriminator(num_classes=19).init(
        jax.random.key(1), jnp.zeros((2, *TGT, 19)))
    return {"bisenet": _f64(dict(gen)),
            "deeplab": _f64(flax_tree(THIN, (1, *SIZE, 3), seed=7)),
            "discriminator": _f64(dict(dis))}


STEP_CASES = {"bisenet": ("bisenet", 1), "deeplab": ("deeplab", 1),
              "accumulate": ("bisenet", 2)}


def _numpy_sd(variables) -> dict:
    return {k: v.numpy() for k, v in state_dict_from_flax(variables).items()}


@pytest.fixture(scope="module")
def step_runs(trees):
    """The 2 ranks' results of every case, and one process's."""
    cases = {name: (kind, _numpy_sd(trees[kind]), *_void_batch(k), k)
             for name, (kind, k) in STEP_CASES.items()}
    ranks = run_ranks(supervised_worker, WORLD, (cases,),
                      timeout_s=TIMEOUT_S)
    one = {name: supervised_worker(0, 1, {name: case})[name]
           for name, case in cases.items()}
    return ranks, one


def _jax_step(trees, kind: str, k: int):
    images, labels = _void_batch(k)
    variables = trees[kind]
    if kind == "deeplab":
        tx = jax_make_optimizer("SGD", 0.01, momentum=0.9,
                                frozen_mask=frozen_bn_mask)
        apply_fn = FlaxDeepLab(num_classes=19, layers=THIN).apply
    else:
        tx = optax.sgd(0.01, momentum=0.9)
        apply_fn = FlaxBiSeNet(num_classes=19).apply
    mesh = jax_mesh.make_mesh(jax.devices()[:WORLD])
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        state = jax_mesh.shard_state(JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                               variables["batch_stats"]),
            opt_state=tx.init(params), apply_fn=apply_fn, tx=tx), mesh)
        if k > 1:
            x = jax_split_microbatches(jnp.asarray(images), k)
            y = jax_split_microbatches(jnp.asarray(labels, jnp.int32), k)
            x = jax.device_put(x, jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec(None, "data")))
            y = jax.device_put(y, jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec(None, "data")))
            step = jax_accumulating_step(ignore_index=19, donate=False)
        else:
            x, y = jax_mesh.shard_batch(
                (jnp.asarray(images), jnp.asarray(labels, jnp.int32)), mesh)
            step = jax_train_step(ignore_index=19, donate=False)
        new, metrics = step(state, x, y)
        metrics = {k2: float(v) for k2, v in metrics.items()}
        after = _f64({"params": new.params, "batch_stats": new.batch_stats})
    return metrics, _numpy_sd(after)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_on_two_ranks_equals_one_process(step_runs, case):
    ranks, one = step_runs
    _ranks_equal([r[case][1] for r in ranks])
    assert ranks[0][case][0] == ranks[1][case][0]
    got_metrics, got = ranks[0][case]
    want_metrics, want = one[case]
    assert got_metrics["total"] == want_metrics["total"] == 4 * SIZE[0] \
        * SIZE[1]
    assert got_metrics["correct"] == want_metrics["correct"]
    np.testing.assert_allclose(got_metrics["train_loss"],
                               want_metrics["train_loss"], rtol=1e-9)
    _close(got, want, case, **SAME)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_on_two_ranks_matches_jax_on_a_data_mesh(step_runs, trees,
                                                      case):
    kind, k = STEP_CASES[case]
    want_metrics, want = _jax_step(trees, kind, k)
    got_metrics, got = step_runs[0][0][case]
    assert got_metrics["correct"] == want_metrics["correct"]
    np.testing.assert_allclose(got_metrics["train_loss"],
                               want_metrics["train_loss"], rtol=1e-6)
    # the batch-norm counters are the port's alone
    got = {k2: v for k2, v in got.items()
           if not k2.endswith("num_batches_tracked")}
    _close(got, want, case, **JAX)


def test_ddp_mean_of_means_misses_jax_on_uneven_void(trees, record_property):
    """The loss a DDP-style step reports (each rank's own mean, averaged)
    against JAX's global mean: on these shards it misses by far more than
    the limit the port meets, so the tests above can see that fault."""
    want_metrics, _ = _jax_step(trees, "bisenet", 1)
    images, labels = _void_batch()
    model = load(make_model("bisenet"), _numpy_sd(trees["bisenet"])).train()
    with torch.no_grad():
        outputs = model(torch.from_numpy(images).permute(0, 3, 1, 2))
        global_loss = float(segmentation_loss(outputs, torch.from_numpy(
            labels)))
        ddp_loss = float(np.mean([
            segmentation_loss(tuple(o[s] for o in outputs),
                              torch.from_numpy(labels[s]))
            for s in (slice(0, 2), slice(2, 4))]))
    want = want_metrics["train_loss"]
    gap = abs(ddp_loss - want) / abs(want)
    record_property("ddp_mean_of_means_rel_gap", gap)
    np.testing.assert_allclose(global_loss, want, rtol=1e-6)
    assert gap > 1e-3


# --- the adversarial steps -------------------------------------------------

def _da_batch():
    rng = np.random.default_rng(7)
    src = rng.normal(size=(4, *SIZE, 3))
    tgt = rng.normal(size=(4, *TGT, 3))
    labels = rng.integers(0, 19, size=(4, *SIZE)).astype(np.int64)
    labels[:2, : SIZE[0] // 2] = 19
    return src, labels, tgt


@pytest.fixture(scope="module")
def da_runs(trees):
    gen, dis = _numpy_sd(trees["bisenet"]), _numpy_sd(trees["discriminator"])
    variants = {name: dict(lambda_=0.1, iterations=5, epochs=1,
                           ignore_index=19, **kw)
                for name, kw in DA_VARIANTS.items()}
    ranks = run_ranks(da_worker, WORLD, (gen, dis, _da_batch(), variants),
                      timeout_s=TIMEOUT_S)
    one = da_worker(0, 1, gen, dis, _da_batch(), variants)
    return ranks, one


class _WideJnp:
    """``jax.numpy`` whose ``float32`` is ``float64``."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.mark.parametrize("name", sorted(DA_VARIANTS))
def test_da_step_on_two_ranks_equals_one_process(da_runs, name):
    ranks, one = da_runs
    for part in (1, 2):
        _ranks_equal([r[name][part] for r in ranks])
    got, want = ranks[0][name], one[name]
    _close(got[0], want[0], f"{name} metrics", **SAME)
    _close(got[1], want[1], f"{name} G", **SAME)
    _close(got[2], want[2], f"{name} D", **SAME)


@pytest.mark.parametrize("name", sorted(DA_VARIANTS))
def test_da_step_on_two_ranks_matches_jax(da_runs, trees, name, monkeypatch):
    monkeypatch.setattr(jax_fda, "jnp", _WideJnp())
    kw = DA_VARIANTS[name]
    loss_rtol, rtol, atol = DA_LIMITS[name]
    src, labels, tgt = _da_batch()
    mesh = jax_mesh.make_mesh(jax.devices()[:WORLD])

    def state(variables, apply_fn, lr):
        tx = optax.sgd(lr)
        return jax_mesh.shard_state(JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=variables.get("batch_stats"),
            opt_state=tx.init(variables["params"]), apply_fn=apply_fn,
            tx=tx), mesh)

    with jax.enable_x64(True):
        gen_vars = jax.tree_util.tree_map(jnp.asarray, trees["bisenet"])
        dis_vars = jax.tree_util.tree_map(jnp.asarray,
                                          trees["discriminator"])
        step = jax_adversarial_step(0.1, 5, epochs=1, ignore_index=19,
                                    donate=False, **kw)
        gen, dis, metrics = step(
            state(gen_vars, FlaxBiSeNet(num_classes=19).apply, 0.01),
            state(dis_vars, FlaxTinyDiscriminator(num_classes=19).apply,
                  0.02),
            *jax_mesh.shard_batch((jnp.asarray(src),
                                   jnp.asarray(labels, jnp.int32),
                                   jnp.asarray(tgt)), mesh))
        metrics = {k: float(v) for k, v in metrics.items()}
        want_gen = _numpy_sd(_f64({"params": gen.params,
                                   "batch_stats": gen.batch_stats}))
        want_dis = _numpy_sd(_f64({"params": dis.params}))
    got_metrics, got_gen, got_dis = da_runs[0][0][name]
    assert got_metrics["correct"] == metrics["correct"]
    for k in metrics:
        if k not in ("correct", "total"):
            np.testing.assert_allclose(got_metrics[k], metrics[k],
                                       rtol=loss_rtol, atol=1e-12,
                                       err_msg=k)
    got_gen = {k: v for k, v in got_gen.items()
               if not k.endswith("num_batches_tracked")}
    _close(got_gen, want_gen, f"{name} G", rtol=rtol, atol=atol)
    _close(got_dis, want_dis, f"{name} D", rtol=rtol, atol=atol)


# --- validation ------------------------------------------------------------

@pytest.fixture(scope="module")
def val_setup():
    flax_model = FlaxBiSeNet(num_classes=19)
    variables = jax.tree_util.tree_map(np.asarray, flax_model.init(
        jax.random.key(0), jnp.zeros((1, *SIZE, 3), jnp.float32),
        train=False))
    ds = SyntheticSegDataset(8, SIZE, seed=1, fixed_tints=True)
    batches = []
    for b in range(2):
        images = np.stack([ds[4 * b + i][0] for i in range(4)])
        labels = np.stack([ds[4 * b + i][1] for i in range(4)])
        labels[:2, :4] = 255  # void on shard 0 only
        batches.append((normalize(torch.from_numpy(images)).numpy(),
                        labels.astype(np.int32)))
    state = numpy_state(load_flax_variables(BiSeNet(), variables))
    protocols = ("plain", "sliding", "ensemble")
    ranks = run_ranks(validate_worker, WORLD, (state, batches, protocols),
                      timeout_s=TIMEOUT_S)
    one = validate_worker(0, 1, state, batches, protocols)
    return flax_model, variables, batches, ranks, one


@pytest.mark.parametrize("protocol", ["plain", "sliding", "ensemble"])
def test_validation_on_two_ranks_equals_one_process(val_setup, protocol):
    _, _, _, ranks, one = val_setup
    locals_ = [r[protocol][0] for r in ranks]
    np.testing.assert_array_equal(sum(locals_), ranks[0][protocol][1])
    for r in ranks:
        np.testing.assert_array_equal(r[protocol][1], one[protocol][1])
        assert r[protocol][2] == one[protocol][2]
    assert not np.array_equal(locals_[0], locals_[1])


def test_validation_on_two_ranks_matches_jax_validate(val_setup):
    flax_model, variables, batches, ranks, _ = val_setup
    want, _ = jax_validate(
        variables, iter([(jnp.asarray(x), jnp.asarray(y))
                         for x, y in batches]), 19,
        eval_step=jax_make_eval_step(flax_model.apply, 19))
    for r in ranks:
        assert r["plain"][2] == pytest.approx(float(want), abs=0.0)


# --- serving on a batch mesh -----------------------------------------------

FRAMES = np.random.default_rng(5).integers(0, 256, (4, 32, 64, 3), np.uint8)
SERVE_CASES = {"plain": {},
               "sliding": {"protocol": "sliding",
                           "protocol_kwargs": {"window": (32, 32)}},
               "int8": {"quantize": "int8", "calib_frames": FRAMES}}


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_batch_mesh_predictor_equals_one_device(case):
    kw = dict(image_size=(32, 64), dtype=torch.float32, **SERVE_CASES[case])
    mesh = port_mesh.Mesh(["cpu", "cpu"])
    meshed = Predictor(batch_size=4, mesh=mesh, sharding="batch", **kw)
    single = Predictor(batch_size=2, device="cpu", **kw)
    assert len(meshed.replicas) == 2
    assert meshed.replicas[0] is not meshed.replicas[1]
    np.testing.assert_array_equal(meshed.predict(FRAMES),
                                  single.predict(FRAMES))
    # a short batch is padded to the mesh's batch
    np.testing.assert_array_equal(meshed.predict(FRAMES[:3]),
                                  single.predict(FRAMES[:3]))


def test_batch_mesh_needs_a_multiple_of_its_size():
    mesh = port_mesh.Mesh(["cpu", "cpu"])
    with pytest.raises(ValueError, match="batch_size 3 must be a multiple "
                                         "of the 2-device mesh"):
        Predictor(image_size=(32, 64), batch_size=3, mesh=mesh)
    with pytest.raises(ValueError, match="unknown serving sharding"):
        Predictor(image_size=(32, 64), batch_size=2, mesh=mesh,
                  sharding="rows")


def test_serve_cli_mesh_batch_writes_the_single_device_masks(
        tmp_path, monkeypatch):
    from PIL import Image

    monkeypatch.setenv("RTSDS_CPU_DEVICES", "2")
    paths = []
    for i, frame in enumerate(FRAMES[:2]):
        paths.append(str(tmp_path / f"f{i}.png"))
        Image.fromarray(frame).save(paths[-1])
    serve.main([*paths, "--size", "32, 64", "--out", str(tmp_path / "mesh"),
                "--device", "cpu", "--mesh", "batch"])
    serve.main([*paths, "--size", "32, 64", "--out", str(tmp_path / "one"),
                "--device", "cpu"])
    for i in range(2):
        a = np.asarray(Image.open(tmp_path / "mesh" / f"f{i}_mask.png"))
        b = np.asarray(Image.open(tmp_path / "one" / f"f{i}_mask.png"))
        np.testing.assert_array_equal(a, b)


def test_server_mesh_batch_replies_equal_predict(monkeypatch):
    """``serve_server --mesh batch`` over two CPU devices answers a raw
    request with the single-device predictor's mask (``serve_forever``
    stubbed to one request)."""
    import urllib.request

    monkeypatch.setenv("RTSDS_CPU_DEVICES", "2")
    served = {}
    real_make = serve_server.make_http_server

    def one_shot_make(batcher, host, port, colored=False):
        server = real_make(batcher, host=host, port=0, colored=colored)
        served["predictor"] = batcher.predictor

        def one_request_then_drain():
            server.handle_request()
            for _ in range(600):
                if "status" in served or "error" in served:
                    return
                time.sleep(0.1)

        server.serve_forever = one_request_then_drain
        server.shutdown = lambda: None
        served["server"] = server
        return server

    monkeypatch.setattr(serve_server, "make_http_server", one_shot_make)

    def post():
        for _ in range(600):
            if "server" in served:
                break
            time.sleep(0.1)
        port = served["server"].server_address[1]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict", data=FRAMES[1].tobytes(),
            headers={"Content-Type": "application/octet-stream"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                served["body"] = r.read()
                served["status"] = r.status
        except OSError as e:
            served["error"] = repr(e)

    t = threading.Thread(target=post, daemon=True)
    t.start()
    serve_server.main(["--host", "127.0.0.1", "--port", "0", "--size",
                       "32, 64", "--batch", "2", "--device", "cpu",
                       "--mesh", "batch"])
    t.join(timeout=120)
    assert "error" not in served, served["error"]
    assert served["predictor"].mesh.size == 2
    mask = np.frombuffer(served["body"], np.uint8).reshape(32, 64)
    want = Predictor(image_size=(32, 64), batch_size=1,
                     device="cpu").predict(FRAMES[1])
    np.testing.assert_array_equal(mask, want)

