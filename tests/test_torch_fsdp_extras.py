"""The supervised training extras on the model axis (FSDP, ROADMAP 17.5a)
on gloo CPU ranks, ``{model: 2}`` (2 ranks) and ``{data: 2, model: 2}``
(4 ranks, rank r at data index r // 2), each state placed by
``parallel/mesh.py:place_state``, float64, BiSeNet-R18 at global batch 4
of 32x64 (test_torch_parallel.py's half-void batches), against one
process at rtol 1e-9 / atol 1e-12 and against the JAX package's
replicated steps on a 2-device data mesh at rtol 1e-6 / atol 1e-10:

* EMA: an SGD step (momentum 0.9) and the EMA's update at the new step
  (decay 0.99): the EMA whole (its checkpoint item) equal to one
  process's and to JAX's ``ema_update`` over JAX's step; each rank's
  EMA keeps the chunks the placement rule gives the parameters (its bytes
  are ``placement_bytes`` with no moments); a restore cuts the same
  chunks; validation on the EMA (its chunks gathered) reports one
  process's mIoU;
* gradient accumulation over 2 micro-batches (each rank holding its
  share of each global micro-batch): one gather and one reduce-scatter a
  step, equal to JAX's accumulating step;
* remat (BiSeNet's context path recomputed in the backward, the global
  BN's collectives run again): equal to one process's remat step and to
  JAX's plain step (remat changes no number);
* distillation from a thin DeepLabV2 teacher, replicated on every rank:
  the float teacher's step against JAX's (losses rtol 1e-8); the int8
  teacher (W8A8, calibrated on the data group's shards) against one
  process's step, whose teacher the same scales make (int8 is not
  continuous: JAX's int8 walk is held in test_torch_multirank_extras.py).

The rank workers live here and import no JAX at module level.
"""

import numpy as np
import pytest
import torch

from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.parallel.launch import run_ranks
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.state import TrainState
from test_torch_composed import (
    SAME, SIZE, _f64, _few_threads, axes, close, load, moments,
    numpy_sd, numpy_state, placed)  # noqa: F401 -- fixtures

TIMEOUT_S = 150
JAX = dict(rtol=1e-6, atol=1e-10)
LOSS_RTOL = 1e-8
THIN = (1, 1, 1, 1)
DECAY = 0.99
T, ALPHA = 2.0, 0.4
MESHES = {"model2": (2, 2), "data2_model2": (4, 2)}   # name: (world, M)


# --- rank workers ---------------------------------------------------------

def _spec(world: int, model_size: int) -> dict:
    return {} if world == 1 else {"data": world // model_size,
                                  "model": model_size}


def _sgd(model, spec, momentum=0.9):
    return placed(TrainState(model, make_optimizer(
        "SGD", model.parameters(), 0.01, momentum=momentum)), spec)


def _metrics(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items() if k != "preempted"}


def _rows(a, k: int = 1):
    """This rank's rows of a global batch ``a`` laid out for a K-step
    accumulation (``parallel/distributed.py:shard_positions``)."""
    from rtsds_tpu_torch.parallel import distributed

    return torch.from_numpy(a[distributed.shard_positions(
        len(a), distributed.rank(), distributed.world_size(), k)])


def extras_worker(rank, world, model_size, state, teacher, batches):
    """Every supervised extra on the (data, model) grid of ``world /
    model_size`` x ``model_size`` ranks (one process at ``world`` 1)."""
    from rtsds_tpu_torch.eval.validate import make_eval_step, validate
    from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2
    from rtsds_tpu_torch.ops.quant import quantize_model
    from rtsds_tpu_torch.parallel import distributed
    from rtsds_tpu_torch.parallel.fsdp import placement_bytes
    from rtsds_tpu_torch.train.accumulate import (
        make_accumulating_train_step, split_microbatches)
    from rtsds_tpu_torch.train.distill import make_distill_step
    from rtsds_tpu_torch.train.ema import ema_update, setup_ema
    from rtsds_tpu_torch.train.loop import on_ema
    from rtsds_tpu_torch.train.supervised import make_train_step

    spec = _spec(world, model_size)
    out = {}
    with distributed.data_parallel(*axes(spec)):
        # EMA
        images, labels = batches["plain"]
        x, y = _rows(images), _rows(labels)
        st = _sgd(load(BiSeNet().double(), state), spec)
        ema = setup_ema(st.model)
        make_train_step(19)(st, x, y)
        ema_update(ema.params, st.model, DECAY, st.step)
        whole = ema.state_dict()["params"]
        out["ema"] = numpy_state(whole)
        out["ema_bytes"] = sum(v.numel() * v.element_size()
                               for v in ema.params.values())
        out["ema_reckoned"] = placement_bytes(BiSeNet().double(),
                                              model_size if spec else 1, 0)
        fresh = setup_ema(_sgd(load(BiSeNet().double(), state), spec).model)
        fresh.load_state_dict({"params": whole})
        out["ema_restored_equal"] = all(
            torch.equal(fresh.params[k], v) for k, v in ema.params.items())
        out["ema_miou"] = validate(
            st.model, [(x, y)], 19,
            eval_step=on_ema(make_eval_step(st.model, 19), st.model, ema),
            device="cpu")[0]

        # accumulation over 2 micro-batches
        images, labels = batches["accumulate"]
        x, y = _rows(images, 2), _rows(labels, 2)
        st = _sgd(load(BiSeNet().double(), state), spec)
        calls = {"gather": 0, "reduce": 0}
        sharded = st.optimizer.sharded
        if sharded is not None:
            gather, reduce = sharded.gather, sharded.reduce_gradients

            def counted(name, fn):
                def call(*args):
                    calls[name] += not (name == "gather"
                                        and sharded.gathered)
                    return fn(*args)
                return call
            sharded.gather = counted("gather", gather)
            sharded.reduce_gradients = counted("reduce", reduce)
        metrics = make_accumulating_train_step(19)(
            st, split_microbatches(x, 2), split_microbatches(y, 2))
        out["accumulate"] = (_metrics(metrics),
                             numpy_state(st.state_dict()["model"]))
        out["accumulate_calls"] = calls

        # remat
        images, labels = batches["plain"]
        x, y = _rows(images), _rows(labels)
        st = _sgd(load(BiSeNet(remat=True).double(), state), spec)
        metrics = make_train_step(19)(st, x, y)
        out["remat"] = (_metrics(metrics),
                        numpy_state(st.state_dict()["model"]))

        # distillation: float and int8 teachers, replicated
        images, labels, calib = batches["distill"]
        x, y = _rows(images), _rows(labels)
        float_teacher = load(DeepLabV2(layers=THIN).double(), teacher)
        state32 = {k: torch.from_numpy(v).float()
                   for k, v in teacher.items()}
        shards = [_rows(c).float().permute(0, 3, 1, 2) for c in calib]
        int8_teacher = quantize_model("deeplab", state32, shards,
                                      device="cpu")
        out["int8_scales"] = int8_teacher.act_scales
        for name, t in (("float", float_teacher), ("int8", int8_teacher)):
            st = _sgd(load(BiSeNet().double(), state), spec, momentum=0.0)
            metrics = make_distill_step(t, 19, temperature=T, alpha=ALPHA)(
                st, x, y)
            out[f"distill_{name}"] = (_metrics(metrics),
                                      numpy_state(st.state_dict()["model"]))
    return out


# --- fixtures -------------------------------------------------------------

@pytest.fixture(scope="module")
def trees():
    import jax
    import jax.numpy as jnp

    from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
    from test_torch_deeplab import flax_tree

    gen = jax.jit(lambda key, x: FlaxBiSeNet(num_classes=19).init(
        key, x, train=True))(jax.random.key(0), jnp.zeros((2, *SIZE, 3)))
    return {"bisenet": _f64(dict(gen)),
            "deeplab": _f64(flax_tree(THIN, (1, *SIZE, 3), seed=3))}


def _batches():
    import test_torch_parallel as tp

    rng = np.random.default_rng(13)
    images = rng.normal(size=(4, *SIZE, 3))
    labels = rng.integers(0, 20, size=(4, *SIZE)).astype(np.int64)
    calib = [rng.normal(size=(4, *SIZE, 3)).astype(np.float32)
             for _ in range(2)]
    return {"plain": tp._void_batch(1), "accumulate": tp._void_batch(2),
            "distill": (images, labels, calib)}


@pytest.fixture(scope="module")
def runs(trees):
    args = (numpy_sd(trees["bisenet"]), numpy_sd(trees["deeplab"]),
            _batches())
    ranks = {name: run_ranks(extras_worker, world, (m, *args),
                             timeout_s=TIMEOUT_S)
             for name, (world, m) in MESHES.items()}
    return ranks, extras_worker(0, 1, 1, *args)


@pytest.fixture(scope="module")
def jax_steps(trees):
    """JAX's replicated steps on a 2-device data mesh: the plain step and
    its EMA, the accumulating step, the float-teacher distillation."""
    import jax
    import jax.numpy as jnp

    import test_torch_parallel as tp
    from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
    from rtsds_tpu.models.deeplabv2 import DeepLabV2 as FlaxDeepLab
    from rtsds_tpu.parallel import mesh as jax_mesh
    from rtsds_tpu.train.distill import make_distill_step
    from rtsds_tpu.train.ema import ema_init, ema_update

    plain_metrics, plain = tp._jax_step(trees, "bisenet", 1)
    before = numpy_sd(trees["bisenet"])
    with jax.enable_x64(True):
        params = {k: jnp.asarray(v) for k, v in plain.items()
                  if "running" not in k}
        ema = ema_update(ema_init({k: jnp.asarray(before[k])
                                   for k in params}), params, DECAY, 1)
        ema = {k: np.asarray(v) for k, v in ema.items()}
    acc = tp._jax_step(trees, "bisenet", 2)

    images, labels, _ = _batches()["distill"]
    mesh = jax_mesh.make_mesh(jax.devices()[:2])
    with jax.enable_x64(True):
        import optax

        from rtsds_tpu.train.state import TrainState as JaxTrainState

        v = jax.tree_util.tree_map(jnp.asarray, trees["bisenet"])
        tx = optax.sgd(0.01)
        state = jax_mesh.shard_state(JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=v["params"],
            batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
            apply_fn=FlaxBiSeNet(num_classes=19).apply, tx=tx), mesh)
        step = make_distill_step(
            FlaxDeepLab(num_classes=19, layers=THIN).apply, ignore_index=19,
            temperature=T, alpha=ALPHA, donate=False)
        new, metrics = step(
            state, jax.tree_util.tree_map(jnp.asarray, trees["deeplab"]),
            *jax_mesh.shard_batch((jnp.asarray(images),
                                   jnp.asarray(labels, jnp.int32)), mesh))
        distill = ({k: float(m) for k, m in metrics.items()},
                   numpy_sd(_f64({"params": new.params,
                                  "batch_stats": new.batch_stats})))
    return {"plain": (plain_metrics, plain), "ema": ema, "accumulate": acc,
            "distill_float": distill}


def _no_counters(sd: dict) -> dict:
    return {k: v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def _check_step(got, want, what, jax_want=None):
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-9,
                                   atol=1e-12, err_msg=f"{what} {k}")
    close(got[1], want[1], what, **SAME)
    if jax_want is not None:
        metrics, after = jax_want
        assert got[0]["correct"] == metrics["correct"], what
        for k in ("train_loss", "loss_ce", "loss_distill"):
            if k in metrics:
                np.testing.assert_allclose(got[0][k], metrics[k],
                                           rtol=LOSS_RTOL, err_msg=k)
        close(_no_counters(got[1]), after, f"{what} jax", **JAX)


# --- the tests ------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ema_on_the_model_axis(runs, jax_steps, mesh):
    ranks, one = runs
    for r in ranks[mesh]:
        close(r["ema"], one["ema"], f"{mesh} EMA", **SAME)
        close(r["ema"], jax_steps["ema"], f"{mesh} EMA jax", **JAX)
        assert r["ema_bytes"] == r["ema_reckoned"] < one["ema_bytes"]
        assert r["ema_restored_equal"]
        assert r["ema_miou"] == one["ema_miou"]
        for k, v in r["ema"].items():
            np.testing.assert_array_equal(v, ranks[mesh][0]["ema"][k])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_accumulation_on_the_model_axis(runs, jax_steps, mesh):
    ranks, one = runs
    for r in ranks[mesh]:
        _check_step(r["accumulate"], one["accumulate"], f"{mesh} acc",
                    jax_steps["accumulate"])
        # one gather before the first micro-batch, one reduce-scatter
        assert r["accumulate_calls"] == {"gather": 1, "reduce": 1}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_remat_on_the_model_axis(runs, jax_steps, mesh):
    ranks, one = runs
    for r in ranks[mesh]:
        _check_step(r["remat"], one["remat"], f"{mesh} remat",
                    jax_steps["plain"])


@pytest.mark.parametrize("teacher", ["float", "int8"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_distillation_on_the_model_axis(runs, jax_steps, mesh, teacher):
    ranks, one = runs
    for r in ranks[mesh]:
        assert r["int8_scales"] == one["int8_scales"]
        _check_step(r[f"distill_{teacher}"], one[f"distill_{teacher}"],
                    f"{mesh} distill {teacher}",
                    jax_steps.get(f"distill_{teacher}"))
