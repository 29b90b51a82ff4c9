"""The training extras on the spatial axis composed with the processes'
axes (ROADMAP 17.5b), and the hybrid mesh's DA step (17.6), on gloo CPU
ranks with ``RTSDS_CPU_DEVICES=2`` (each rank bands its frames over two
CPU "devices"), float64, BiSeNet-R18 at 32x64 (targets 32x48), every
network placed by ``parallel/mesh.py:place_state`` on
``make_mesh_from_config``'s mesh.

* ``{data: 2, spatial: 2}`` (2 ranks x 2 bands):
  - the self-training step with ClassMix, MinEnt and FDA on unequal
    global batches (source 4, target 8; ClassMix fed the scores JAX
    draws): against one process at rtol 1e-9 / atol 1e-12 (the coverages,
    float32 shares, at rtol 2^-22; the EMA, float32 arithmetic as JAX's,
    within one float32 rounding), and against JAX's step on a 2-device
    data mesh at test_torch_multirank_extras.py's limits (losses rtol
    1e-8, tensors rtol 1e-6 / atol 1e-10);
  - a K = 2 accumulation step of a remat student (its recompute runs
    the banded BN's all-reduces over the data group again; global batch
    4, frames 0 and 1 half void; rank r holds frames r and r + 2, its
    share of each micro-batch): against one process at rtol 1e-9 and an
    atol of 1e-12 plus ``UPDATE_ATOL`` times each tensor's largest update
    (float64 summation order through the banded BN of 2-frame
    micro-batches, see there), and JAX's accumulating step on a 2-device data mesh at rtol
    1e-6 / atol 1e-10 (losses 1e-9);
  - the hybrid mesh: a DA v1 step on a 2 x 1 (nodes x local GPUs) grid
    of the same two ranks, each rank's shard by ``shard_batch`` over
    ``make_hybrid_mesh(2)``, equals one process at 1e-9 / 1e-12.
* ``{spatial: 2, model: 2}`` (2 ranks, the model axis sharding the
  student): distillation of a remat student from an int8 teacher on
  JAX's scales, then the EMA's update, then a sliding-window validation
  of the student on the bands (each band's windows through the one
  sharded model, whose forward gathers its parameters): against one
  process at 1e-9 / 1e-12 (the EMA within one float32 rounding, K1's
  matrix exactly). Against JAX: the int8 teacher's soft targets on the
  bands against JAX's int8 teacher at test_torch_distill_int8.py's
  limits (mean 2e-3, max 0.05: bf16 rounds apart in XLA and ATen), and
  the step against JAX's one-device distillation step fed those same
  teacher logits (losses rtol 1e-8, the student rtol 1e-6 / atol 1e-10),
  the EMA against JAX's ``ema_update`` replayed on JAX's step at
  test_torch_ema.py's limits.

JAX's own step on a mesh that composes the spatial axis with another
misses its data-mesh update (ROADMAP C, test_torch_composed.py), so the
references are its data-mesh steps.  The workers import no JAX, so a
spawned rank does not load it; the two meshes' steps share one spawn of
the two ranks, with its own timeout.
"""

import numpy as np
import pytest
import torch

from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.parallel.launch import run_ranks
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.state import TrainState
from test_torch_composed import (  # noqa: F401 -- a fixture
    BANDS_ENV, SAME, _few_threads, axes, banded, load, numpy_state, placed,
    rank_shard)
from test_torch_multirank_extras import (  # noqa: F401 -- trees: a fixture
    COVERAGE_RTOL, ITERATIONS, JAX, LAMBDA, LR_D, LR_G, SIZE, T, ALPHA,
    _check_against_jax, _close, _jax_da, _sd, _st_batch, _st_kwargs, trees)

TIMEOUT_S = 180
EMA_F32 = dict(rtol=2.0 ** -22, atol=1e-12)  # one float32 rounding
# The accumulation step on 2 ranks x 2 bands against one process: float64
# sums in another order through the banded BN of 2-frame micro-batches.
# Read on this batch: up to 3.1e-12 absolute (context_path.conv1.weight,
# on elements near 7e-5: relative 3.5e-8, past atol 1e-12; its largest
# update 0.084), at most 4.6e-11 of a tensor's largest update; one process
# on 2 bands alone misses the whole map by 1.3e-12, 2 ranks without bands
# by 7e-13.  So a tensor's atol is 1e-12 plus this share of its largest
# update.
UPDATE_ATOL = 1e-9
DATA_SPATIAL = {"data": 2, "spatial": 2}
SPATIAL_MODEL = {"spatial": 2, "model": 2}


# --- rank workers -----------------------------------------------------------

def _gen(state: dict, spec: dict, momentum: float = 0.0, lr: float = LR_G,
         remat: bool = False) -> TrainState:
    model = load(BiSeNet(remat=remat).double(), state)
    return placed(TrainState(model, make_optimizer(
        "SGD", model.parameters(), lr, momentum=momentum)), spec)


def _whole(state: TrainState) -> dict:
    return numpy_state(state.state_dict()["model"])


def data_spatial_worker(rank, world, gen_sd, dis_sd, st_case, acc_case,
                        da_batch):
    """On ``{data: 2, spatial: 2}`` (one process: ``{}``, the whole
    batches): the self-training step, the accumulation step, and the DA v1
    step on the hybrid mesh's shards."""
    from rtsds_tpu_torch.models.discriminator import TinyDomainDiscriminator
    from rtsds_tpu_torch.parallel import distributed
    from rtsds_tpu_torch.parallel import mesh as port_mesh
    from rtsds_tpu_torch.train.accumulate import (
        make_accumulating_train_step, split_microbatches)
    from rtsds_tpu_torch.train.adversarial import make_adversarial_step
    from rtsds_tpu_torch.train.ema import ema_init
    from rtsds_tpu_torch.train.self_training import make_self_training_step

    spec = DATA_SPATIAL if world > 1 else {}

    def dis():
        model = load(TinyDomainDiscriminator().double(), dis_sd)
        return placed(TrainState(model, make_optimizer(
            "SGD", model.parameters(), LR_D, momentum=0.0)), spec)

    out = {}
    with distributed.data_parallel(*axes(spec)):
        kwargs, batch, scores = st_case
        (src, labels, tgt), devices = rank_shard(batch, spec)
        src, labels = banded(src, labels, devices)
        tgt, _ = banded(tgt, torch.zeros(tgt.shape[:3], dtype=torch.long),
                        devices)
        gen, d = _gen(gen_sd, spec), dis()
        ema = ema_init(gen.model)
        got = make_self_training_step(**kwargs)(
            gen, d, ema, src, labels, tgt, scores=torch.from_numpy(scores))
        out["st"] = ({k: float(v) for k, v in got.items()
                      if k != "preempted"}, _whole(gen), _whole(d),
                     {k: v.numpy().copy() for k, v in ema.items()})

        # K = 2: this rank's share of each micro-batch, as the loader lays
        # it out (data/multihost.py)
        images, labels, k = acc_case
        positions = distributed.shard_positions(len(images),
                                                distributed.rank(),
                                                distributed.world_size(), k)
        x, y = banded(torch.from_numpy(images[positions]),
                      torch.from_numpy(labels[positions]), devices)
        st = _gen(gen_sd, spec, momentum=0.9, remat=True)
        got = make_accumulating_train_step(19)(
            st, split_microbatches(x, k), split_microbatches(y, k))
        out["accumulate"] = ({k2: float(v) for k2, v in got.items()
                              if k2 != "preempted"}, _whole(st))

        # the hybrid mesh: the ranks as (nodes x local GPUs), each rank's
        # shard the flat data mesh's
        src, labels, tgt = (torch.from_numpy(a) for a in da_batch)
        if world > 1:
            hybrid = port_mesh.make_hybrid_mesh(
                2, devices=port_mesh.job_devices(torch.device("cpu")))
            out["hybrid_grid"] = hybrid.grid.shape
            src, labels, tgt = (port_mesh.shard_batch(a, hybrid)[rank]
                                for a in (src, labels, tgt))
        gen = _gen(gen_sd, {"data": 2} if world > 1 else {})
        d2 = load(TinyDomainDiscriminator().double(), dis_sd)
        d2 = placed(TrainState(d2, make_optimizer(
            "SGD", d2.parameters(), LR_D, momentum=0.0)),
            {"data": 2} if world > 1 else {})
        got = make_adversarial_step(LAMBDA, ITERATIONS, 1, 19, "v1")(
            gen, d2, src, labels, tgt)
        out["hybrid"] = ({k: float(v) for k, v in got.items()
                          if k != "preempted"}, _whole(gen), _whole(d2))
    return out


def spatial_model_worker(rank, world, student_sd, teacher_sd, batch,
                         jax_scales):
    """On ``{spatial: 2, model: 2}`` (one process: ``{}``): the int8
    teacher on JAX's scales distils into a remat student sharded over the
    model axis; the EMA's update after the step; the teacher's logits on
    the bands (gathered); the student's sliding-window K1 matrix on the
    bands."""
    from rtsds_tpu_torch.eval.sliding import make_sliding_eval_step
    from rtsds_tpu_torch.models import deeplab_int8
    from rtsds_tpu_torch.ops.quant import QuantizedSegmentor
    from rtsds_tpu_torch.parallel import distributed
    from rtsds_tpu_torch.parallel.spatial import gathered
    from rtsds_tpu_torch.train.distill import make_distill_step
    from rtsds_tpu_torch.train.ema import ema_update, setup_ema

    spec = SPATIAL_MODEL if world > 1 else {}
    state32 = {k: torch.from_numpy(v).float() for k, v in teacher_sd.items()}
    with distributed.data_parallel(*axes(spec)):
        (images, labels), devices = rank_shard(batch, spec)
        x, y = banded(images, labels, devices)
        tree = deeplab_int8.build_quantized(state32, jax_scales)
        teacher = QuantizedSegmentor(
            deeplab_int8.make_walk([*tree["q8"], *tree["bf16"]]), tree)
        st = _gen(student_sd, spec, momentum=0.9, lr=0.01, remat=True)
        ema = setup_ema(st.model)
        got = make_distill_step(teacher, 19, temperature=T, alpha=ALPHA)(
            st, x, y)
        ema_update(ema.params, st.model, 0.99, st.step)
        with torch.no_grad():
            soft = gathered(teacher(x.to(torch.float32).permute(
                0, 3, 1, 2))).float().numpy()
        student = _whole(st)
        st.model.eval()
        hist = make_sliding_eval_step(st.model, SIZE, 19, window=(16, 32))(
            x, y, torch.zeros((19, 19), dtype=torch.int32))
        return ({k: float(v) for k, v in got.items() if k != "preempted"},
                student, {k: v.numpy().copy() for k, v in
                          ema.state_dict()["params"].items()}, soft,
                hist.numpy())


def composed_worker(rank, world, data_spatial_args, spatial_model_args):
    """Both meshes' steps in one spawn of the two ranks."""
    return (data_spatial_worker(rank, world, *data_spatial_args),
            spatial_model_worker(rank, world, *spatial_model_args))


# --- fixtures ----------------------------------------------------------------

def _acc_batch():
    """The accumulation batch: global batch 4 at 32x64, frames 0 and 1
    half void (rank r's share: frames r and r + 2)."""
    rng = np.random.default_rng(11)
    images = rng.normal(size=(4, *SIZE, 3))
    labels = rng.integers(0, 19, size=(4, *SIZE)).astype(np.int64)
    labels[[0, 1], :, : SIZE[1] // 2] = 19
    return images, labels


def _da_batch():
    rng = np.random.default_rng(3)
    src = rng.normal(size=(4, *SIZE, 3))
    tgt = rng.normal(size=(4, 32, 48, 3))
    labels = rng.integers(0, 20, size=(4, *SIZE)).astype(np.int64)
    return src, labels, tgt


@pytest.fixture(scope="module")
def runs(trees):
    """JAX's self-training and accumulating steps on a 2-device data mesh
    and its int8 teacher; the port's steps on both meshes (one spawn of
    the two ranks) and in one process."""
    import jax.numpy as jnp

    from rtsds_tpu.train import distill as jax_distill
    from test_torch_multirank_extras import _distill_batch, _jax_f32

    kwargs = _st_kwargs(True, 0.05, 0.05)
    batch = _st_batch(4, 8)
    jax_kwargs = {k: v for k, v in kwargs.items()
                  if k not in ("lambda_", "iterations", "ignore_index",
                               "classmix_seed")}
    jax_st = _jax_da(trees, batch, "st", **jax_kwargs)
    images, labels = _acc_batch()
    jax_acc = _jax_accumulating_step(trees["bisenet"], images, labels)
    data_spatial_args = (
        _sd(trees["bisenet"]), _sd(trees["discriminator"]),
        (kwargs, batch, jax_st[2]), (images, labels, 2), _da_batch())

    images, labels, calib = _distill_batch()
    j_apply, jtree = jax_distill.quantize_teacher(
        "deeplab", _jax_f32(trees["deeplab"]),
        [jnp.asarray(np.concatenate(calib))])
    jax_scales = {n: float(e[2]) for n, e in jtree["q8"].items()}
    want_soft = np.asarray(j_apply(jtree, jnp.asarray(images, jnp.float32))
                           .astype(jnp.float32))
    spatial_model_args = (_sd(trees["bisenet"]), _sd(trees["deeplab"]),
                          (images, labels), jax_scales)

    ranks = run_ranks(composed_worker, 2,
                      (data_spatial_args, spatial_model_args),
                      timeout_s=TIMEOUT_S, env=BANDS_ENV)
    one = composed_worker(0, 1, data_spatial_args, spatial_model_args)
    return ranks, one, (jax_st, jax_acc, want_soft)


@pytest.fixture(scope="module")
def data_spatial(runs):
    ranks, one, (jax_st, jax_acc, _) = runs
    return [r[0] for r in ranks], one[0], jax_st, jax_acc


def _jax_accumulating_step(tree, images, labels):
    """JAX's float64 K = 2 accumulating step (SGD, momentum 0.9) on a
    2-device data mesh, the micro-batches split over ``data``."""
    import jax
    import jax.numpy as jnp
    import optax

    from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
    from rtsds_tpu.parallel import mesh as jax_mesh
    from rtsds_tpu.train.accumulate import (
        make_accumulating_train_step, split_microbatches)
    from rtsds_tpu.train.state import TrainState as JaxTrainState
    from test_torch_multirank_extras import _jax_sd

    mesh = jax_mesh.make_mesh(jax.devices()[:2])
    spec = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(None, "data"))
    with jax.enable_x64(True):
        v = jax.tree_util.tree_map(jnp.asarray, tree)
        tx = optax.sgd(0.01, momentum=0.9)
        state = jax_mesh.shard_state(JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=v["params"],
            batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
            apply_fn=FlaxBiSeNet(num_classes=19).apply, tx=tx), mesh)
        new, metrics = make_accumulating_train_step(
            ignore_index=19, donate=False)(
            state,
            jax.device_put(split_microbatches(jnp.asarray(images), 2), spec),
            jax.device_put(split_microbatches(
                jnp.asarray(labels, jnp.int32), 2), spec))
        metrics = {k: float(v) for k, v in metrics.items()}
        after = _jax_sd({"params": new.params,
                         "batch_stats": new.batch_stats})
    return metrics, after


def _ranks_equal(parts) -> None:
    for k in parts[0]:
        np.testing.assert_array_equal(parts[0][k], parts[1][k], err_msg=k)


def _counters_dropped(sd: dict) -> dict:
    return {k: v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


# --- {data: 2, spatial: 2} ---------------------------------------------------

def test_self_training_on_data_x_spatial_equals_one_process(data_spatial):
    ranks, one, _, _ = data_spatial
    for part in (1, 2):
        _ranks_equal([r["st"][part] for r in ranks])
    got, want = ranks[0]["st"], one["st"]
    coverages = ("pl_coverage", "mix_coverage")
    assert all(0.0 < got[0][k] < 1.0 for k in coverages)
    assert "loss_entropy" in got[0]
    _close({k: got[0][k] for k in coverages},
           {k: want[0][k] for k in coverages}, "coverage",
           rtol=COVERAGE_RTOL)
    _close({k: v for k, v in got[0].items() if k not in coverages},
           {k: v for k, v in want[0].items() if k not in coverages},
           "metrics", **SAME)
    _close(got[1], want[1], "G", **SAME)
    _close(got[2], want[2], "D", **SAME)
    _close(got[3], want[3], "EMA", **EMA_F32)


def test_self_training_on_data_x_spatial_matches_jax_data_mesh(data_spatial):
    ranks, _, (metrics, after, _), _ = data_spatial
    _check_against_jax(ranks[0]["st"], metrics, after, "self-training")


def test_accumulation_on_data_x_spatial_equals_one_process_and_jax(
        data_spatial, trees):
    ranks, one, _, (want_metrics, want) = data_spatial
    _ranks_equal([r["accumulate"][1] for r in ranks])
    (got_metrics, got), (one_metrics, one_sd) = (ranks[0]["accumulate"],
                                                 one["accumulate"])
    _close(got_metrics, one_metrics, "metrics", **SAME)
    before = _sd(trees["bisenet"])
    assert sorted(got) == sorted(one_sd)
    for k in one_sd:
        update = np.abs(one_sd[k] - before.get(k, 0)).max()
        np.testing.assert_allclose(
            got[k], one_sd[k], rtol=SAME["rtol"],
            atol=SAME["atol"] + UPDATE_ATOL * update, err_msg=f"state {k}")
    np.testing.assert_allclose(got_metrics["train_loss"],
                               want_metrics["train_loss"], rtol=1e-9)
    assert got_metrics["correct"] == want_metrics["correct"]
    _close(_counters_dropped(got), want, "jax", **JAX)


def test_da_v1_on_a_hybrid_grid_equals_one_process(data_spatial):
    ranks, one, _, _ = data_spatial
    assert ranks[0]["hybrid_grid"] == (2, 1)
    _ranks_equal([r["hybrid"][1] for r in ranks])
    for i, what in enumerate(("metrics", "G", "D")):
        _close(ranks[0]["hybrid"][i], one["hybrid"][i], what, **SAME)


# --- {spatial: 2, model: 2} --------------------------------------------------

@pytest.fixture(scope="module")
def spatial_model(runs):
    ranks, one, (_, _, want_soft) = runs
    return [r[1] for r in ranks], one[1], want_soft


def test_int8_distillation_ema_remat_on_spatial_x_model_equals_one_process(
        spatial_model):
    from test_torch_multirank_extras import _distill_batch

    ranks, one, _ = spatial_model
    for part in (1, 2):
        _ranks_equal([r[part] for r in ranks])
    got = ranks[0]
    assert got[0]["loss_distill"] > 0
    _close(got[0], one[0], "metrics", **SAME)
    _close(got[1], one[1], "student", **SAME)
    _close(got[2], one[2], "EMA", **EMA_F32)
    np.testing.assert_array_equal(got[3], one[3])
    # the sliding protocol on the bands, through the one sharded model
    for r in ranks:
        np.testing.assert_array_equal(r[4], one[4])
    assert got[4].sum() == (_distill_batch()[1] < 19).sum()


def _jax_distill_step(tree, teacher_logits, images, labels):
    """JAX's float64 one-device distillation step (SGD 0.01, momentum 0.9)
    of ``tree``'s BiSeNet, its teacher's output ``teacher_logits`` (NHWC,
    bf16 as JAX's int8 teacher gives it)."""
    import jax
    import jax.numpy as jnp
    import optax

    from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
    from rtsds_tpu.train.distill import make_distill_step
    from rtsds_tpu.train.state import TrainState as JaxTrainState
    from test_torch_multirank_extras import _jax_sd

    with jax.enable_x64(True):
        v = jax.tree_util.tree_map(jnp.asarray, tree)
        tx = optax.sgd(0.01, momentum=0.9)
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=v["params"],
            batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
            apply_fn=FlaxBiSeNet(num_classes=19).apply, tx=tx)
        step = make_distill_step(lambda t, x, train=False: t,
                                 ignore_index=19, temperature=T,
                                 alpha=ALPHA, donate=False)
        new, metrics = step(state, jnp.asarray(teacher_logits, jnp.bfloat16),
                            jnp.asarray(images),
                            jnp.asarray(labels, jnp.int32))
        metrics = {k: float(v) for k, v in metrics.items()}
        after = _jax_sd({"params": new.params,
                         "batch_stats": new.batch_stats})
    return metrics, after


def test_int8_distillation_on_spatial_x_model_matches_jax(spatial_model,
                                                          trees):
    import jax.numpy as jnp

    from rtsds_tpu.train.ema import ema_update as jax_ema_update
    from test_torch_multirank_extras import LOSS_RTOL, _distill_batch

    ranks, _, want_soft = spatial_model
    metrics, student, ema, soft, _ = ranks[0]

    def probs(z):
        z = z / T
        e = np.exp(z - z.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    # the teacher: the port's int8 walk on the bands, on JAX's scales
    soft = soft.transpose(0, 2, 3, 1)
    gap = np.abs(probs(soft) - probs(want_soft))
    assert gap.mean() < 2e-3 and gap.max() < 0.05, (gap.mean(), gap.max())

    # the step: JAX's on one device, fed the port teacher's logits
    images, labels, _ = _distill_batch()
    want_metrics, want = _jax_distill_step(trees["bisenet"], soft,
                                                   images, labels)
    for k in ("train_loss", "loss_ce", "loss_distill"):
        np.testing.assert_allclose(metrics[k], want_metrics[k],
                                   rtol=LOSS_RTOL, err_msg=k)
    assert metrics["correct"] == want_metrics["correct"]
    assert metrics["total"] == want_metrics["total"]
    _close(_counters_dropped(student), want, "student", **JAX)

    # the EMA: JAX's update replayed on JAX's step
    before = _sd(trees["bisenet"])
    names = sorted(ema)
    replayed = jax_ema_update(
        {k: jnp.asarray(before[k], jnp.float32) for k in names},
        {k: jnp.asarray(want[k], jnp.float32) for k in names},
        decay=0.99, step=1)
    for k in names:
        np.testing.assert_allclose(ema[k], np.asarray(replayed[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
