"""Self-training, distillation (float and int8 teachers) and the QAT step on
2 ranks of the data axis (gloo, CPU), against one process on the global
batch and against the JAX package, whose arrays are global.

Every step runs on 2 spawned ranks (``parallel/launch.py:run_ranks``, each
call with its own timeout), each rank on its contiguous shard of the global
batch, and in one process on the whole global batch:

* CBST calibration's thresholds equal one process's, and JAX's, exactly;
* the self-training step (ClassMix, FDA, MinEnt, per-class thresholds,
  the EMA teacher), float64: against one process at rtol 1e-9 / atol
  1e-12 (the coverages, float32 shares as JAX's are float32 means, at two
  float32 roundings, rtol 2^-22), against JAX's step on a 2-device data mesh at
  test_torch_self_training.py's limits (losses rtol 1e-8, tensors rtol
  1e-6 / atol 1e-10; JAX's FDA cast widened to float64 as there);
* unequal global batches (source 4, target 8): a DA v1 step with FDA (the
  source frame ``i`` takes target frame ``i % 8``) and a ClassMix step
  (target frame ``i`` takes source frame ``i % 4``), each against one
  process and JAX at the same limits;
* the distillation step under a float DeepLabV2 teacher, float64: against
  one process (1e-9 / 1e-12) and JAX's 2-device step at
  test_torch_distill.py's limits (losses rtol 1e-8, tensors 1e-6 / 1e-10);
* the int8 teacher's activation scales, calibrated on each rank's shards
  under ``max`` and ``percentile``: exactly one process's, and within
  2^-6 of JAX's (test_torch_distill_int8.py's limit, a bf16 calibration
  forward on both sides); the int8-teacher distillation step against one
  process (1e-9 / 1e-12), the teacher's soft targets against JAX's at
  test_torch_distill_int8.py's limits;
* the QAT step through ``ScheduledOptimizer``: its scales calibrated on
  the shards equal one process's; float64 (the fake-quant walk in the
  tree's dtype) against one process at 1e-9 / 1e-12; float32 against
  JAX's 2-device step at test_torch_qat.py's limits (loss rtol 1e-5, each
  parameter within 1e-2 of its largest update + 1e-6), both on JAX's
  scales;
* the CLI's ``--multihost`` self-training and distillation runs on 2
  ranks: both ranks report the same history.

The rank workers live here and the module imports no JAX at its top, so a
spawned rank does not load it.
"""

import numpy as np
import pytest
import torch

from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2
from rtsds_tpu_torch.models.discriminator import TinyDomainDiscriminator
from rtsds_tpu_torch.parallel.launch import run_ranks
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.state import TrainState
from test_torch_multihost import (
    THIN, TIMEOUT_S, _config_with, _same, cli_worker, load, make_model,
    metrics_of, numpy_state, shard, train_state)

SIZE = (32, 64)
TGT = (32, 48)
WORLD = 2
SAME = dict(rtol=1e-9, atol=1e-12)
JAX = dict(rtol=1e-6, atol=1e-10)
LOSS_RTOL = 1e-8
LAMBDA, ITERATIONS, LR_G, LR_D = 0.1, 5, 0.01, 0.02
SEED = 5
T, ALPHA = 2.0, 0.4
SCALE_RTOL = 2.0 ** -6
UPDATE_RTOL = 1e-2
COVERAGE_RTOL = 2.0 ** -22  # two float32 roundings
ST_CASES = {
    # name: (global source, global target, classmix, lambda_ent, fda_beta)
    "classmix_minent_fda": (4, 4, True, 0.05, 0.05),
    "classmix_unequal": (4, 8, True, 0.0, 0.0),
}
FDA_UNEQUAL = (4, 8)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _close(got: dict, want: dict, what: str, **tol):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   err_msg=f"{what} {k}", **tol)


def _ranks_equal(parts: list) -> None:
    for k in parts[0]:
        for other in parts[1:]:
            np.testing.assert_array_equal(parts[0][k], other[k], err_msg=k)


def _thresholds(n=19):
    return np.linspace(0.12, 0.24, n)


def _st_batch(ns: int, nt: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(ns, *SIZE, 3))
    tgt = rng.normal(size=(nt, *TGT, 3))
    labels = rng.integers(0, 19, size=(ns, *SIZE)).astype(np.int64)
    labels[:ns // 2, : SIZE[0] // 2] = 19
    return src, labels, tgt


# --- rank workers ----------------------------------------------------------

def _dis(dis_sd) -> TrainState:
    model = load(TinyDomainDiscriminator().double(), dis_sd)
    return TrainState(model, make_optimizer("SGD", model.parameters(), LR_D,
                                            momentum=0.0))


def st_worker(rank, world, gen_sd, dis_sd, cases):
    """One self-training step of each case ``{name: (kwargs, (src, labels,
    tgt), scores)}`` on this rank's shards; ``scores`` are the global
    target batch's.  Its metrics, G, D and the EMA after it."""
    from rtsds_tpu_torch.train.ema import ema_init
    from rtsds_tpu_torch.train.self_training import make_self_training_step

    out = {}
    for name, (kwargs, batch, scores) in cases.items():
        gen = train_state("bisenet", gen_sd, momentum=0.0, lr=LR_G)
        dis = _dis(dis_sd)
        ema = ema_init(gen.model)
        src, labels, tgt = (torch.from_numpy(shard(rank, world, a))
                            for a in batch)
        got = make_self_training_step(**kwargs)(
            gen, dis, ema, src, labels, tgt,
            scores=None if scores is None else torch.from_numpy(scores))
        out[name] = (metrics_of(got), numpy_state(gen.model),
                     numpy_state(dis.model),
                     {k: v.numpy().copy() for k, v in ema.items()})
    return out


def fda_worker(rank, world, gen_sd, dis_sd, batch):
    """One DA v1 step with FDA on this rank's shards of unequal global
    batches."""
    from rtsds_tpu_torch.train.adversarial import make_adversarial_step

    gen = train_state("bisenet", gen_sd, momentum=0.0, lr=LR_G)
    dis = _dis(dis_sd)
    src, labels, tgt = (torch.from_numpy(shard(rank, world, a))
                        for a in batch)
    got = make_adversarial_step(LAMBDA, ITERATIONS, epochs=1,
                                ignore_index=19, variant="v1",
                                fda_beta=0.05)(gen, dis, src, labels, tgt)
    return metrics_of(got), numpy_state(gen.model), numpy_state(dis.model)


def cbst_worker(rank, world, gen_sd, batches):
    """CBST thresholds from this rank's shards of the global batches."""
    from rtsds_tpu_torch.train.self_training import (
        calibrate_class_thresholds)

    model = load(make_model("bisenet"), gen_sd)
    return calibrate_class_thresholds(
        model, [(torch.from_numpy(shard(rank, world, x)), None)
                for x in batches], 19, portion=0.5)


def distill_worker(rank, world, student_sd, teacher_sd, batch, calib,
                   jax_scales):
    """On this rank's shards: the float-teacher distillation step; the int8
    teacher's scales under ``max`` and ``percentile`` from the calibration
    batches; the int8-teacher step; the int8 teacher's logits on JAX's
    scales."""
    from rtsds_tpu_torch.models import deeplab_int8
    from rtsds_tpu_torch.ops.quant import QuantizedSegmentor, quantize_model
    from rtsds_tpu_torch.train.distill import make_distill_step

    images, labels = (torch.from_numpy(shard(rank, world, a)) for a in batch)
    out = {}
    teacher = load(DeepLabV2(layers=THIN).double(), teacher_sd)
    student = train_state("bisenet", student_sd, momentum=0.0)
    got = make_distill_step(teacher, 19, temperature=T, alpha=ALPHA)(
        student, images, labels)
    out["float"] = (metrics_of(got), numpy_state(student.model))

    state32 = {k: torch.from_numpy(v).float() for k, v in teacher_sd.items()}
    shards = [torch.from_numpy(shard(rank, world, x)).float()
              .permute(0, 3, 1, 2) for x in calib]
    scales = {}
    for stat in ("max", "percentile"):
        q = quantize_model("deeplab", state32, shards, calib_stat=stat,
                           calib_percentile=99.0, device="cpu")
        scales[stat] = q.act_scales
        if stat == "max":
            int8_teacher = q
    out["scales"] = scales
    student = train_state("bisenet", student_sd, momentum=0.0)
    got = make_distill_step(int8_teacher, 19, temperature=T, alpha=ALPHA)(
        student, images, labels)
    out["int8"] = (metrics_of(got), numpy_state(student.model))

    tree = deeplab_int8.build_quantized(state32, jax_scales)
    on_jax_scales = QuantizedSegmentor(
        deeplab_int8.make_walk([*tree["q8"], *tree["bf16"]]), tree)
    with torch.no_grad():
        out["soft"] = on_jax_scales(images.float().permute(0, 3, 1, 2)) \
            .float().numpy()
    return out


def qat_worker(rank, world, state_np, batch, calib, jax_scales):
    """The QAT prep's scales from this rank's shards, and one QAT step on
    JAX's scales in float64 and in float32 through ``make_optimizer``'s
    ``ScheduledOptimizer``."""
    from rtsds_tpu_torch.train import qat
    from rtsds_tpu_torch.train.supervised import make_train_step

    state = {k: torch.from_numpy(v) for k, v in state_np.items()}
    shards = [torch.from_numpy(shard(rank, world, x)).permute(0, 3, 1, 2)
              for x in calib]
    prep = qat.prepare_qat("deeplab", state, shards, device="cpu")
    out = {"scales": dict(prep.act_scales)}
    images, labels = (torch.from_numpy(shard(rank, world, a)) for a in batch)
    prep = prep._replace(act_scales=dict(jax_scales))
    for dtype in (torch.float64, torch.float32):
        model = qat.QATSegmentor(prep).to(dtype)
        st = TrainState(model, make_optimizer("SGD", model.parameters(), 0.1,
                                              momentum=0.0))
        got = make_train_step(19)(st, images.to(dtype), labels)
        out[str(dtype)] = (metrics_of(got), {
            k: v.detach().numpy().copy()
            for k, v in model.named_parameters()})
    return out


def helpers_worker(rank, world, cases, values):
    """``cyclic_partners`` of this rank's shards for each ``(n, m)`` case
    (rows numbered by their global index), ``rank_rows`` of a global
    draw, and ``global_max`` of this rank's values."""
    from rtsds_tpu_torch.parallel.distributed import (
        cyclic_partners, global_max, rank_rows)

    out = {}
    for n, m in cases:
        partner = torch.from_numpy(shard(rank, world, np.arange(m)))
        out[(n, m)] = cyclic_partners(partner, n).numpy()
    out["rows"] = rank_rows(torch.arange(8)).numpy()
    out["max"] = global_max(torch.from_numpy(values[rank])).numpy()
    return out


# --- the JAX side ----------------------------------------------------------

@pytest.fixture(scope="module")
def trees():
    import jax
    import jax.numpy as jnp

    from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
    from rtsds_tpu.models.discriminator import (
        TinyDomainDiscriminator as FlaxTinyDiscriminator)
    from test_torch_deeplab import flax_tree

    def f64(tree):
        return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                      tree)

    bisenet = FlaxBiSeNet(num_classes=19)
    gen = jax.jit(lambda key, x: bisenet.init(key, x, train=True))(
        jax.random.key(0), jnp.zeros((2, *SIZE, 3)))
    dis = FlaxTinyDiscriminator(num_classes=19).init(
        jax.random.key(1), jnp.zeros((2, *TGT, 19)))
    return {"bisenet": f64(dict(gen)), "discriminator": f64(dict(dis)),
            "deeplab": f64(flax_tree(THIN, (1, *SIZE, 3), seed=3))}


def _sd(variables) -> dict:
    from rtsds_tpu_torch.models.pretrained import state_dict_from_flax

    return {k: v.numpy() for k, v in state_dict_from_flax(variables).items()}


def _jax_mesh():
    import jax

    from rtsds_tpu.parallel import mesh as jax_mesh

    return jax_mesh, jax_mesh.make_mesh(jax.devices()[:WORLD])


def _jax_state(variables, apply_fn, lr, mesh, jax_mesh):
    import jax.numpy as jnp
    import optax

    from rtsds_tpu.train.state import TrainState as JaxTrainState

    tx = optax.sgd(lr)
    return jax_mesh.shard_state(JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables.get("batch_stats"),
        opt_state=tx.init(variables["params"]), apply_fn=apply_fn, tx=tx),
        mesh)


def _jax_sd(variables) -> dict:
    import jax

    return _sd(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                      variables))


def _without_counters(sd: dict) -> dict:
    return {k: v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def _jax_da(trees, batch, kind, **kwargs):
    """JAX's float64 self-training (``kind="st"``) or v1 adversarial step
    on a 2-device data mesh: metrics, G, D (and the EMA), as state dicts;
    with ClassMix, the scores it drew."""
    import jax
    import jax.numpy as jnp

    import rtsds_tpu.ops.fda as jax_fda
    from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
    from rtsds_tpu.models.discriminator import (
        TinyDomainDiscriminator as FlaxTinyDiscriminator)
    from rtsds_tpu.train.adversarial import make_adversarial_step
    from rtsds_tpu.train.ema import ema_init
    from rtsds_tpu.train.self_training import make_self_training_step
    from test_torch_fda_entropy import _WideJnp

    jax_mesh, mesh = _jax_mesh()
    src, labels, tgt = batch
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_fda, "jnp", _WideJnp())
    try:
        with jax.enable_x64(True):
            gen_vars = jax.tree_util.tree_map(jnp.asarray, trees["bisenet"])
            dis_vars = jax.tree_util.tree_map(jnp.asarray,
                                              trees["discriminator"])
            gen = _jax_state(gen_vars, FlaxBiSeNet(num_classes=19).apply,
                             LR_G, mesh, jax_mesh)
            dis = _jax_state(dis_vars,
                             FlaxTinyDiscriminator(num_classes=19).apply,
                             LR_D, mesh, jax_mesh)
            args = jax_mesh.shard_batch(
                (jnp.asarray(src), jnp.asarray(labels, jnp.int32)), mesh)
            args = (*args, jax_mesh.shard_batch(jnp.asarray(tgt), mesh))
            if kind == "st":
                step = make_self_training_step(
                    LAMBDA, ITERATIONS, 19, donate=False,
                    classmix_seed=SEED, **kwargs)
                gen, dis, ema, metrics = step(gen, dis,
                                              ema_init(gen.params), *args)
                ema = _jax_sd({"params": ema})
            else:
                step = make_adversarial_step(LAMBDA, ITERATIONS, epochs=1,
                                             ignore_index=19, donate=False,
                                             **kwargs)
                gen, dis, metrics = step(gen, dis, *args)
                ema = None
            metrics = {k: float(v) for k, v in metrics.items()}
            scores = np.array(jax.random.uniform(
                jax.random.fold_in(jax.random.key(SEED), 0),
                (tgt.shape[0], 19)))
            after = (_jax_sd({"params": gen.params,
                              "batch_stats": gen.batch_stats}),
                     _jax_sd({"params": dis.params}), ema)
    finally:
        mp.undo()
    return metrics, after, scores


def _check_against_jax(got, want_metrics, want_after, what):
    got_metrics, got_gen, got_dis, *got_ema = got
    want_gen, want_dis, want_ema = want_after
    assert got_metrics["correct"] == want_metrics["correct"], what
    for k in want_metrics:
        if k not in ("correct", "total"):
            np.testing.assert_allclose(
                got_metrics[k], want_metrics[k],
                rtol=COVERAGE_RTOL if k.endswith("coverage") else LOSS_RTOL,
                atol=1e-12, err_msg=f"{what} {k}")
    _close(_without_counters(got_gen), want_gen, f"{what} G", **JAX)
    _close(got_dis, want_dis, f"{what} D", **JAX)
    if want_ema is not None:
        got_ema = got_ema[0]
        _close(got_ema, {k: want_ema[k] for k in got_ema}, f"{what} EMA",
               **JAX)


# --- the helpers ------------------------------------------------------------

def test_partners_rows_and_max_on_two_ranks_are_the_global_batchs():
    """Global row ``i`` of an ``n``-frame batch pairs with row ``i % m`` of
    an ``m``-frame one, the JAX package's pairing over its global arrays:
    with equal batches each rank's own rows, otherwise gathered where a
    rank lacks them; a rank's rows of a global draw are its shard's; the
    max is the ranks' elementwise max."""
    cases = [(4, 4), (4, 8), (8, 4), (2, 6), (6, 2)]
    values = [np.array([1.0, -3.0, 5.0]), np.array([2.0, -4.0, 0.5])]
    ranks = run_ranks(helpers_worker, WORLD, (cases, values),
                      timeout_s=TIMEOUT_S)
    for n, m in cases:
        got = np.concatenate([r[(n, m)] for r in ranks])
        np.testing.assert_array_equal(got, np.arange(n) % m)
        np.testing.assert_array_equal(
            helpers_worker(0, 1, [(n, m)], values[:1])[(n, m)],
            np.arange(n) % m)
    np.testing.assert_array_equal(ranks[1]["rows"], np.arange(4, 8))
    for r in ranks:
        np.testing.assert_array_equal(r["max"], [2.0, -3.0, 5.0])


# --- self-training and FDA -------------------------------------------------

def _st_kwargs(classmix, lambda_ent, fda_beta):
    return dict(lambda_=LAMBDA, iterations=ITERATIONS, ignore_index=19,
                threshold=_thresholds(), lambda_pl=0.7, ema_decay=0.99,
                lambda_ent=lambda_ent, fda_beta=fda_beta, classmix=classmix,
                classmix_seed=SEED)


@pytest.fixture(scope="module")
def st_runs(trees):
    """JAX's step of each case, and the port's on 2 ranks and on one
    process, ClassMix fed the scores JAX drew."""
    gen, dis = _sd(trees["bisenet"]), _sd(trees["discriminator"])
    jax_runs, cases = {}, {}
    for name, (ns, nt, classmix, lambda_ent, fda_beta) in ST_CASES.items():
        batch = _st_batch(ns, nt)
        kwargs = _st_kwargs(classmix, lambda_ent, fda_beta)
        jax_kwargs = {k: v for k, v in kwargs.items()
                      if k not in ("lambda_", "iterations", "ignore_index",
                                   "classmix_seed")}
        jax_runs[name] = _jax_da(trees, batch, "st", **jax_kwargs)
        cases[name] = (kwargs, batch, jax_runs[name][2])
    ranks = run_ranks(st_worker, WORLD, (gen, dis, cases),
                      timeout_s=TIMEOUT_S)
    one = st_worker(0, 1, gen, dis, cases)
    return ranks, one, jax_runs


@pytest.mark.parametrize("case", sorted(ST_CASES))
def test_self_training_step_on_two_ranks_equals_one_process(st_runs, case):
    ranks, one, _ = st_runs
    for part in (1, 2, 3):
        _ranks_equal([r[case][part] for r in ranks])
    assert ranks[0][case][0] == ranks[1][case][0]
    got, want = ranks[0][case], one[case]
    assert 0.0 < got[0]["pl_coverage"] < 1.0
    assert 0.0 < got[0]["mix_coverage"] < 1.0
    # the coverages are float32 shares, as JAX's float32 means: each rank's
    # rounded once, their sum once more
    coverages = ("pl_coverage", "mix_coverage")
    _close({k: got[0][k] for k in coverages},
           {k: want[0][k] for k in coverages}, case, rtol=COVERAGE_RTOL)
    _close({k: v for k, v in got[0].items() if k not in coverages},
           {k: v for k, v in want[0].items() if k not in coverages},
           f"{case} metrics", **SAME)
    for i, what in enumerate(("G", "D", "EMA"), start=1):
        _close(got[i], want[i], f"{case} {what}", **SAME)


@pytest.mark.parametrize("case", sorted(ST_CASES))
def test_self_training_step_on_two_ranks_matches_jax(st_runs, case):
    ranks, _, jax_runs = st_runs
    metrics, after, _ = jax_runs[case]
    _check_against_jax(ranks[0][case], metrics, after, case)


@pytest.fixture(scope="module")
def fda_runs(trees):
    gen, dis = _sd(trees["bisenet"]), _sd(trees["discriminator"])
    batch = _st_batch(*FDA_UNEQUAL, seed=9)
    ranks = run_ranks(fda_worker, WORLD, (gen, dis, batch),
                      timeout_s=TIMEOUT_S)
    one = fda_worker(0, 1, gen, dis, batch)
    metrics, (want_gen, want_dis, _), _ = _jax_da(
        trees, batch, "da", variant="v1", fda_beta=0.05)
    return ranks, one, (metrics, (want_gen, want_dis, None))


def test_fda_step_on_unequal_global_batches_equals_one_process(fda_runs):
    """Global source 4 and target 8: rank 1's source frames 2-3 take
    target frames 2-3, which rank 0 holds."""
    ranks, one, _ = fda_runs
    for part in (1, 2):
        _ranks_equal([r[part] for r in ranks])
    for i, what in enumerate(("metrics", "G", "D")):
        _close(ranks[0][i], one[i], f"fda {what}", **SAME)


def test_fda_step_on_unequal_global_batches_matches_jax(fda_runs):
    ranks, _, (metrics, after) = fda_runs
    _check_against_jax(ranks[0], metrics, after, "fda")


def test_cbst_thresholds_on_two_ranks_equal_one_process_and_jax(trees):
    import jax
    import jax.numpy as jnp

    from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
    from rtsds_tpu.train.self_training import (
        calibrate_class_thresholds as jax_calibrate)

    rng = np.random.default_rng(3)
    batches = [rng.normal(size=(4, *TGT, 3)) for _ in range(2)]
    gen = _sd(trees["bisenet"])
    ranks = run_ranks(cbst_worker, WORLD, (gen, batches),
                      timeout_s=TIMEOUT_S)
    one = cbst_worker(0, 1, gen, batches)
    with jax.enable_x64(True):
        variables = jax.tree_util.tree_map(
            jnp.asarray, {"params": trees["bisenet"]["params"],
                          "batch_stats": trees["bisenet"]["batch_stats"]})
        want = jax_calibrate(FlaxBiSeNet(num_classes=19).apply, variables,
                             [jnp.asarray(x) for x in batches], 19,
                             portion=0.5)
    np.testing.assert_array_equal(ranks[0], ranks[1])
    np.testing.assert_array_equal(ranks[0], one)
    np.testing.assert_array_equal(ranks[0], want)
    assert (one < 0.999).any()


# --- distillation ----------------------------------------------------------

def _distill_batch():
    rng = np.random.default_rng(13)
    images = rng.normal(size=(4, *SIZE, 3))
    labels = rng.integers(0, 20, size=(4, *SIZE)).astype(np.int64)
    calib = [rng.normal(size=(4, *SIZE, 3)).astype(np.float32)
             for _ in range(2)]
    return images, labels, calib


@pytest.fixture(scope="module")
def distill_runs(trees):
    import jax.numpy as jnp

    from rtsds_tpu.train import distill as jax_distill

    images, labels, calib = _distill_batch()
    student, teacher = _sd(trees["bisenet"]), _sd(trees["deeplab"])
    j_apply, jtree = jax_distill.quantize_teacher(
        "deeplab", _jax_f32(trees["deeplab"]),
        [jnp.asarray(np.concatenate(calib))])
    jax_scales = {n: float(e[2]) for n, e in jtree["q8"].items()}
    args = (student, teacher, (images, labels), calib, jax_scales)
    ranks = run_ranks(distill_worker, WORLD, args, timeout_s=TIMEOUT_S)
    one = distill_worker(0, 1, *args)
    return ranks, one, (j_apply, jtree)


def _jax_f32(variables):
    import jax

    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  variables)


def test_distill_step_on_two_ranks_equals_one_process(distill_runs):
    ranks, one, _ = distill_runs
    for kind in ("float", "int8"):
        _ranks_equal([r[kind][1] for r in ranks])
        assert ranks[0][kind][0] == ranks[1][kind][0]
        for i, what in enumerate(("metrics", "student")):
            _close(ranks[0][kind][i], one[kind][i], f"{kind} {what}",
                   **SAME)


def test_distill_step_on_two_ranks_matches_jax(distill_runs, trees):
    import jax
    import jax.numpy as jnp

    from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
    from rtsds_tpu.models.deeplabv2 import DeepLabV2 as FlaxDeepLab
    from rtsds_tpu.train.distill import make_distill_step

    images, labels, _ = _distill_batch()
    jax_mesh, mesh = _jax_mesh()
    with jax.enable_x64(True):
        s_vars = jax.tree_util.tree_map(jnp.asarray, trees["bisenet"])
        state = _jax_state(s_vars, FlaxBiSeNet(num_classes=19).apply, 0.01,
                           mesh, jax_mesh)
        step = make_distill_step(FlaxDeepLab(num_classes=19,
                                             layers=THIN).apply,
                                 ignore_index=19, temperature=T, alpha=ALPHA,
                                 donate=False)
        new, metrics = step(
            state, jax.tree_util.tree_map(jnp.asarray, trees["deeplab"]),
            *jax_mesh.shard_batch((jnp.asarray(images),
                                   jnp.asarray(labels, jnp.int32)), mesh))
        metrics = {k: float(v) for k, v in metrics.items()}
        want = _jax_sd({"params": new.params,
                        "batch_stats": new.batch_stats})
    got_metrics, got = distill_runs[0][0]["float"]
    for k in ("train_loss", "loss_ce", "loss_distill"):
        np.testing.assert_allclose(got_metrics[k], metrics[k],
                                   rtol=LOSS_RTOL, err_msg=k)
    assert got_metrics["correct"] == metrics["correct"]
    assert got_metrics["total"] == metrics["total"] == 4 * SIZE[0] * SIZE[1]
    _close(_without_counters(got), want, "student", **JAX)


@pytest.mark.parametrize("stat", ["max", "percentile"])
def test_int8_teacher_scales_on_two_ranks_equal_one_process(distill_runs,
                                                            stat):
    ranks, one, (_, jtree) = distill_runs
    assert ranks[0]["scales"][stat] == ranks[1]["scales"][stat]
    assert ranks[0]["scales"][stat] == one["scales"][stat]
    if stat == "max":
        for name, entry in jtree["q8"].items():
            assert ranks[0]["scales"]["max"][name] == pytest.approx(
                float(entry[2]), rel=SCALE_RTOL)


def test_int8_teacher_soft_targets_on_two_ranks_match_jax(distill_runs):
    import jax.numpy as jnp

    ranks, _, (j_apply, jtree) = distill_runs
    images, _, _ = _distill_batch()
    want = np.asarray(j_apply(jtree, jnp.asarray(images, jnp.float32))
                      .astype(jnp.float32))
    got = np.concatenate([r["soft"] for r in ranks]).transpose(0, 2, 3, 1)

    def soft(z):
        z = z / T
        e = np.exp(z - z.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    gap = np.abs(soft(got) - soft(want))
    assert gap.mean() < 2e-3 and gap.max() < 0.05, (gap.mean(), gap.max())


# --- QAT -------------------------------------------------------------------

@pytest.fixture(scope="module")
def qat_runs(trees):
    import jax.numpy as jnp

    from rtsds_tpu.train import qat as jax_qat

    rng = np.random.default_rng(21)
    calib = [rng.normal(size=(4, *SIZE, 3)).astype(np.float32)
             for _ in range(2)]
    images = rng.normal(size=(4, *SIZE, 3)).astype(np.float32)
    labels = rng.integers(0, 19, (4, *SIZE)).astype(np.int64)
    labels[:2, :2] = 19
    variables = _jax_f32(trees["deeplab"])
    jprep = jax_qat.prepare_qat("deeplab", variables,
                                [jnp.asarray(np.concatenate(calib))])
    jax_scales = {k: float(v) for k, v in jprep.act_scales.items()}
    state = {k: np.asarray(v, np.float32) for k, v in
             _sd(variables).items()}
    args = (state, (images, labels), calib, jax_scales)
    ranks = run_ranks(qat_worker, WORLD, args, timeout_s=TIMEOUT_S)
    one = qat_worker(0, 1, *args)
    return ranks, one, (jprep, images, labels)


def test_qat_scales_and_step_on_two_ranks_equal_one_process(qat_runs):
    ranks, one, (jprep, _, _) = qat_runs
    assert ranks[0]["scales"] == ranks[1]["scales"] == one["scales"]
    for name, s in jprep.act_scales.items():
        assert one["scales"][name] == pytest.approx(float(s),
                                                    rel=SCALE_RTOL)
    key = str(torch.float64)
    _ranks_equal([r[key][1] for r in ranks])
    for i, what in enumerate(("metrics", "params")):
        _close(ranks[0][key][i], one[key][i], f"qat {what}", **SAME)


def test_qat_step_on_two_ranks_matches_jax(qat_runs):
    import jax
    import jax.numpy as jnp

    from rtsds_tpu.train import qat as jax_qat
    from rtsds_tpu.train.optim import make_optimizer as jax_make_optimizer
    from rtsds_tpu.train.supervised import make_train_step

    ranks, _, (jprep, images, labels) = qat_runs
    jax_mesh, mesh = _jax_mesh()
    jstate = jax_mesh.shard_state(jax_qat.create_qat_state(
        jprep, jax_make_optimizer("SGD", 0.1)), mesh)
    before = jax.tree_util.tree_map(np.asarray, jstate.params)
    jstate, jmetrics = make_train_step(ignore_index=19, donate=False)(
        jstate, *jax_mesh.shard_batch((jnp.asarray(images),
                                       jnp.asarray(labels, jnp.int32)),
                                      mesh))
    got_metrics, got = ranks[0][str(torch.float32)]
    assert got_metrics["train_loss"] == pytest.approx(
        float(jmetrics["train_loss"]), rel=1e-5)
    worst = 0.0
    for name, (jk, jb) in jstate.params.items():
        for kind, jv, jv0 in (("kernels", jk, before[name][0]),
                              ("biases", jb, before[name][1])):
            if jv is None:
                continue
            ref, ref0 = np.asarray(jv), np.asarray(jv0)
            mine = got[f"{kind}.{name}"]
            if mine.ndim == 4:
                mine = mine.transpose(2, 3, 1, 0)
            upd = np.abs(ref - ref0).max()
            worst = max(worst, np.abs(mine - ref).max()
                        / (UPDATE_RTOL * upd + 1e-6))
    assert worst <= 1.0, worst


# --- the CLI ---------------------------------------------------------------

def _cli(tmp_path, extra, argv):
    config = _config_with(tmp_path, extra)
    return run_ranks(cli_worker, 2, (["--config", config, "--synthetic",
                                      *argv],), backend=None,
                     timeout_s=TIMEOUT_S)


def test_cli_self_training_on_two_ranks(tmp_path):
    """CBST calibration on each rank's shards of the same target batches,
    ClassMix, FDA and MinEnt: both ranks report the same history and the
    thresholds print once."""
    (h0, w0), (h1, w1) = _cli(tmp_path, {"training": {"domain_adaptation": {
        "ema": {"enabled": True}, "entropy_min": {"enabled": True},
        "fda": {"enabled": True, "beta": 0.05},
        "self_training": {"enabled": True, "classmix": {"enabled": True},
                          "calibration": {"enabled": True, "batches": 2}}}}},
        ["--domain_adaptation"])
    _same(h0, h1)
    assert [e["epoch"] for e in h0] == [0]
    for k in ("loss_pseudo", "pl_coverage", "mix_coverage", "loss_entropy"):
        assert np.isfinite(h0[0][k]), k
    assert (sorted(set(w0)), w1) == ([0], [])


def test_cli_distillation_on_two_ranks(tmp_path):
    """A teacher checkpoint, then distillation from its int8 form on 2
    ranks: the same history on both."""
    from rtsds_tpu_torch.callbacks.checkpoint import CheckpointManager
    from rtsds_tpu_torch.config import load_config
    from rtsds_tpu_torch.train.factory import make_segmentor

    teacher_dir = tmp_path / "teacher"
    model, _ = make_segmentor(load_config(), "bisenet", seed=7)
    CheckpointManager(str(teacher_dir)).save(0, {"model": TrainState(
        model, make_optimizer("SGD", model.parameters(), 0.01))},
        monitor=0.5)
    (h0, _), (h1, _) = _cli(tmp_path, {"training": {"segmentation": {
        "distillation": {"enabled": True, "teacher": {
            "model": "bisenet", "checkpoint_dir": str(teacher_dir),
            "quantize": "int8", "calib_batches": 2}}}}},
        ["--dataset", "gta5"])
    _same(h0, h1)
    assert [e["epoch"] for e in h0] == [0]
    assert np.isfinite(h0[0]["train_loss"])
