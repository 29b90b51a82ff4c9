"""The domain-adaptation extras on the model axis (FSDP, ROADMAP 17.5a) on
gloo CPU ranks, ``{model: 2}`` (2 ranks) and ``{data: 2, model: 2}`` (4
ranks, rank r at data index r // 2), the generator and the discriminator
both placed by ``parallel/mesh.py:place_state`` (sharded over ``model``,
as JAX's ``place_state`` shards both), float64, BiSeNet-R18 and the Tiny
discriminator on global batches of 4 (source 32x64, target 32x48),
against one process at rtol 1e-9 / atol 1e-12 and against the JAX
package's step on a 2-device data mesh (test_torch_multirank_extras.py's
``_jax_da``; JAX's FDA cast widened to float64 as there):

* the gradient-reversal step (one joint backward, then one
  reduce-scatter per network): losses rtol 1e-8, tensors 1e-6 / 1e-10;
* DA v2 with MinEnt and FDA: test_torch_parallel.py's v2 limits (losses
  rtol 1e-6, tensors rtol 1e-4 / atol 1e-6: v2's adversarial weight is
  near its floor);
* self-training with ClassMix (JAX's scores), MinEnt, FDA and per-class
  thresholds: the teacher is the EMA, whose chunks are gathered into the
  generator for its forward and dropped after; the EMA after the step
  whole, both networks, the losses (the coverages, float32 shares, at
  two float32 roundings) against one process, and against JAX's step at
  test_torch_multirank_extras.py's limits;
* CBST calibration on the sharded generator (each data rank on its
  shards of the same global batches): exactly one process's thresholds.
"""

import numpy as np
import pytest
import torch

from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.discriminator import TinyDomainDiscriminator
from rtsds_tpu_torch.parallel.launch import run_ranks
from test_torch_composed import (
    SAME, _f64, _few_threads, axes, bisenet_tree, close, load, numpy_sd,
    numpy_state)  # noqa: F401 -- fixtures
from test_torch_composed_da import dis_tree  # noqa: F401 -- a fixture
from test_torch_fsdp_extras import (
    MESHES, TIMEOUT_S, _metrics, _rows, _sgd, _spec)

COVERAGE_RTOL = 2.0 ** -22  # two float32 roundings
V2_LIMITS = (1e-6, 1e-4, 1e-6)   # loss rtol, rtol, atol (test_torch_parallel)
DA_CASES = {"grl": dict(variant="v1", grl_alpha=0.5),
            "v2_minent_fda": dict(variant="v2", lambda_ent=0.05,
                                  fda_beta=0.05)}


# --- rank workers ---------------------------------------------------------

def da_extras_worker(rank, world, model_size, gen_sd, dis_sd, da, st, cbst):
    """Each DA case, the self-training step and CBST's thresholds on the
    (data, model) grid of ``world / model_size`` x ``model_size`` ranks
    (one process at ``world`` 1)."""
    from rtsds_tpu_torch.parallel import distributed
    from rtsds_tpu_torch.parallel.fsdp import sharded_of
    from rtsds_tpu_torch.train.adversarial import make_adversarial_step
    from rtsds_tpu_torch.train.ema import EMA, ema_init
    from rtsds_tpu_torch.train.self_training import (
        calibrate_class_thresholds, make_self_training_step)

    spec = _spec(world, model_size)
    out = {}
    with distributed.data_parallel(*axes(spec)):
        def states():
            gen = _sgd(load(BiSeNet().double(), gen_sd), spec, momentum=0.0)
            dis_model = load(TinyDomainDiscriminator().double(), dis_sd)
            dis = placed_dis(dis_model, spec)
            return gen, dis

        def placed_dis(model, spec):
            from rtsds_tpu_torch.train.optim import make_optimizer
            from rtsds_tpu_torch.train.state import TrainState
            from test_torch_composed import placed

            return placed(TrainState(model, make_optimizer(
                "SGD", model.parameters(), 0.02, momentum=0.0)), spec)

        for name, (kwargs, batch) in da.items():
            gen, dis = states()
            src, labels, tgt = (_rows(a) for a in batch)
            metrics = make_adversarial_step(0.1, 5, 1, 19, **kwargs)(
                gen, dis, src, labels, tgt)
            out[name] = (_metrics(metrics),
                         numpy_state(gen.state_dict()["model"]),
                         numpy_state(dis.state_dict()["model"]))

        kwargs, batch, scores = st
        gen, dis = states()
        ema = ema_init(gen.model)
        src, labels, tgt = (_rows(a) for a in batch)
        metrics = make_self_training_step(**kwargs)(
            gen, dis, ema, src, labels, tgt, scores=torch.from_numpy(scores))
        out["st"] = (_metrics(metrics),
                     numpy_state(gen.state_dict()["model"]),
                     numpy_state(dis.state_dict()["model"]),
                     numpy_state(EMA(ema, sharded_of(gen.model))
                                 .state_dict()["params"]))

        gen, _ = states()
        out["cbst"] = calibrate_class_thresholds(
            gen.model, [_rows(b) for b in cbst], 19, portion=0.5)
    return out


# --- fixtures -------------------------------------------------------------

@pytest.fixture(scope="module")
def trees(bisenet_tree, dis_tree):
    return {"bisenet": bisenet_tree, "discriminator": dis_tree}


@pytest.fixture(scope="module")
def jax_runs(trees):
    """JAX's step of each DA case and of self-training on a 2-device data
    mesh; ClassMix's scores as JAX drew them."""
    import test_torch_multirank_extras as mx

    da_batch = mx._st_batch(4, 4, seed=9)
    runs = {name: mx._jax_da(trees, da_batch, "v1", **kw)
            for name, kw in DA_CASES.items()}
    st_batch = mx._st_batch(4, 4)
    kwargs = mx._st_kwargs(True, 0.05, 0.05)
    jax_kwargs = {k: v for k, v in kwargs.items()
                  if k not in ("lambda_", "iterations", "ignore_index",
                               "classmix_seed")}
    runs["st"] = mx._jax_da(trees, st_batch, "st", **jax_kwargs)
    return runs, da_batch, (kwargs, st_batch)


@pytest.fixture(scope="module")
def runs(trees, jax_runs):
    jax_out, da_batch, (kwargs, st_batch) = jax_runs
    rng = np.random.default_rng(17)
    cbst = [rng.normal(size=(4, 32, 48, 3)) for _ in range(2)]
    args = (numpy_sd(trees["bisenet"]), numpy_sd(trees["discriminator"]),
            {name: (kw, da_batch) for name, kw in DA_CASES.items()},
            (kwargs, st_batch, jax_out["st"][2]), cbst)
    ranks = {name: run_ranks(da_extras_worker, world, (m, *args),
                             timeout_s=TIMEOUT_S)
             for name, (world, m) in MESHES.items()}
    return ranks, da_extras_worker(0, 1, 1, *args)


def _no_counters(sd: dict) -> dict:
    return {k: v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def _equal_across_ranks(ranks, key):
    for r in ranks:
        for part in range(1, len(r[key])):
            for k, v in r[key][part].items():
                np.testing.assert_array_equal(v, ranks[0][key][part][k])


# --- the tests ------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(DA_CASES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_da_extra_on_the_model_axis(runs, jax_runs, mesh, case):
    ranks, one = runs
    _equal_across_ranks(ranks[mesh], case)
    got = ranks[mesh][0][case]
    close(got[0], one[case][0], f"{mesh} {case} metrics", **SAME)
    close(got[1], one[case][1], f"{mesh} {case} G", **SAME)
    close(got[2], one[case][2], f"{mesh} {case} D", **SAME)
    metrics, (want_g, want_d, _), _ = jax_runs[0][case]
    loss_rtol, rtol, atol = V2_LIMITS if case.startswith("v2") \
        else (1e-8, 1e-6, 1e-10)
    assert got[0]["correct"] == metrics["correct"]
    for k in metrics:
        if k not in ("correct", "total"):
            np.testing.assert_allclose(got[0][k], metrics[k],
                                       rtol=loss_rtol, atol=1e-12,
                                       err_msg=f"{case} {k}")
    close(_no_counters(got[1]), want_g, f"{case} G jax", rtol=rtol,
          atol=atol)
    close(got[2], want_d, f"{case} D jax", rtol=rtol, atol=atol)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_self_training_on_the_model_axis(runs, jax_runs, mesh):
    import test_torch_multirank_extras as mx

    ranks, one = runs
    _equal_across_ranks(ranks[mesh], "st")
    got, want = ranks[mesh][0]["st"], one["st"]
    assert 0.0 < got[0]["pl_coverage"] < 1.0
    assert 0.0 < got[0]["mix_coverage"] < 1.0
    coverages = ("pl_coverage", "mix_coverage")
    close({k: got[0][k] for k in coverages},
          {k: want[0][k] for k in coverages}, mesh, rtol=COVERAGE_RTOL)
    close({k: v for k, v in got[0].items() if k not in coverages},
          {k: v for k, v in want[0].items() if k not in coverages},
          f"{mesh} metrics", **SAME)
    for i, what in enumerate(("G", "D", "EMA"), start=1):
        close(got[i], want[i], f"{mesh} {what}", **SAME)
    metrics, after, _ = jax_runs[0]["st"]
    mx._check_against_jax(got, metrics, after, f"{mesh} st")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cbst_thresholds_on_the_model_axis_equal_one_process(runs, mesh):
    ranks, one = runs
    for r in ranks[mesh]:
        np.testing.assert_array_equal(r["cbst"], one["cbst"])
    assert (one["cbst"] < 0.999).any()
