"""DA v1 on composed meshes (ROADMAP 17.5a): one adversarial step
(BiSeNet-R18 generator, Tiny discriminator, float64, source 32x64 with
half-void frames, target 32x48, global batch 4) on ``{data: 2, spatial:
2}``, ``{spatial: 2, model: 2}`` and ``{data: 2, spatial: 2, model: 2}``
on gloo CPU ranks with two CPU "devices" each, source and target banded
apart, both networks placed by ``parallel/mesh.py:place_state`` (sharded
over ``model`` when the mesh has it):

* against one process's step on the whole batch at rtol 1e-9 / atol
  1e-12 (the losses, the counts, both networks), the ranks' networks
  bit-identical;
* against JAX's step on its ``make_mesh_from_config({data: 2})`` mesh
  over two of conftest's 8 virtual CPU devices, both states placed by
  JAX's ``place_state`` and the batches by ``input_sharding``: at
  test_torch_parallel.py's v1 limits (losses rtol 1e-8, parameters rtol
  1e-6 / atol 1e-10).  JAX's own step on a mesh that composes the
  spatial axis with another reports these losses but misses this update
  (test_torch_composed.py records the gap; ROADMAP C), so the data mesh's
  step is the reference.
"""

import numpy as np
import pytest
import torch

from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.discriminator import TinyDomainDiscriminator
from rtsds_tpu_torch.parallel.launch import run_ranks
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.state import TrainState
from test_torch_composed import (
    BANDS_ENV, MESHES, SAME, SIZE, TIMEOUT_S, _f64, _few_threads,
    axes, banded, bisenet_tree, close, load, numpy_sd, numpy_state,
    placed, rank_shard)  # noqa: F401 -- fixtures

TGT = (32, 48)
DA_V1 = (1e-8, 1e-6, 1e-10)   # loss rtol, rtol, atol (test_torch_parallel)
LAMBDA, ITERATIONS, LR_G, LR_D = 0.1, 5, 0.01, 0.02


def da_batch():
    rng = np.random.default_rng(7)
    src = rng.normal(size=(4, *SIZE, 3))
    tgt = rng.normal(size=(4, *TGT, 3))
    labels = rng.integers(0, 19, size=(4, *SIZE)).astype(np.int64)
    labels[:2, : SIZE[0] // 2] = 19
    return src, labels, tgt


def da_worker(rank, world, spec, gen_state, dis_state, batch):
    """One DA v1 step on ``spec``'s composed mesh (``{}``: one process):
    the metrics and both networks whole."""
    from rtsds_tpu_torch.parallel import distributed
    from rtsds_tpu_torch.train.adversarial import make_adversarial_step

    with distributed.data_parallel(*axes(spec)):
        (src, labels, tgt), devices = rank_shard(batch, spec)
        src, labels = banded(src, labels, devices)
        tgt, _ = banded(tgt, torch.zeros(tgt.shape[:3], dtype=torch.long),
                        devices)
        gen_model = load(BiSeNet().double(), gen_state)
        dis_model = load(TinyDomainDiscriminator().double(), dis_state)
        gen = placed(TrainState(gen_model, make_optimizer(
            "SGD", gen_model.parameters(), LR_G, momentum=0.0)), spec)
        dis = placed(TrainState(dis_model, make_optimizer(
            "SGD", dis_model.parameters(), LR_D, momentum=0.0)), spec)
        metrics = make_adversarial_step(LAMBDA, ITERATIONS, 1, 19, "v1")(
            gen, dis, src, labels, tgt)
        return ({k: float(v) for k, v in metrics.items()
                 if k != "preempted"},
                numpy_state(gen.state_dict()["model"]),
                numpy_state(dis.state_dict()["model"]))


@pytest.fixture(scope="module")
def dis_tree():
    import jax
    import jax.numpy as jnp

    from rtsds_tpu.models.discriminator import (
        TinyDomainDiscriminator as FlaxTiny)

    return _f64(dict(FlaxTiny(num_classes=19).init(
        jax.random.key(1), jnp.zeros((2, *TGT, 19)))))


@pytest.fixture(scope="module")
def runs(bisenet_tree, dis_tree):
    args = (numpy_sd(bisenet_tree), numpy_sd(dis_tree), da_batch())
    out = {name: run_ranks(da_worker, world, (spec, *args),
                           timeout_s=TIMEOUT_S, env=BANDS_ENV)
           for name, (spec, world) in MESHES.items()}
    return out, da_worker(0, 1, {}, *args)


@pytest.fixture(scope="module")
def jax_da_step(bisenet_tree, dis_tree):
    import jax
    import jax.numpy as jnp
    import optax

    from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
    from rtsds_tpu.models.discriminator import (
        TinyDomainDiscriminator as FlaxTiny)
    from rtsds_tpu.parallel import mesh as jax_mesh
    from rtsds_tpu.train.adversarial import make_adversarial_step
    from rtsds_tpu.train.state import TrainState as JaxTrainState

    mesh = jax_mesh.make_mesh_from_config({"data": 2},
                                          devices=jax.devices()[:2])

    def state(tree, apply_fn, lr):
        v = jax.tree_util.tree_map(jnp.asarray, tree)
        tx = optax.sgd(lr)
        return jax_mesh.place_state(JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=v["params"],
            batch_stats=v.get("batch_stats"),
            opt_state=tx.init(v["params"]), apply_fn=apply_fn, tx=tx), mesh)

    src, labels, tgt = da_batch()
    put = jax_mesh.input_sharding(mesh)
    with jax.enable_x64(True):
        step = make_adversarial_step(LAMBDA, ITERATIONS, epochs=1,
                                     ignore_index=19, donate=False,
                                     variant="v1")
        g, d, metrics = step(
            state(bisenet_tree, FlaxBiSeNet(num_classes=19).apply, LR_G),
            state(dis_tree, FlaxTiny(num_classes=19).apply, LR_D),
            jax.device_put(jnp.asarray(src), put),
            jax.device_put(jnp.asarray(labels, jnp.int32), put),
            jax.device_put(jnp.asarray(tgt), put))
        metrics = {k: float(v) for k, v in metrics.items()}
        want_g = numpy_sd(_f64({"params": g.params,
                                "batch_stats": g.batch_stats}))
        want_d = numpy_sd(_f64({"params": d.params}))
    return metrics, want_g, want_d


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_composed_da_v1_step_equals_one_process(runs, mesh):
    ranks, one = runs
    for r in ranks[mesh]:
        close(r[0], one[0], f"{mesh} metrics", **SAME)
        close(r[1], one[1], f"{mesh} G", **SAME)
        close(r[2], one[2], f"{mesh} D", **SAME)
        for part in (1, 2):
            for k, v in r[part].items():
                np.testing.assert_array_equal(v, ranks[mesh][0][part][k])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_composed_da_v1_step_matches_jax_data_mesh(runs, jax_da_step, mesh):
    want_metrics, want_g, want_d = jax_da_step
    got_metrics, got_g, got_d = runs[0][mesh][0]
    loss_rtol, rtol, atol = DA_V1
    assert got_metrics["correct"] == want_metrics["correct"]
    for k in want_metrics:
        if k not in ("correct", "total"):
            np.testing.assert_allclose(got_metrics[k], want_metrics[k],
                                       rtol=loss_rtol, atol=1e-12,
                                       err_msg=k)
    got_g = {k: v for k, v in got_g.items()
             if not k.endswith("num_batches_tracked")}
    close(got_g, want_g, f"{mesh} G", rtol=rtol, atol=atol)
    close(got_d, want_d, f"{mesh} D", rtol=rtol, atol=atol)
