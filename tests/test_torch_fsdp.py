"""The port's model axis (FSDP, ``rtsds_tpu_torch/parallel/fsdp.py``) on
gloo CPU ranks, against one process and against the JAX package.

* One supervised step of BiSeNet-R18 (SGD with momentum 0.9, float64,
  global batch 4 at 32x64, shard 0 half void) on ``{model: 2}`` (2 ranks)
  and ``{data: 2, model: 2}`` (4 ranks, rank r at data index r // 2 and
  model index r % 2), placed by ``parallel/mesh.py:place_state``: against
  one process at rtol 1e-9 / atol 1e-12 (the loss at rtol 1e-9), and
  against JAX's replicated step on a 2-device data mesh at rtol 1e-6 /
  atol 1e-10 (test_torch_parallel.py's limits, tighter than JAX's own
  2e-5 and 1e-4 / 1e-5 for its FSDP step in float32).  A second step with
  the global-norm clip binding (``grad_clip`` 0.5) against one process.
* Each rank keeps only its shard of every sharded parameter (the module's
  own parameter holds no storage between steps) and of its momentum: its
  resident bytes are those the placement rule reckons.
* The data group (the ranks that share a model index) alone carries the
  data axis's collectives: on 4 ranks the loss, the BN statistics, the
  metrics' pixel counts, ``global_count``, ``global_max`` and the
  validation's K1 matrix are one process's; over the whole job each would
  double.
* The checkpoint: a model-axis state's ``state_dict`` is the one-process
  state's (the parameters, the BN buffers and the momentum, whole), and a
  restore into a fresh sharded state cuts it back into the same shards.
* DA v1 and the CLI on the model axis: test_torch_fsdp_da.py.

This module holds the rank workers and imports no JAX at module level: a
spawned child imports it.  Every multi-process case runs under
``parallel/launch.py:run_ranks`` with its own timeout.
"""

import numpy as np
import pytest
import torch

from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.discriminator import TinyDomainDiscriminator
from rtsds_tpu_torch.parallel.launch import run_ranks
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.state import TrainState

TIMEOUT_S = 90
SIZE = (32, 64)
TGT = (32, 48)
SAME = dict(rtol=1e-9, atol=1e-12)
JAX = dict(rtol=1e-6, atol=1e-10)
DA_V1 = (1e-8, 1e-6, 1e-10)   # loss rtol, rtol, atol (test_torch_parallel)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# --- rank workers ---------------------------------------------------------

def _load(model, state: dict):
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def _numpy(state: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in state.items()}


def _moments(state: dict) -> dict:
    """A train state dict's optimizer moments by parameter index."""
    return {f"{i}.{k}": v.detach().numpy().copy()
            for i, m in state["optimizer"]["optimizer"]["state"].items()
            for k, v in m.items() if isinstance(v, torch.Tensor)
            and v.dim() > 0}


def _placed(state, spec: dict):
    """``state`` placed on the job mesh of ``spec`` (at one process, as it
    is)."""
    from rtsds_tpu_torch.parallel.mesh import (
        make_mesh_from_config, place_state)

    return place_state(state, make_mesh_from_config(spec, device_type="cpu"))


def _axes(model_size: int):
    """The (data, model) groups of the job, when it has several ranks."""
    import torch.distributed as dist

    from rtsds_tpu_torch.parallel.distributed import axis_groups

    if not dist.is_initialized():
        return None, None
    return axis_groups(model_size)


def step_worker(rank, world, model_size, state, images, labels, clip_state):
    """On the (data, model) grid of ``world / model_size`` x
    ``model_size`` ranks: one SGD step of BiSeNet-R18 on this rank's data
    shard, its metrics, its state dict (whole) and what it stores; then
    the data-group probes; then a step with the clip binding from
    ``clip_state``."""
    from rtsds_tpu_torch.eval.validate import validate
    from rtsds_tpu_torch.parallel import distributed
    from rtsds_tpu_torch.parallel.fsdp import placement_bytes
    from rtsds_tpu_torch.train.supervised import make_train_step

    spec = {"data": world // model_size, "model": model_size}
    with distributed.data_parallel(*_axes(model_size)):
        me, n = distributed.rank(), distributed.world_size()
        part = slice(me * len(images) // n, (me + 1) * len(images) // n)
        x, y = torch.from_numpy(images[part]), torch.from_numpy(
            labels[part])
        model = _load(BiSeNet().double(), state)
        st = _placed(TrainState(model, make_optimizer(
            "SGD", model.parameters(), 0.01, momentum=0.9)), spec)
        metrics = make_train_step(19)(st, x, y)
        out = {"metrics": {k: float(v) for k, v in metrics.items()
                           if k != "preempted"}}
        saved = st.state_dict()
        out["model"] = _numpy(saved["model"])
        out["moments"] = _moments(saved)
        sharded = st.optimizer.sharded
        if sharded is not None:
            out["stored"] = {e.name: (e.shard.numel(), e.param.numel(),
                                      tuple(e.shape), e.dim)
                             for e in sharded.entries}
            out["resident"] = sharded.resident_bytes(st.optimizer)
            out["reckoned"] = placement_bytes(BiSeNet().double(),
                                              model_size, 1)
            # a restore into a fresh sharded state cuts the same shards
            fresh = _load(BiSeNet().double(), state)
            again = _placed(TrainState(fresh, make_optimizer(
                "SGD", fresh.parameters(), 0.01, momentum=0.9)), spec)
            again.load_state_dict(saved)
            out["restored_shards_equal"] = all(
                torch.equal(a.shard, b.shard) for a, b in zip(
                    sharded.entries, again.optimizer.sharded.entries))
            out["restored_moments_equal"] = all(
                torch.equal(st.optimizer.optimizer.state[a.shard][
                    "momentum_buffer"], again.optimizer.optimizer.state[
                        b.shard]["momentum_buffer"])
                for a, b in zip(sharded.entries,
                                again.optimizer.sharded.entries))
        # the data axis's collectives, on the data group alone
        hist = []

        def spy(h):
            hist.append(h.numpy().copy())
            return h
        import rtsds_tpu_torch.eval.validate as val_mod
        plain, val_mod.global_sum = val_mod.global_sum, \
            lambda h: spy(plain(h))
        try:
            out["miou"] = validate(model, [(x, y)], 19, device="cpu")[0]
        finally:
            val_mod.global_sum = plain
        out["hist"] = hist[0]
        out["global_count"] = int(distributed.global_count(1))
        out["global_max"] = float(distributed.global_max(
            torch.tensor(float(rank))))
        # the clip binds
        model = _load(BiSeNet().double(), clip_state)
        st = _placed(TrainState(model, make_optimizer(
            "SGD", model.parameters(), 0.01, momentum=0.9,
            grad_clip=0.5)), spec)
        out["clip_loss"] = float(make_train_step(19)(st, x, y)[
            "train_loss"])
        out["clip_model"] = _numpy(st.state_dict()["model"])
        if world == 1:  # the same step unclipped, to see the clip bind
            model = _load(BiSeNet().double(), clip_state)
            st = TrainState(model, make_optimizer(
                "SGD", model.parameters(), 0.01, momentum=0.9))
            make_train_step(19)(st, x, y)
            out["noclip_model"] = _numpy(st.state_dict()["model"])
    return out


def da_worker(rank, world, gen_state, dis_state, batch):
    """One DA v1 step on ``{model: world}``: the metrics and both states
    after (whole)."""
    from rtsds_tpu_torch.parallel import distributed
    from rtsds_tpu_torch.train.adversarial import make_adversarial_step

    src, labels, tgt = (torch.from_numpy(a) for a in batch)
    with distributed.data_parallel(*_axes(world)):
        gen_model = _load(BiSeNet().double(), gen_state)
        dis_model = _load(TinyDomainDiscriminator().double(), dis_state)
        gen = _placed(TrainState(gen_model, make_optimizer(
            "SGD", gen_model.parameters(), 0.01, momentum=0.0)),
            {"model": world})
        dis = _placed(TrainState(dis_model, make_optimizer(
            "SGD", dis_model.parameters(), 0.02, momentum=0.0)),
            {"model": world})
        metrics = make_adversarial_step(0.1, 5, 1, 19, "v1")(
            gen, dis, src, labels, tgt)
        return ({k: float(v) for k, v in metrics.items()
                 if k != "preempted"},
                _numpy(gen.state_dict()["model"]),
                _numpy(dis.state_dict()["model"]))


def cli_worker(rank, world, argv):
    from rtsds_tpu_torch import cli

    return cli.main([*argv, "--multihost"] if world > 1 else argv)


# --- fixtures -------------------------------------------------------------

def _f64(tree):
    import jax

    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _numpy_sd(variables) -> dict:
    from rtsds_tpu_torch.models.pretrained import state_dict_from_flax

    return {k: v.numpy() for k, v in state_dict_from_flax(variables).items()}


@pytest.fixture(scope="module")
def trees():
    import jax
    import jax.numpy as jnp

    from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
    from rtsds_tpu.models.discriminator import (
        TinyDomainDiscriminator as FlaxTiny)

    gen = jax.jit(lambda key, x: FlaxBiSeNet(num_classes=19).init(
        key, x, train=True))(jax.random.key(0), jnp.zeros((2, *SIZE, 3)))
    dis = FlaxTiny(num_classes=19).init(jax.random.key(1),
                                        jnp.zeros((2, *TGT, 19)))
    return {"bisenet": _f64(dict(gen)), "discriminator": _f64(dict(dis))}


def _void_batch():
    """test_torch_parallel.py's global batch 4: shard 0 (frames 0-1) half
    void, shard 1 none."""
    rng = np.random.default_rng(11)
    images = rng.normal(size=(4, *SIZE, 3))
    labels = rng.integers(0, 19, size=(4, *SIZE)).astype(np.int64)
    labels[:2, :, : SIZE[1] // 2] = 19
    return images, labels


def _clip_state(trees) -> dict:
    """The BiSeNet state, perturbed so that the clip's step starts
    elsewhere."""
    rng = np.random.default_rng(5)
    return {k: v + (0.01 * rng.normal(size=v.shape) if v.dtype.kind == "f"
                    and "running" not in k else 0)
            for k, v in _numpy_sd(trees["bisenet"]).items()}


@pytest.fixture(scope="module")
def step_runs(trees):
    state = _numpy_sd(trees["bisenet"])
    args = (state, *_void_batch(), _clip_state(trees))
    runs = {"model2": run_ranks(step_worker, 2, (2, *args),
                                timeout_s=TIMEOUT_S),
            "data2_model2": run_ranks(step_worker, 4, (2, *args),
                                      timeout_s=TIMEOUT_S)}
    return runs, step_worker(0, 1, 1, *args)


def _close(got: dict, want: dict, what: str, **tol):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   err_msg=f"{what} {k}", **tol)


# --- the tests ------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["model2", "data2_model2"])
def test_fsdp_step_equals_one_process(step_runs, mesh):
    runs, one = step_runs
    for r in runs[mesh]:
        assert r["metrics"]["correct"] == one["metrics"]["correct"]
        assert r["metrics"]["total"] == one["metrics"]["total"] \
            == 4 * SIZE[0] * SIZE[1]
        np.testing.assert_allclose(r["metrics"]["train_loss"],
                                   one["metrics"]["train_loss"], rtol=1e-9)
        _close(r["model"], one["model"], mesh, **SAME)
        _close(r["moments"], one["moments"], f"{mesh} momentum", **SAME)
        for k in r["model"]:  # the model group's ranks agree exactly
            np.testing.assert_array_equal(r["model"][k],
                                          runs[mesh][0]["model"][k])


@pytest.mark.parametrize("mesh", ["model2", "data2_model2"])
def test_fsdp_step_matches_jax_replicated(step_runs, trees, mesh):
    import test_torch_parallel as tp

    want_metrics, want = tp._jax_step(trees, "bisenet", 1)
    got = step_runs[0][mesh][0]
    assert got["metrics"]["correct"] == want_metrics["correct"]
    np.testing.assert_allclose(got["metrics"]["train_loss"],
                               want_metrics["train_loss"], rtol=1e-6)
    model = {k: v for k, v in got["model"].items()
             if not k.endswith("num_batches_tracked")}
    _close(model, want, mesh, **JAX)


@pytest.mark.parametrize("mesh", ["model2", "data2_model2"])
def test_each_rank_stores_only_its_shards(step_runs, mesh):
    for r in step_runs[0][mesh]:
        assert r["stored"], "no parameter was sharded"
        for name, (shard, whole, shape, dim) in r["stored"].items():
            assert whole == 0, f"{name} keeps its whole tensor"
            assert shard * 2 == int(np.prod(shape)), name
            assert shape[dim] % 2 == 0
        assert r["resident"] == r["reckoned"]
        assert r["restored_shards_equal"] and r["restored_moments_equal"]
    one = step_runs[1]
    full = sum(v.nbytes for k, v in one["model"].items()
               if "running" not in k and "num_batches" not in k) * 2
    assert step_runs[0][mesh][0]["resident"] < 0.6 * full


def test_data_axis_collectives_run_over_the_data_group(step_runs):
    """On {data: 2, model: 2} the data axis is 2 ranks wide: over the job
    (4) every count and matrix below would double."""
    runs, one = step_runs
    ranks = runs["data2_model2"]
    for r in ranks:
        assert r["global_count"] == 2
        # every labelled pixel of the global batch once (a quarter void)
        assert int(r["hist"].sum()) == 3 * SIZE[0] * SIZE[1]
        np.testing.assert_array_equal(r["hist"], one["hist"])
        assert r["miou"] == one["miou"]
    # rank r's data group is {r % 2, 2 + r % 2}: its max is 2 + r % 2
    assert [r["global_max"] for r in ranks] == [2.0, 3.0, 2.0, 3.0]
    assert [r["global_count"] for r in runs["model2"]] == [1, 1]


@pytest.mark.parametrize("mesh", ["model2", "data2_model2"])
def test_fsdp_clip_equals_one_process_when_it_binds(step_runs, mesh):
    runs, one = step_runs
    for r in runs[mesh]:
        np.testing.assert_allclose(r["clip_loss"], one["clip_loss"],
                                   rtol=1e-9)
        _close(r["clip_model"], one["clip_model"], f"{mesh} clip", **SAME)
    # the clip bound: unclipped, the step lands elsewhere
    gap = max(float(np.abs(one["clip_model"][k] - v).max())
              for k, v in one["noclip_model"].items() if v.dtype.kind == "f")
    assert gap > 1e-4
