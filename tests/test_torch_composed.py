"""Composed meshes in training (ROADMAP 17.5a): the spatial axis with the
data axis, the model axis, and both, on gloo CPU ranks with
``RTSDS_CPU_DEVICES=2`` (each rank bands its frames over two CPU
"devices"), against one process and against the JAX package.

* One supervised SGD step (momentum 0.9) of BiSeNet-R18, float64, global
  batch 4 at 32x64 (frames 0-1 half void), on ``{data: 2, spatial: 2}``
  (2 ranks, 2 bands each), ``{spatial: 2, model: 2}`` (2 ranks) and
  ``{data: 2, spatial: 2, model: 2}`` (4 ranks), each placed by
  ``parallel/mesh.py:place_state`` on ``make_mesh_from_config``'s mesh:
  the loss, the counts, every parameter and BN statistic and the momentum
  at rtol 1e-9 / atol 1e-12 of one process's step on the whole batch, the
  ranks' parameters bit-identical; and against JAX's step at rtol 1e-6
  / atol 1e-10, on the ``make_mesh_from_config({data: 2})`` mesh over
  two of conftest's 8 virtual CPU devices, its state placed by JAX's
  ``place_state`` and its inputs by ``input_sharding``.
* JAX's own step on ``make_mesh_from_config({data: 2, spatial: 2, model:
  2})`` (8 virtual devices, the form of ``__graft_entry__.py``'s 3-D
  step) reports the same loss as its data-mesh step to 1e-12, but its
  update misses that step's (and one process's, and the port's) by about
  the update itself: XLA's CPU partitioner mis-partitions the backward
  when the spatial axis composes with another (``{spatial: 2}`` alone and
  ``{data: 2, model: 2}`` agree to 1e-5 of the update).  The test records
  the gap (ROADMAP C); the port is held to the data-mesh step.
* The banded BatchNorm over the data group (``GlobalBatchNorm2d`` on
  ``Bands``, 2 ranks x 2 bands): its output, its running statistics and
  its backward (the input's and the affines' gradients under a seeded
  upstream gradient) against ``nn.BatchNorm2d`` on the whole batch at
  1e-9 / 1e-12.
* K1 over bands and the data group: the validation's matrix (each band's
  matrix summed on the first device, then over the data group) equals one
  process's exactly, and so does the mIoU.
* Each rank keeps its shards of every sharded parameter under a model
  axis, and a model group's ranks band the same frames.
* DA v1 and the CLI on composed meshes: test_torch_composed_da.py.

The rank workers live here and import no JAX, so a spawned rank does not
load it.  Every multi-process case runs under
``parallel/launch.py:run_ranks`` with its own timeout.
"""

import numpy as np
import pytest
import torch

from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.parallel.launch import run_ranks
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.state import TrainState

TIMEOUT_S = 120
SIZE = (32, 64)
SAME = dict(rtol=1e-9, atol=1e-12)
JAX = dict(rtol=1e-6, atol=1e-10)
BANDS_ENV = {"RTSDS_CPU_DEVICES": "2"}
MESHES = {
    "data2_spatial2": ({"data": 2, "spatial": 2}, 2),
    "spatial2_model2": ({"spatial": 2, "model": 2}, 2),
    "data2_spatial2_model2": ({"data": 2, "spatial": 2, "model": 2}, 4),
}
JAX_MESH = {"data": 2, "spatial": 2, "model": 2}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# --- rank workers ---------------------------------------------------------

def load(model, state: dict):
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def numpy_state(state: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in state.items()}


def moments(state: dict) -> dict:
    """A train state dict's optimizer moments by parameter index."""
    return {f"{i}.{k}": v.detach().numpy().copy()
            for i, m in state["optimizer"]["optimizer"]["state"].items()
            for k, v in m.items() if isinstance(v, torch.Tensor)
            and v.dim() > 0}


def axes(spec: dict):
    """The job's (data, model) groups for ``spec``, or the whole job as
    the data group; (None, None) at one process."""
    import torch.distributed as dist

    from rtsds_tpu_torch.parallel.distributed import axis_groups

    if not dist.is_initialized():
        return None, None
    m = int(spec.get("model", 1))
    return axis_groups(m) if m > 1 else (None, None)


def placed(state, spec: dict):
    """``state`` placed on the job mesh of ``spec`` (at one process, as it
    is)."""
    from rtsds_tpu_torch.parallel.mesh import (
        make_mesh_from_config, place_state)

    if not spec:
        return state
    return place_state(state, make_mesh_from_config(spec, device_type="cpu"))


def rank_shard(batch, spec: dict):
    """This rank's shard of a global batch (every array's dim 0) and, on
    a spatial axis, its frames banded over this process's devices; the
    arrays as tensors."""
    from rtsds_tpu_torch.parallel import distributed
    from rtsds_tpu_torch.parallel.mesh import band_devices

    me, n = distributed.rank(), distributed.world_size()
    out = [torch.from_numpy(a[me * len(a) // n:(me + 1) * len(a) // n])
           for a in batch]
    s = int(spec.get("spatial", 1))
    return out, (band_devices("cpu", s) if s > 1 else None)


def banded(images, labels, devices):
    from rtsds_tpu_torch.parallel.spatial import split_batch

    return (images, labels) if devices is None else split_batch(
        images, labels, devices)


def bn_probe(devices) -> dict:
    """A global-batch BN on this rank's banded shard of a seeded (4, 8, 6,
    5) batch under a seeded upstream gradient (or on the whole batch at
    one process): its output (gathered), running statistics and
    gradients."""
    from rtsds_tpu_torch.parallel import distributed
    from rtsds_tpu_torch.parallel.distributed import GlobalBatchNorm2d
    from rtsds_tpu_torch.parallel.spatial import (
        _Layout, bands_of, gather, split_rows)

    rng = np.random.default_rng(3)
    x_all = rng.normal(size=(4, 8, 6, 5)) * 3 + 1
    g_all = rng.normal(size=(4, 8, 6, 5))
    me, n = distributed.rank(), distributed.world_size()
    part = slice(me * 4 // n, (me + 1) * 4 // n)
    bn = GlobalBatchNorm2d(8).double()
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 8))
        bn.bias.copy_(torch.linspace(-1, 1, 8))
    x = torch.from_numpy(x_all[part]).requires_grad_(True)
    g = torch.from_numpy(g_all[part])
    if devices is None:
        y = bn(x)
        y.backward(g)
    else:
        xb = bands_of(split_rows(x, devices), _Layout(devices))
        y_b = bn(xb)
        torch.autograd.backward(y_b.parts, split_rows(g, devices))
        y = gather(y_b)
    return {"y": y.detach().numpy(), "x_grad": x.grad.numpy(),
            "w_grad": bn.weight.grad.numpy(), "b_grad": bn.bias.grad.numpy(),
            "running_mean": bn.running_mean.numpy(),
            "running_var": bn.running_var.numpy()}


def supervised_worker(rank, world, spec, state, images, labels):
    """One SGD step of BiSeNet-R18 on ``spec``'s composed mesh (``{}``:
    one process on the whole batch): the metrics, the state whole, what
    each rank stores; then a validation (the K1 matrix it sums) and, with
    a data axis, the banded BN probe."""
    from rtsds_tpu_torch.eval import validate as val_mod
    from rtsds_tpu_torch.parallel import distributed
    from rtsds_tpu_torch.parallel.fsdp import placement_bytes
    from rtsds_tpu_torch.train.supervised import make_train_step

    out = {}
    with distributed.data_parallel(*axes(spec)):
        (x, y), devices = rank_shard((images, labels), spec)
        model = load(BiSeNet().double(), state)
        st = placed(TrainState(model, make_optimizer(
            "SGD", model.parameters(), 0.01, momentum=0.9)), spec)
        metrics = make_train_step(19)(st, *banded(x, y, devices))
        out["metrics"] = {k: float(v) for k, v in metrics.items()
                          if k != "preempted"}
        saved = st.state_dict()
        out["model"] = numpy_state(saved["model"])
        out["moments"] = moments(saved)
        sharded = st.optimizer.sharded
        m = int(spec.get("model", 1))
        if sharded is not None:
            out["stored"] = all(e.param.numel() == 0 for e in sharded.entries)
            out["resident"] = sharded.resident_bytes(st.optimizer)
            out["reckoned"] = placement_bytes(BiSeNet().double(), m, 1)
        out["frames"] = float(x.sum())
        # the validation's K1 matrix, summed over the bands and the data
        # group
        hist = []
        plain = val_mod.global_sum

        def spy(h):
            h = plain(h)
            hist.append(h.numpy().copy())
            return h
        val_mod.global_sum = spy
        try:
            out["miou"] = val_mod.validate(
                model, [banded(x, y, devices)], 19,
                eval_step=val_mod.make_eval_step(model, 19),
                device="cpu")[0]
        finally:
            val_mod.global_sum = plain
        out["hist"] = hist[0]
        if int(spec.get("data", 1)) > 1 or not spec:
            out["bn"] = bn_probe(devices)
    return out


# --- fixtures -------------------------------------------------------------

def _f64(tree):
    import jax

    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def numpy_sd(variables) -> dict:
    from rtsds_tpu_torch.models.pretrained import state_dict_from_flax

    return {k: v.numpy() for k, v in state_dict_from_flax(variables).items()}


def void_batch():
    """Global batch 4 at 32x64: frames 0-1 (data shard 0) half void."""
    rng = np.random.default_rng(11)
    images = rng.normal(size=(4, *SIZE, 3))
    labels = rng.integers(0, 19, size=(4, *SIZE)).astype(np.int64)
    labels[:2, :, : SIZE[1] // 2] = 19
    return images, labels


@pytest.fixture(scope="module")
def bisenet_tree():
    import jax
    import jax.numpy as jnp

    from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet

    gen = jax.jit(lambda key, x: FlaxBiSeNet(num_classes=19).init(
        key, x, train=True))(jax.random.key(0), jnp.zeros((2, *SIZE, 3)))
    return _f64(dict(gen))


@pytest.fixture(scope="module")
def runs(bisenet_tree):
    args = (numpy_sd(bisenet_tree), *void_batch())
    out = {name: run_ranks(supervised_worker, world, (spec, *args),
                           timeout_s=TIMEOUT_S, env=BANDS_ENV)
           for name, (spec, world) in MESHES.items()}
    return out, supervised_worker(0, 1, {}, *args)


def jax_train_step(tree, spec: dict, n_devices: int):
    """JAX's float64 supervised step (SGD, momentum 0.9) on its
    ``make_mesh_from_config(spec)`` mesh over ``n_devices`` virtual
    devices, the state placed by its ``place_state`` and the batch by
    ``input_sharding``: the metrics and the state after, as a state
    dict."""
    import jax
    import jax.numpy as jnp
    import optax

    from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
    from rtsds_tpu.parallel import mesh as jax_mesh
    from rtsds_tpu.train.state import TrainState as JaxTrainState
    from rtsds_tpu.train.supervised import make_train_step

    images, labels = void_batch()
    mesh = jax_mesh.make_mesh_from_config(
        spec, devices=jax.devices()[:n_devices])
    with jax.enable_x64(True):
        v = jax.tree_util.tree_map(jnp.asarray, tree)
        tx = optax.sgd(0.01, momentum=0.9)
        state = jax_mesh.place_state(JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=v["params"],
            batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
            apply_fn=FlaxBiSeNet(num_classes=19).apply, tx=tx), mesh)
        put = jax_mesh.input_sharding(mesh)
        new, metrics = make_train_step(ignore_index=19, donate=False)(
            state, jax.device_put(jnp.asarray(images), put),
            jax.device_put(jnp.asarray(labels, jnp.int32), put))
        metrics = {k: float(v) for k, v in metrics.items()}
        after = numpy_sd(_f64({"params": new.params,
                               "batch_stats": new.batch_stats}))
    return metrics, after


@pytest.fixture(scope="module")
def jax_step(bisenet_tree):
    return jax_train_step(bisenet_tree, {"data": 2}, 2)


def close(got: dict, want: dict, what: str, **tol):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   err_msg=f"{what} {k}", **tol)


# --- the tests ------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_composed_step_equals_one_process(runs, mesh):
    ranks, one = runs
    for r in ranks[mesh]:
        assert r["metrics"]["correct"] == one["metrics"]["correct"]
        assert r["metrics"]["total"] == one["metrics"]["total"] \
            == 4 * SIZE[0] * SIZE[1]
        np.testing.assert_allclose(r["metrics"]["train_loss"],
                                   one["metrics"]["train_loss"], rtol=1e-9)
        close(r["model"], one["model"], mesh, **SAME)
        close(r["moments"], one["moments"], f"{mesh} momentum", **SAME)
        for k in r["model"]:  # every rank ends with the same tensors
            np.testing.assert_array_equal(r["model"][k],
                                          ranks[mesh][0]["model"][k])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_composed_step_matches_jax_data_mesh(runs, jax_step, mesh):
    want_metrics, want = jax_step
    got = runs[0][mesh][0]
    assert got["metrics"]["correct"] == want_metrics["correct"]
    np.testing.assert_allclose(got["metrics"]["train_loss"],
                               want_metrics["train_loss"], rtol=1e-6)
    model = {k: v for k, v in got["model"].items()
             if not k.endswith("num_batches_tracked")}
    close(model, want, mesh, **JAX)


def test_jax_3d_mesh_step_misses_its_data_mesh_step(runs, jax_step,
                                                    bisenet_tree,
                                                    record_property):
    """JAX's step on the 3-D mesh against its step on the data mesh: the
    loss equal, the update off by a share of itself (recorded), which the
    port's 3-D step is not (within 1e-6 of it, above)."""
    metrics3, after3 = jax_train_step(bisenet_tree, JAX_MESH, 8)
    want_metrics, want = jax_step
    before = numpy_sd(bisenet_tree)
    np.testing.assert_allclose(metrics3["train_loss"],
                               want_metrics["train_loss"], rtol=1e-12)
    gap = max(float(np.abs(after3[k] - v).max()
                    / (np.abs(v - before[k]).max() + 1e-12))
              for k, v in want.items() if "running" not in k)
    record_property("jax_3d_update_gap_over_update", gap)
    assert gap > 1e-3
    port = runs[0]["data2_spatial2_model2"][0]["model"]
    port_gap = max(float(np.abs(port[k] - v).max()
                         / (np.abs(v - before[k]).max() + 1e-12))
                   for k, v in want.items() if "running" not in k)
    assert port_gap < 1e-4 < gap


@pytest.mark.parametrize("mesh", ["spatial2_model2",
                                  "data2_spatial2_model2"])
def test_model_groups_band_the_same_frames_and_keep_their_shards(runs,
                                                                 mesh):
    ranks = runs[0][mesh]
    for r in ranks:
        assert r["stored"], "a rank keeps a whole sharded parameter"
        assert r["resident"] == r["reckoned"]
    # rank r is at data index r // 2: the model group {0, 1} loads one
    # shard of frames, {2, 3} the other
    frames = [r["frames"] for r in ranks]
    assert frames[0] == frames[1]
    if len(frames) == 4:
        assert frames[2] == frames[3] != frames[0]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_k1_over_bands_and_the_data_group_equals_one_process(runs, mesh):
    ranks, one = runs
    for r in ranks[mesh]:
        np.testing.assert_array_equal(r["hist"], one["hist"])
        assert r["miou"] == one["miou"]
    # a quarter of the pixels is void: every labelled pixel counted once
    assert int(one["hist"].sum()) == 3 * SIZE[0] * SIZE[1]


@pytest.mark.parametrize("mesh", ["data2_spatial2",
                                  "data2_spatial2_model2"])
def test_banded_batchnorm_over_the_data_group_equals_the_whole_batch(runs,
                                                                     mesh):
    ranks, one = runs
    data = 2
    want = one["bn"]
    y = np.concatenate([ranks[mesh][r]["bn"]["y"]
                        for r in range(0, len(ranks[mesh]),
                                       len(ranks[mesh]) // data)])
    np.testing.assert_allclose(y, want["y"], **SAME)
    x_grad = np.concatenate([ranks[mesh][r]["bn"]["x_grad"]
                             for r in range(0, len(ranks[mesh]),
                                            len(ranks[mesh]) // data)])
    np.testing.assert_allclose(x_grad, want["x_grad"], **SAME)
    for r in ranks[mesh]:
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(r["bn"][k], want[k], **SAME)
        # the affines' gradients are the rank's shares of the whole batch's
    shares = [ranks[mesh][r]["bn"] for r in range(0, len(ranks[mesh]),
                                                  len(ranks[mesh]) // data)]
    for k in ("w_grad", "b_grad"):
        np.testing.assert_allclose(sum(s[k] for s in shares), want[k],
                                   **SAME)
