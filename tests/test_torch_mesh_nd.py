"""The port's N-D meshes (``rtsds_tpu_torch/parallel/mesh.py``), the FSDP
placement rule (``parallel/fsdp.py:shard_dim``), against the JAX
package, and the CLI on the training extras on the spatial axis, which it
once refused.

* The composed mesh rules of ``make_mesh_from_config`` and
  ``make_mesh_2d`` (``tests/test_parallel_2d.py:48,79``), case by case on
  lists of as many devices as conftest's 8 virtual CPU devices: the axis
  names and sizes, the device grid (each port device standing for the
  JAX device of the same index, so that the grid is the (data, model)
  grid of ranks the docstring maps), the "devices", "at least" and
  "divide" errors and the idle warning, with JAX's messages;
  ``input_sharding``'s specs for ``{data: -1}``, ``{data: -1, spatial: 2,
  model: 2}`` and ``{data: 4, spatial: 2}``.
* The placement rule exactly as JAX's ``fsdp_shard_state`` places every
  parameter of BiSeNet-R18 and DeepLabV2-R101 (their Flax trees' shapes,
  mapped through the weight bridge's names and its HWIO -> OIHW layout
  map) over model axes of 2 and 4, and JAX's test's three arrays.
* ``parallel/distributed.py:axis_groups``' grid, rank r at data index
  r // M and model index r % M, on 4 gloo CPU ranks.
* The CLI: every training extra and validation protocol on the spatial
  axis, alone or composed with the model or data axis, once refused as
  ROADMAP item 17.5b, passes the CLI's checks and builds its mesh; on
  ``{spatial: 2}`` in one process each trains an iteration and validates
  on 2 CPU bands (the composed runs: test_torch_spatial_extras_composed.py);
  a model axis without ``--multihost`` exits asking for one process per
  GPU.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
from rtsds_tpu.models.deeplabv2 import DeepLabV2 as FlaxDeepLab
from rtsds_tpu.parallel import mesh as jax_mesh
from rtsds_tpu_torch import cli
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2
from rtsds_tpu_torch.models.pretrained import torch_scope
from rtsds_tpu_torch.parallel import mesh as port_mesh
from rtsds_tpu_torch.parallel import spatial
from rtsds_tpu_torch.parallel.fsdp import shard_dim
from rtsds_tpu_torch.parallel.launch import run_ranks
from test_torch_cli import _config

# the port's stand-ins for JAX's devices 0-7
DEVICES = [torch.device("cuda", i) for i in range(8)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The CLI runs' tiny shapes gain nothing from many threads, and the
    test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _outcome(build, ids):
    """(axis names, axis sizes, the grid's device indices) or the error,
    and the warnings."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        try:
            mesh = build()
        except ValueError as e:
            return ("error", str(e)), [str(w.message) for w in seen]
    grid = np.vectorize(ids, otypes=[int])(
        mesh.devices if hasattr(mesh.devices, "shape") else mesh.grid)
    return ((tuple(mesh.axis_names), dict(mesh.shape), grid.tolist()),
            [str(w.message) for w in seen])


CASES = {
    "data_fill": ({"data": -1}, 8),
    "data_spatial_model": ({"data": -1, "spatial": 2, "model": 2}, None),
    "data4_spatial2": ({"data": 4, "spatial": 2}, None),
    "model2_fill": ({"model": 2}, 8),
    "data2_model2_idle": ({"data": 2, "model": 2}, None),
    "too_many": ({"data": 8, "model": 2}, None),
    "at_least": ({"data": -1, "spatial": 16}, None),
    "idle": ({"data": 2, "spatial": 2}, None),
    "divide": ({"data": -1, "spatial": 2}, 3),
    "model_divide": ({"data": -1, "model": 4}, 6),
    "pipe_with_model": ({"pipe": 2, "model": 2}, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_composed_mesh_rules_match_jax(case):
    spec, batch = CASES[case]
    want = _outcome(lambda: jax_mesh.make_mesh_from_config(
        spec, devices=jax.devices()[:8], batch_size=batch),
        lambda d: d.id)
    got = _outcome(lambda: port_mesh.make_mesh_from_config(
        spec, devices=DEVICES, batch_size=batch), lambda d: d.index)
    assert got == want


def test_make_mesh_2d_matches_jax():
    for shape, axes in (((4, 2), ("data", "spatial")),
                        ((2, 4), ("data", "model")),
                        ((2, 2, 2), ("data", "spatial", "model")),
                        ((4, 4), ("data", "spatial"))):
        want = _outcome(lambda: jax_mesh.make_mesh_2d(
            shape, axes, devices=jax.devices()[:8]), lambda d: d.id)
        got = _outcome(lambda: port_mesh.make_mesh_2d(
            shape, axes, devices=DEVICES), lambda d: d.index)
        assert got == want, shape


@pytest.mark.parametrize("spec", [{"data": -1},
                                  {"data": -1, "spatial": 2, "model": 2},
                                  {"data": 4, "spatial": 2}])
def test_input_sharding_specs_match_jax(spec):
    want = jax_mesh.input_sharding(jax_mesh.make_mesh_from_config(
        spec, devices=jax.devices()[:8]))
    got = port_mesh.input_sharding(port_mesh.make_mesh_from_config(
        spec, devices=DEVICES))
    assert got.spec == tuple(want.spec)
    dp = port_mesh.dp_spatial_sharding(port_mesh.Mesh(
        DEVICES, ("data", "spatial"), (4, 2)))
    assert dp.spec == tuple(jax_mesh.dp_spatial_sharding(
        jax_mesh.make_mesh_2d((4, 2))).spec)


# --- the placement rule ------------------------------------------------------

def _torch_name(path, leaf: str) -> str:
    """A Flax parameter's torch name, as the weight bridge maps it
    (``models/pretrained.py:state_dict_from_flax``)."""
    name = {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]
    return ".".join([*(torch_scope(p) for p in path), name])


def _jax_dims(params, model_size: int) -> dict:
    """JAX's ``fsdp_shard_state`` of ``params`` (a tree of shapes) over a
    (data, model) mesh: each torch name -> (its torch shape, the torch dim
    JAX shards over ``model``, or None)."""
    mesh = jax_mesh.make_mesh_2d((8 // model_size, model_size),
                                 ("data", "model"), jax.devices()[:8])
    arrays = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), params)
    put = jax.device_put
    try:
        # the rule, without moving the bytes: each leaf becomes its sharding
        jax.device_put = lambda x, sharding: sharding
        placed = jax_mesh.fsdp_shard_state(arrays, mesh, axis="model")
    finally:
        jax.device_put = put
    out = {}
    hwio_to_oihw = {0: 2, 1: 3, 2: 1, 3: 0}
    flat = jax.tree_util.tree_flatten_with_path(placed)[0]
    shapes = dict(jax.tree_util.tree_flatten_with_path(arrays)[0])
    for path, sharding in flat:
        keys = tuple(k.key for k in path)
        shape = shapes[path].shape
        spec = tuple(sharding.spec) + (None,) * (len(shape) - len(
            sharding.spec))
        dims = [d for d, a in enumerate(spec) if a == "model"]
        dim = dims[0] if dims else None
        if len(shape) == 4:
            tshape = (shape[3], shape[2], shape[0], shape[1])
            dim = None if dim is None else hwio_to_oihw[dim]
        else:
            tshape = tuple(shape)
        out[_torch_name(keys[:-1], keys[-1])] = (tshape, dim)
    return out


@pytest.fixture(scope="module")
def flax_params():
    bisenet = jax.eval_shape(
        lambda: FlaxBiSeNet(num_classes=19).init(
            jax.random.key(0), jnp.zeros((2, 64, 128, 3)), train=True))
    deeplab = jax.eval_shape(
        lambda: FlaxDeepLab(num_classes=19).init(
            jax.random.key(0), jnp.zeros((1, 65, 129, 3)), train=True))
    return {"bisenet": (bisenet["params"], BiSeNet()),
            "deeplab": (deeplab["params"], DeepLabV2())}


@pytest.mark.parametrize("model_size", [2, 4])
@pytest.mark.parametrize("model", ["bisenet", "deeplab"])
def test_placement_rule_is_fsdp_shard_state_on_every_parameter(
        flax_params, model, model_size):
    params, module = flax_params[model]
    want = _jax_dims(params, model_size)
    ours = {k: tuple(p.shape) for k, p in module.named_parameters()}
    assert sorted(want) == sorted(ours)
    sharded = 0
    for name, (shape, dim) in want.items():
        assert ours[name] == shape, name
        assert shard_dim(shape, model_size) == dim, name
        sharded += dim is not None
    assert sharded > 10


def test_placement_rule_on_jax_tests_arrays():
    """tests/test_parallel_2d.py:107's three arrays, min_size 1000."""
    mesh = jax_mesh.make_mesh_2d((4, 2), axis_names=("data", "model"))
    tree = {"kernel": jnp.zeros((3, 3, 64, 64)),
            "odd": jnp.zeros((3, 3, 63, 259)), "bias": jnp.zeros((64,))}
    placed = jax_mesh.fsdp_shard_state(tree, mesh, axis="model",
                                       min_size=1000)
    assert tuple(placed["kernel"].sharding.spec) == (None, None, None,
                                                     "model")
    assert shard_dim((64, 64, 3, 3), 2, min_size=1000) == 0
    for name, shape in (("odd", (259, 63, 3, 3)), ("bias", (64,))):
        assert "model" not in tuple(placed[name].sharding.spec)
        assert shard_dim(shape, 2, min_size=1000) is None
    # dim 0 that does not divide: the largest dimension that does
    assert shard_dim((3, 64, 3, 3), 2, min_size=10) == 1


def groups_worker(rank, world, model_size):
    import torch.distributed as dist

    from rtsds_tpu_torch.parallel.distributed import axis_groups

    data, model = axis_groups(model_size)
    return (dist.get_process_group_ranks(data),
            dist.get_process_group_ranks(model))


def test_axis_groups_follow_the_row_major_grid():
    ranks = run_ranks(groups_worker, 4, (2,), timeout_s=60)
    assert ranks == [([0, 2], [0, 1]), ([1, 3], [0, 1]),
                     ([0, 2], [2, 3]), ([1, 3], [2, 3])]
    grid = port_mesh.make_mesh_from_config(
        {"data": 2, "model": 2}, devices=DEVICES[:4]).grid
    assert [[d.index for d in row] for row in grid] == [[0, 1], [2, 3]]


# --- the CLI's refusals ---------------------------------------------------

def _with(tmp_path, mesh: str, seg: str = "", da: str = "",
          extra: str = "") -> str:
    path = _config(tmp_path, f"{mesh}\n{extra}")
    text = (tmp_path / "config.yaml").read_text().replace(
        "segmentation: {epochs: 2, do_validation: 1}",
        f"segmentation: {{epochs: 2, do_validation: 1{seg}}}\n"
        f"  domain_adaptation: {{epochs: 1, iterations: 2, "
        f"do_validation: 1{da}}}")
    (tmp_path / "config.yaml").write_text(text)
    return path


# every extra composed with the spatial axis, once refused as ROADMAP item
# 17.5b: each case now passes the CLI's checks, and a case of one process
# trains an iteration and validates on 2 CPU bands (the multi-process runs:
# test_torch_spatial_extras_composed.py)
SM = "mesh: {model: 2, spatial: 2}"
ONCE_REFUSED = {
    "model_ema": (SM, ", ema: {enabled: true}", "", "",
                  False, "EMA"),
    "model_accumulate": (SM, ", accumulate_steps: 2", "",
                         "", False, "gradient accumulation"),
    "model_distill": (SM, ", distillation: {enabled: true}",
                      "", "", False, "distillation"),
    "model_remat": (SM, "", "",
                    "model: {bisenet: {remat: true}}", False, "remat"),
    "model_da_v2": (SM, "", ", variant: v2", "", True,
                    "DA v2"),
    "model_da_minent": (SM, "",
                        ", entropy_min: {enabled: true}", "", True,
                        "MinEnt"),
    "model_da_fda": (SM, "", ", fda: {enabled: true}", "",
                     True, "FDA"),
    "model_da_self_training": (
        SM, "", ", ema: {enabled: true}, self_training: "
        "{enabled: true}", "", True, "self-training"),
    "model_da_grl": (SM, "", "",
                     "model: {adversarial_model: {discriminator: {grl: "
                     "{enabled: true}}}}", True, "reversal"),
    "spatial_ema": ("mesh: {spatial: 2}", ", ema: {enabled: true}", "", "",
                    False, "EMA"),
    "spatial_sliding": ("mesh: {spatial: 2}", "", "",
                        "validation: {sliding: {enabled: true, window: "
                        "'16, 32'}}", False, "validation protocol"),
    "spatial_da_v2": ("mesh: {spatial: 2}", "", ", variant: v2", "", True,
                      "DA v2"),
    "spatial_data": ("mesh: {data: 2, spatial: 2}", ", accumulate_steps: 2",
                     "", "", False, "gradient accumulation"),
    "spatial_model": (SM, "",
                      ", fda: {enabled: true}", "", True, "FDA"),
}


def passes_the_checks(argv, mesh_size: int) -> None:
    """``argv``'s config passes ``check_ported`` and builds its mesh by
    ``make_mesh_from_config`` over ``mesh_size`` CPU entries, the job's
    (data, spatial, model) grid."""
    from rtsds_tpu_torch.config import load_config

    args = cli.argument_parser(argv)
    config = load_config(args.config)
    cli.check_ported(args, config)
    spec = dict(config.mesh)
    mesh = port_mesh.make_mesh_from_config(
        spec, devices=["cpu"] * mesh_size, device_type="cpu",
        batch_size=int(config.data["cityscapes"]["batch_size"]))
    assert mesh.size == mesh_size
    assert mesh.axis_size("spatial") == spec["spatial"] == 2


def one_iteration(path: str) -> str:
    """The config at ``path`` cut to one epoch of one training step (the
    16 synthetic Cityscapes frames in one batch; DA: one iteration)."""
    from pathlib import Path

    text = Path(path).read_text().replace("epochs: 2,", "epochs: 1,")
    text = text.replace("iterations: 2,", "iterations: 1,").replace(
        'image_size: "32, 64"\n    batch_size: 2',
        'image_size: "32, 64"\n    batch_size: 16')
    Path(path).write_text(text)
    return path


@pytest.mark.parametrize("case", sorted(ONCE_REFUSED))
def test_what_item_17_5_held_now_runs(tmp_path, case, monkeypatch):
    mesh, seg, da, extra, adapt, what = ONCE_REFUSED[case]
    argv = ["--config", one_iteration(_with(tmp_path, mesh, seg, da, extra)),
            "--synthetic"] + (["--domain_adaptation"] if adapt else [])
    if not mesh.startswith("mesh: {spatial: 2}"):
        # a mesh over processes: the composed file runs its ranks
        passes_the_checks(argv + ["--multihost"], 4)
        return
    monkeypatch.setenv("RTSDS_CPU_DEVICES", "2")
    banded = []
    split = spatial.split_batch
    monkeypatch.setattr(spatial, "split_batch",
                        lambda *a: banded.append(1) or split(*a))
    history = cli.main(argv)
    assert len(history) == 1, what
    assert np.isfinite(history[0]["train_loss" if not adapt
                                  else "loss_gen_source"])
    assert 0.0 <= history[0]["validation_mIoU"] <= 1.0
    assert banded  # the training and validation batches came as bands


def test_model_axis_without_multihost_asks_for_a_process_per_gpu(tmp_path):
    with pytest.raises(SystemExit, match="one process per GPU"):
        cli.main(["--config", _with(tmp_path, "mesh: {model: 2}"),
                  "--synthetic"])


# --- a fault found on the way (ROADMAP C) ----------------------------------

def test_clip_by_global_norm_matches_optax_in_float64():
    """The global-norm clip took the norm of float64 gradients in float32
    (``g.float()``), 1e-8 to 1e-7 apart from optax's norm in JAX's x64
    mode, so a clipped float64 step missed JAX's and one process's
    sharded twin; the norm is taken in at least float32 now, and the
    clipped gradients match optax's at rtol 1e-13."""
    import optax

    from rtsds_tpu_torch.train.optim import clip_by_global_norm

    rng = np.random.default_rng(4)
    shapes = [(64, 3, 3, 3), (64,), (19, 64, 1, 1), (1000,)]
    grads = [rng.normal(size=s) * 10 ** rng.uniform(-3, 1) for s in shapes]
    params = [torch.nn.Parameter(torch.zeros(s, dtype=torch.float64))
              for s in shapes]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    with jax.enable_x64(True):
        clip = optax.clip_by_global_norm(1.0)
        want, _ = clip.update([jnp.asarray(g) for g in grads],
                              clip.init(None))
        want = [np.asarray(w) for w in want]
    clip_by_global_norm(params, 1.0)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-13, atol=0)
    # the float32 norm the clip took before
    norm32 = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(torch.from_numpy(g).float())
         for g in grads])))
    norm64 = float(np.sqrt(sum((g ** 2).sum() for g in grads)))
    assert abs(norm32 - norm64) / norm64 > 1e-9
