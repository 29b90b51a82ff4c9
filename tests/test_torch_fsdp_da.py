"""The port's model axis (FSDP) in domain adaptation and through the CLI,
on gloo CPU ranks (the step, the shards and the data group:
test_torch_fsdp.py, whose rank workers this module drives).

* One DA v1 step (BiSeNet-R18 generator, Tiny discriminator, float64,
  source 32x64 and target 32x48, global batch 4) on ``{model: 2}``:
  against one process at rtol 1e-9 / atol 1e-12, and against JAX's step
  on a 2-device data mesh at test_torch_parallel.py's v1 limits (losses
  rtol 1e-8, parameters rtol 1e-6 / atol 1e-10).
* The CLI: ``--multihost`` with ``mesh: {model: 2}`` on 2 gloo ranks trains
  BiSeNet-R18 on colour-coded labels (K2's plain version in the
  transform) and validates (K1's); both ranks report the same history,
  and the checkpoint rank 0 writes equals the one-process run's (its
  parameters, BN buffers and Adam moments, whole) at rtol 1e-9 / atol
  1e-12, and ``Predictor.from_checkpoint`` serves it with the one-process
  checkpoint's masks.  The one-process run runs in a child too, with one
  torch thread as each rank has: Adam turns a rounding difference in a
  near-zero gradient into a whole step.
"""

import numpy as np
import torch

from rtsds_tpu_torch.parallel.launch import run_ranks
from test_torch_fsdp import (
    DA_V1, SAME, SIZE, TGT, TIMEOUT_S, _close, _f64, _moments, _numpy_sd,
    _few_threads, cli_worker, da_worker, trees)  # noqa: F401 -- fixtures


def _da_batch():
    rng = np.random.default_rng(7)
    src = rng.normal(size=(4, *SIZE, 3))
    tgt = rng.normal(size=(4, *TGT, 3))
    labels = rng.integers(0, 19, size=(4, *SIZE)).astype(np.int64)
    labels[:2, : SIZE[0] // 2] = 19
    return src, labels, tgt


def test_fsdp_da_v1_step_equals_one_process_and_jax(trees):
    import jax
    import jax.numpy as jnp
    import optax

    from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
    from rtsds_tpu.models.discriminator import (
        TinyDomainDiscriminator as FlaxTiny)
    from rtsds_tpu.parallel import mesh as jax_mesh
    from rtsds_tpu.train.adversarial import make_adversarial_step
    from rtsds_tpu.train.state import TrainState as JaxTrainState

    gen, dis = (_numpy_sd(trees[k]) for k in ("bisenet", "discriminator"))
    ranks = run_ranks(da_worker, 2, (gen, dis, _da_batch()),
                      timeout_s=TIMEOUT_S)
    one = da_worker(0, 1, gen, dis, _da_batch())
    for r in ranks:
        _close(r[0], one[0], "metrics", **SAME)
        _close(r[1], one[1], "G", **SAME)
        _close(r[2], one[2], "D", **SAME)

    loss_rtol, rtol, atol = DA_V1
    mesh = jax_mesh.make_mesh(jax.devices()[:2])

    def state(variables, apply_fn, lr):
        tx = optax.sgd(lr)
        return jax_mesh.shard_state(JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=variables.get("batch_stats"),
            opt_state=tx.init(variables["params"]), apply_fn=apply_fn,
            tx=tx), mesh)

    src, labels, tgt = _da_batch()
    with jax.enable_x64(True):
        step = make_adversarial_step(0.1, 5, epochs=1, ignore_index=19,
                                     donate=False, variant="v1")
        g, d, metrics = step(
            state(jax.tree_util.tree_map(jnp.asarray, trees["bisenet"]),
                  FlaxBiSeNet(num_classes=19).apply, 0.01),
            state(jax.tree_util.tree_map(jnp.asarray,
                                         trees["discriminator"]),
                  FlaxTiny(num_classes=19).apply, 0.02),
            *jax_mesh.shard_batch((jnp.asarray(src),
                                   jnp.asarray(labels, jnp.int32),
                                   jnp.asarray(tgt)), mesh))
        metrics = {k: float(v) for k, v in metrics.items()}
        want_g = _numpy_sd(_f64({"params": g.params,
                                 "batch_stats": g.batch_stats}))
        want_d = _numpy_sd(_f64({"params": d.params}))
    got_metrics, got_g, got_d = ranks[0]
    assert got_metrics["correct"] == metrics["correct"]
    for k in metrics:
        if k not in ("correct", "total"):
            np.testing.assert_allclose(got_metrics[k], metrics[k],
                                       rtol=loss_rtol, atol=1e-12,
                                       err_msg=k)
    got_g = {k: v for k, v in got_g.items()
             if not k.endswith("num_batches_tracked")}
    _close(got_g, want_g, "G", rtol=rtol, atol=atol)
    _close(got_d, want_d, "D", rtol=rtol, atol=atol)


def _cli_config(tmp_path, name: str, mesh: str) -> str:
    path = tmp_path / f"{name}.yaml"
    path.write_text(f"""
device: cpu
{mesh}
data:
  cityscapes: {{image_size: "32, 64", batch_size: 2, num_workers: 1}}
  gta5_modified: {{image_size: "32, 64", batch_size: 2, num_workers: 1,
                  decode_label_colors: true}}
training:
  segmentation: {{epochs: 1, do_validation: 1}}
callbacks:
  model_checkpoint: {{save_dir: "{tmp_path}/{name}", save_name: "m",
                     save_best: false, save_freq: 1}}
""")
    return str(path)


def test_cli_trains_on_the_model_axis_and_its_checkpoint_serves(tmp_path):
    """K2 in the transform (colour-coded labels) and K1 in the validation
    run on both ranks; the checkpoint is the one-process run's."""
    from rtsds_tpu_torch.serve import Predictor

    argv = ["--synthetic", "--dataset", "gta5"]
    sharded = run_ranks(cli_worker, 2, (["--config", _cli_config(
        tmp_path, "fsdp", "mesh: {model: 2}"), *argv],), backend=None,
        timeout_s=TIMEOUT_S)
    # one process in a child too: one torch thread, as each rank
    one = run_ranks(cli_worker, 1, (["--config", _cli_config(
        tmp_path, "one", ""), *argv],), backend=None,
        timeout_s=TIMEOUT_S)[0]
    assert sharded[0] == sharded[1]
    assert len(one) == len(sharded[0]) == 1
    np.testing.assert_allclose(sharded[0][0]["train_loss"],
                               one[0]["train_loss"], rtol=1e-9)
    a = torch.load(tmp_path / "fsdp" / "m" / "epoch_0.pt",
                   weights_only=True)["model"]
    b = torch.load(tmp_path / "one" / "m" / "epoch_0.pt",
                   weights_only=True)["model"]
    _close({k: v.numpy() for k, v in a["model"].items()},
           {k: v.numpy() for k, v in b["model"].items()}, "ckpt", **SAME)
    _close(_moments(a), _moments(b), "ckpt momentum", **SAME)
    frames = np.random.default_rng(3).integers(0, 256, (2, 32, 64, 3),
                                               np.uint8)
    served = [Predictor.from_checkpoint(
        str(tmp_path / d / "m"), image_size=(32, 64), batch_size=2,
        dtype=torch.float32, device="cpu").predict(frames)
        for d in ("fsdp", "one")]
    np.testing.assert_array_equal(served[0], served[1])
