"""Domain adaptation on the spatial axis: one DA v1 step (BiSeNet-R18
generator, Tiny discriminator, float64; source 64x96 and target 64x128
at b2, each banded on its own row partition) on 2 CPU bands, against one
device at rtol 1e-9 / atol 1e-12 and against JAX's step at
test_torch_parallel.py's v1 limits (losses rtol 1e-8, parameters rtol
1e-6 / atol 1e-10).  The supervised steps and validation on bands:
test_torch_spatial_train.py.
"""

import numpy as np
import torch

from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.discriminator import TinyDomainDiscriminator
from rtsds_tpu_torch.parallel.spatial import split_batch
from rtsds_tpu_torch.train.adversarial import make_adversarial_step
from test_torch_spatial_train import (  # noqa: F401 -- a fixture
    SAME, _close, _few_threads, _numpy, _sgd)

DA_V1 = (1e-8, 1e-6, 1e-10)   # loss rtol, rtol, atol (test_torch_parallel)
SRC, TGT = (64, 96), (64, 128)


def _da_batch():
    rng = np.random.default_rng(7)
    src = rng.normal(size=(2, *SRC, 3))
    tgt = rng.normal(size=(2, *TGT, 3))
    labels = rng.integers(0, 19, size=(2, *SRC)).astype(np.int64)
    labels[:1, : SRC[0] // 2] = 19
    return src, labels, tgt


def test_da_v1_step_on_bands_equals_one_device_and_jax():
    import jax
    import jax.numpy as jnp
    import optax

    from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
    from rtsds_tpu.models.discriminator import (
        TinyDomainDiscriminator as FlaxTiny)
    from rtsds_tpu.parallel import mesh as jax_mesh
    from rtsds_tpu.train.adversarial import (
        make_adversarial_step as jax_adversarial_step)
    from rtsds_tpu.train.state import TrainState as JaxTrainState
    from test_torch_fsdp import _f64, _numpy_sd

    gen = jax.jit(lambda key, x: FlaxBiSeNet(num_classes=19).init(
        key, x, train=True))(jax.random.key(0), jnp.zeros((2, *SRC, 3)))
    dis = FlaxTiny(num_classes=19).init(jax.random.key(1),
                                        jnp.zeros((2, *TGT, 19)))
    gen_vars, dis_vars = _f64(dict(gen)), _f64(dict(dis))
    src, labels, tgt = _da_batch()
    runs = {}
    for n in (0, 2):
        g = BiSeNet().double()
        g.load_state_dict({k: torch.from_numpy(v)
                           for k, v in _numpy_sd(gen_vars).items()})
        d = TinyDomainDiscriminator().double()
        d.load_state_dict({k: torch.from_numpy(v)
                           for k, v in _numpy_sd(dis_vars).items()})
        s, y, t = (torch.from_numpy(a) for a in (src, labels, tgt))
        if n:  # source and target banded apart, each on its partition
            s, y = split_batch(s, y, ["cpu"] * n)
            t, _ = split_batch(t, torch.zeros(t.shape[:3]), ["cpu"] * n)
        metrics = make_adversarial_step(0.1, 5, 1, 19, "v1")(
            _sgd(g, momentum=0.0, lr=0.01), _sgd(d, momentum=0.0, lr=0.02),
            s, y, t)
        runs[n] = ({k: float(v) for k, v in metrics.items()}, _numpy(g),
                   _numpy(d))
    got, one = runs[2], runs[0]
    _close(got[0], one[0], "metrics", **SAME)
    _close(got[1], one[1], "G", **SAME)
    _close(got[2], one[2], "D", **SAME)

    mesh = jax_mesh.make_mesh(jax.devices()[:2])

    def state(variables, apply_fn, lr):
        tx = optax.sgd(lr)
        return jax_mesh.shard_state(JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=variables.get("batch_stats"),
            opt_state=tx.init(variables["params"]), apply_fn=apply_fn,
            tx=tx), mesh)

    loss_rtol, rtol, atol = DA_V1
    with jax.enable_x64(True):
        step = jax_adversarial_step(0.1, 5, epochs=1, ignore_index=19,
                                    donate=False, variant="v1")
        g, d, metrics = step(
            state(jax.tree_util.tree_map(jnp.asarray, gen_vars),
                  FlaxBiSeNet(num_classes=19).apply, 0.01),
            state(jax.tree_util.tree_map(jnp.asarray, dis_vars),
                  FlaxTiny(num_classes=19).apply, 0.02),
            *jax_mesh.shard_batch((jnp.asarray(src),
                                   jnp.asarray(labels, jnp.int32),
                                   jnp.asarray(tgt)), mesh))
        metrics = {k: float(v) for k, v in metrics.items()}
        want_g = _numpy_sd(_f64({"params": g.params,
                                 "batch_stats": g.batch_stats}))
        want_d = _numpy_sd(_f64({"params": d.params}))
    assert got[0]["correct"] == metrics["correct"]
    for k in metrics:
        if k not in ("correct", "total"):
            np.testing.assert_allclose(got[0][k], metrics[k],
                                       rtol=loss_rtol, atol=1e-12,
                                       err_msg=k)
    _close({k: v for k, v in got[1].items()
            if not k.endswith("num_batches_tracked")}, want_g, "G",
           rtol=rtol, atol=atol)
    _close(got[2], want_d, "D", rtol=rtol, atol=atol)
