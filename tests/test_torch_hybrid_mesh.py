"""The port's hybrid mesh (``parallel/mesh.py:make_hybrid_mesh``,
``hybrid_batch_sharding``, ROADMAP 17.6) against the JAX package's, on
conftest's 8 virtual CPU devices: the grid's shape, its axis names and
device order, the "split" error with JAX's message, and each rank's shard
of a batch under the hybrid sharding, which is the flat data mesh's.  A DA
v1 step on a 2 x 1 hybrid grid of two gloo ranks:
test_torch_spatial_extras_composed.py.
"""

import jax
import numpy as np
import pytest
import torch

from rtsds_tpu.parallel import mesh as jax_mesh
from rtsds_tpu_torch.parallel import (
    hybrid_batch_sharding, make_hybrid_mesh, make_mesh)
from rtsds_tpu_torch.parallel.mesh import shard_batch

# the port's stand-ins for JAX's devices 0-7
DEVICES = [torch.device("cuda", i) for i in range(8)]


@pytest.mark.parametrize("n_slices", [1, 2, 4, 8])
def test_hybrid_mesh_lays_out_jax_grid(n_slices):
    want = jax_mesh.make_hybrid_mesh(n_slices)
    got = make_hybrid_mesh(n_slices, devices=DEVICES)
    assert got.grid.shape == want.devices.shape == (n_slices, 8 // n_slices)
    assert got.axis_names == want.axis_names == ("dcn", "ici")
    # node n holds ranks n * local .. n * local + local - 1
    assert [[d.index for d in row] for row in got.grid] == \
        [[d.id for d in row] for row in want.devices]
    named = make_hybrid_mesh(2, devices=DEVICES, axis_names=("node", "gpu"))
    assert named.shape == {"node": 2, "gpu": 4}


@pytest.mark.parametrize("n_slices", [3, 5, 16])
def test_hybrid_mesh_refuses_a_split_as_jax_does(n_slices):
    with pytest.raises(ValueError) as want:
        jax_mesh.make_hybrid_mesh(n_slices)
    with pytest.raises(ValueError, match="split") as got:
        make_hybrid_mesh(n_slices, devices=DEVICES)
    assert str(got.value) == str(want.value)


def test_each_ranks_hybrid_shard_is_the_flat_meshs_and_jaxs():
    """Rank r's chunk of a global batch under ``hybrid_batch_sharding`` is
    its chunk on the flat data mesh of the same ranks, and the rows JAX's
    hybrid sharding gives device r."""
    batch = torch.arange(16 * 3).reshape(16, 3)
    mesh = make_hybrid_mesh(2, devices=["cpu"] * 8)
    sharding = hybrid_batch_sharding(mesh)
    assert sharding.mesh is mesh and sharding.spec == (("dcn", "ici"),)
    hybrid = shard_batch(batch, mesh)
    flat = shard_batch(batch, make_mesh(["cpu"] * 8))
    jax_sharding = jax_mesh.hybrid_batch_sharding(
        jax_mesh.make_hybrid_mesh(2))
    rows = jax_sharding.devices_indices_map(tuple(batch.shape))
    by_device = {d.id: rows[d] for d in jax.devices()[:8]}
    for r in range(8):
        assert torch.equal(hybrid[r], flat[r])
        np.testing.assert_array_equal(hybrid[r].numpy(),
                                      batch.numpy()[by_device[r]])
