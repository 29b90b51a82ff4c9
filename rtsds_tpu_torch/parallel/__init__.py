"""Parallelism of the port: the data axis over processes
(:mod:`~rtsds_tpu_torch.parallel.distributed`), the model axis's FSDP
(:mod:`~rtsds_tpu_torch.parallel.fsdp`), height bands over a process's
devices (:mod:`~rtsds_tpu_torch.parallel.spatial`), the GPipe schedule
over them (:mod:`~rtsds_tpu_torch.parallel.pipeline`), and the meshes
that name them (:mod:`~rtsds_tpu_torch.parallel.mesh`), under the JAX
package's names."""

from rtsds_tpu_torch.parallel.distributed import (  # noqa: F401
    GlobalBatchNorm2d,
    all_reduce_gradients,
    broadcast_state,
    convert_global_batchnorm,
    axis_groups,
    data_parallel,
    global_count,
    global_sum,
)
from rtsds_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    band_devices,
    batch_sharding,
    dp_spatial_sharding,
    hybrid_batch_sharding,
    initialize_multihost,
    input_sharding,
    make_hybrid_mesh,
    make_mesh,
    make_mesh_2d,
    make_mesh_from_config,
    place_state,
    process_count,
    process_index,
    replicated_sharding,
    shard_batch,
)
from rtsds_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_apply,
    pipeline_apply_stateful,
)
