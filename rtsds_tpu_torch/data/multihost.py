"""Per-rank shards of every global batch.

Counterpart of ``rtsds_tpu/data/multihost.py``.  Every rank draws the same
permutation from the same seed, so all agree on the global sample order,
and each decodes only its contiguous ``1 / process_count`` slice of every
global batch; under gradient accumulation over K micro-batches, its
``1 / process_count`` of each of the K contiguous micro-batches
(``parallel/distributed.py:shard_positions``).  JAX stitches the slices
into one global array; in the port each rank keeps its slice on its own
device and the step's collectives (``parallel/distributed.py``) make it a
share of the global batch's step.

Under a ``model`` axis the ranks of one model group load the same frames,
as JAX replicates the batch over ``model``: a rank's shard follows its
place on the data axis (its data group's rank and size,
``parallel/distributed.py``), not its rank in the job.

With one process the "global" batch is the local one.  The JAX package's
``global_batches`` (stitching the slices into global arrays) has no
counterpart: a rank's batches are ``data/pipeline.py:device_batches`` of
its loader, augmented with global batch ``i``'s draws
(``ops/augment.py``).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from rtsds_tpu_torch.data.pipeline import DataLoader
from rtsds_tpu_torch.parallel import distributed as _dist
from rtsds_tpu_torch.parallel import mesh as _mesh
from rtsds_tpu_torch.parallel.distributed import shard_positions


class MultiHostDataLoader(DataLoader):
    """This rank's view of a globally shuffled batch stream.

    ``global_batch_size`` is the GLOBAL batch; each rank stacks ``global /
    process_count`` samples per step.  All ranks must pass the same
    ``seed``.  ``process_index``/``process_count`` default to the data
    axis's (the data group's rank and size inside ``data_parallel``, else
    the process group's) and are overridable, for tests that play several
    ranks in one process.  ``micro_batches`` K > 1 lays each rank's batch
    out for a K-step accumulation: its share of global micro-batch k is
    its k-th slice (this needs ``drop_last``, whole global batches).
    """

    def __init__(self, dataset, global_batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 2, infinite: bool = False,
                 process_index: int | None = None,
                 process_count: int | None = None,
                 micro_batches: int = 1):
        in_job = _dist.job_group() is not None
        if process_count is None:
            process_count = (_dist.world_size() if in_job
                             else _mesh.process_count())
        if process_index is None:
            process_index = _dist.rank() if in_job else _mesh.process_index()
        pc, pi = process_count, process_index
        if global_batch_size % pc != 0:
            raise ValueError(
                f"global batch {global_batch_size} must divide evenly over "
                f"{pc} processes")
        if micro_batches > 1 and not drop_last:
            raise ValueError("micro_batches > 1 needs drop_last: a ragged "
                             "tail does not split into micro-batches")
        self.positions = shard_positions(global_batch_size, pi, pc,
                                         micro_batches)
        super().__init__(dataset, batch_size=global_batch_size // pc,
                         shuffle=shuffle, num_workers=num_workers, seed=seed,
                         drop_last=drop_last, prefetch=prefetch,
                         infinite=infinite)
        self.global_batch_size = global_batch_size
        self.process_index = pi
        self.process_count = pc

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.global_batch_size
        return -(-n // self.global_batch_size)

    def _batch_indices(self) -> Iterator[np.ndarray]:
        n = len(self.dataset)
        local = self.batch_size
        lo, hi = self.process_index * local, (self.process_index + 1) * local
        stop = n - (n % self.global_batch_size)
        if not self.drop_last and stop < n:
            stop = n  # the ragged tail: every rank truncates alike
        if self.infinite and stop == 0:
            raise ValueError(f"an infinite loader needs at least one batch: "
                             f"{n} samples, global batch "
                             f"{self.global_batch_size}")
        while True:
            order = self._order(n)
            self._epoch += 1
            for i in range(0, stop, self.global_batch_size):
                g = order[i:i + self.global_batch_size]
                # skips count GLOBAL groups, so every rank fast-forwards
                # past the same ones, even where its own chunk of a ragged
                # tail is empty
                if self._skip > 0:
                    self._skip -= 1
                    continue
                chunk = g[self.positions] if len(g) == \
                    self.global_batch_size else g[lo:hi]
                if len(chunk) == 0:
                    continue  # a ragged tail shorter than this rank's offset
                yield chunk
            if not self.infinite:
                return

