"""Meshes of the port: the ``data`` and ``model`` axes over processes,
the ``spatial`` and ``pipe`` axes over one process's devices.

Counterpart of ``rtsds_tpu/parallel/mesh.py``.  JAX builds one mesh over
every chip of the job and lets XLA insert the collectives; the port maps
each axis onto what PyTorch runs:

* ``data`` and ``model`` span processes (``--multihost``: torchrun's or
  the ``RTSDS_*`` variables, one process per GPU).  A rank's place in the
  (data, model) grid follows JAX's row-major reshape of its device list:
  ``rank = data_index * M + model_index``.  The ranks that share a model
  index form the data group: each holds its contiguous shard of every
  global batch, BatchNorm reads global-batch statistics, the losses divide
  by global counts and the gradients are summed over the group
  (``parallel/distributed.py``).  The ranks that share a data index form
  the model group: they load the same frames (JAX replicates the batch
  over ``model``) and each keeps only its shard of every large parameter
  and of its optimizer moments, gathered before the forward and
  reduce-scattered after the backward (``parallel/fsdp.py``).  Without
  ``--multihost`` a model axis exits, as a data axis of several GPUs
  idles them: launch one process per GPU.
* ``spatial`` and ``pipe`` span one process's local devices: a spatial
  mesh bands each frame's rows over them (``parallel/spatial.py``, for
  serving and for training), a pipe mesh pipelines DeepLab's layer3
  (``parallel/pipeline.py``, ``train/pipelined.py``).  Serving's batch
  mesh is one process over a list of devices too, one model replica on
  each (``serve.py``).  A spatial axis of S composes with the axes over
  processes: each process bands its frames over S devices of its own
  (:func:`band_devices`: local rank r holds ``cuda:r*S`` to
  ``cuda:r*S+S-1``; on a box with one GPU every band of every rank is
  ``cuda:0``; too few GPUs raise).

A hybrid mesh (:func:`make_hybrid_mesh`) names the data axis's ranks as
(nodes x local GPUs); the data axis spans both.

A :class:`Mesh` is a row-major device grid with its axis names and sizes.
On the axes over processes a rank knows its own devices only, so every
entry is this rank's device at that entry's spatial index.  The CPU
counts as ``RTSDS_CPU_DEVICES`` devices (default 1), as XLA's host
platform device count does for the JAX package's tests, so that a
spatial, pipe or serving mesh of several devices runs there.
:func:`make_mesh_from_config` builds any ``{data, spatial, model, pipe}``
mesh by the JAX package's rules; what the trainer runs on it is the
CLI's to decide (``cli.py:_check_mesh``).
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import warnings

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An N-D mesh: ``devices`` laid out row-major over ``axis_names``,
    whose sizes are ``axis_sizes`` (default: one axis of every device)."""

    devices: tuple
    axis_names: tuple = ("data",)
    axis_sizes: tuple | None = None

    def __post_init__(self):
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        sizes = (len(self.devices),) if self.axis_sizes is None \
            else tuple(int(n) for n in self.axis_sizes)
        object.__setattr__(self, "axis_sizes", sizes)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if len(sizes) != len(self.axis_names) or \
                math.prod(sizes) != len(self.devices):
            raise ValueError(f"axes {self.axis_names} of sizes {sizes} do "
                             f"not lay out {len(self.devices)} devices")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def grid(self) -> np.ndarray:
        """The devices as an array of the axes' sizes."""
        grid = np.empty(len(self.devices), dtype=object)
        grid[:] = self.devices
        return grid.reshape(self.axis_sizes)

    def axis_size(self, name: str) -> int:
        """The size of axis ``name``; 1 when the mesh lacks it."""
        return self.shape.get(name, 1)

    def axis_devices(self, name: str) -> list[torch.device]:
        """The devices along axis ``name`` at index 0 of every other axis
        (a spatial axis: the devices one process bands its frames
        over)."""
        if name not in self.axis_names:
            return [self.devices[0]]
        index = tuple(slice(None) if a == name else 0
                      for a in self.axis_names)
        return list(self.grid[index])


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor lives on a mesh: ``spec`` () is replicated on every
    device, ``("data",)`` split along the batch dimension, ``("data",
    "spatial")`` the batch over ``data`` and the rows over ``spatial``."""

    mesh: Mesh
    spec: tuple = ()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_devices(device_type: str = "cuda") -> list[torch.device]:
    """This process's devices of ``device_type``: every GPU, or the CPU
    counted ``RTSDS_CPU_DEVICES`` times."""
    if device_type == "cpu":
        return [torch.device("cpu")] * int(
            os.environ.get("RTSDS_CPU_DEVICES", "1"))
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def band_devices(device_type: str = "cuda", spatial: int = 1,
                 local_rank: int | None = None) -> list[torch.device]:
    """The ``spatial`` devices a process bands its frames over.  On the
    CPU, the first ``spatial`` of the CPU counted ``RTSDS_CPU_DEVICES``
    times.  On GPUs, local rank ``r`` (default: read off the current
    device, which :func:`initialize_multihost` sets to the first band's)
    holds ``cuda:r*S`` to ``cuda:r*S+S-1``; on a box with one GPU every
    band of every rank is ``cuda:0``.  Too few devices raise: there is no
    fallback."""
    spatial = max(int(spatial), 1)
    if device_type == "cpu":
        devices = local_devices("cpu")
        if len(devices) < spatial:
            raise ValueError(
                f"a {spatial}-wide spatial axis needs {spatial} CPU devices "
                f"a process, have {len(devices)}: set RTSDS_CPU_DEVICES="
                f"{spatial}")
        return devices[:spatial]
    n = len(local_devices(device_type))
    if n == 1:
        return [torch.device("cuda", 0)] * spatial
    if local_rank is None:
        local_rank = torch.cuda.current_device() // spatial
    first = local_rank * spatial
    if first + spatial > n:
        raise ValueError(
            f"local rank {local_rank} bands over cuda:{first} to "
            f"cuda:{first + spatial - 1} for a {spatial}-wide spatial axis, "
            f"but this box has {n} GPUs: launch at most {n // spatial} "
            f"process(es) per box")
    return [torch.device("cuda", first + i) for i in range(spatial)]


def job_devices(device: torch.device) -> list[torch.device]:
    """The data axis's devices: one per rank of the process group, each
    entry this rank's ``device``."""
    return [torch.device(device)] * process_count()


def make_mesh(devices=None, axis_name: str = "data",
              batch_size: int | None = None) -> Mesh:
    """1-D data mesh over ``devices`` (default: one per rank, on the GPU).

    With ``batch_size`` the mesh is trimmed to the largest device count
    that divides it, with a warning; in a job of several processes that
    raises instead, since a trimmed rank would hold no shard."""
    if devices is None:
        devices = job_devices(_current_device("cuda"))
    devices = list(devices)
    if batch_size is not None:
        n = len(devices)
        while n > 1 and batch_size % n != 0:
            n -= 1
        if n < len(devices):
            if process_count() > 1:
                raise ValueError(
                    f"multihost: global batch {batch_size} must divide by "
                    f"the total device count {len(devices)}; trimming to "
                    f"{n} device(s) would idle entire processes")
            warnings.warn(
                f"make_mesh: global batch {batch_size} is not divisible by "
                f"{len(devices)} devices; using only {n} device(s) and "
                f"idling {len(devices) - n}. Set the batch size to a "
                f"multiple of the chip count for full utilization.",
                stacklevel=2)
        devices = devices[:n]
    return Mesh(tuple(devices), (axis_name,))


def make_mesh_2d(shape: tuple, axis_names=("data", "spatial"),
                 devices=None) -> Mesh:
    """A named N-D mesh over the first ``prod(shape)`` of ``devices``
    (default: one per rank), as the JAX package's ``make_mesh_2d``."""
    if devices is None:
        devices = job_devices(_current_device("cuda"))
    devices = list(devices)
    n = int(np.prod(shape))
    if len(devices) < n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} devices, have "
                         f"{len(devices)}")
    return Mesh(tuple(devices[:n]), tuple(axis_names), tuple(shape))


def make_mesh_from_config(spec: dict, devices=None,
                          batch_size: int | None = None,
                          device_type: str = "cuda") -> Mesh:
    """The job's mesh from the config's ``mesh:`` section, by the JAX
    package's rules.  A pure-data spec (``data: -1`` fills the devices)
    keeps :func:`make_mesh`'s batch-divisibility trimming; ``pipe: N``
    pipelines DeepLab's layer3 over N of this process's devices (``-1``:
    all of them; one device warns and runs as a data mesh), alone and in
    one process only; a spec with ``spatial: S`` or ``model: M`` is a
    ``(data, [spatial,] [model])`` grid: ``data: -1`` fills to
    ``len(devices) // (S * M)``, surplus devices warn that they idle, and
    the global batch must divide the data axis.  ``devices`` defaults to
    :func:`local_devices` for the pipe axis and a spatial axis in one
    process (a box with one GPU bands on it S times), to one per rank on
    the data and model axes, and, when a spatial axis spans several
    processes, to each rank's :func:`band_devices` at every (data,
    spatial, model) entry of its spatial index."""
    d = int(spec.get("data", -1))
    s = int(spec.get("spatial", 1))
    m = int(spec.get("model", 1))
    p = int(spec.get("pipe", 1))
    if devices is None:
        devices = _default_devices(device_type, p, s, m)
    devices = list(devices)
    if p in (-1, 0):
        p = len(devices)
        if p == 1:
            warnings.warn(
                f"mesh spec {spec}: pipe resolved to a single device, so "
                f"the job runs as a plain data mesh and pipe_microbatches "
                f"is ignored; use training.*.accumulate_steps to "
                f"reproduce per-microbatch numerics on one device",
                stacklevel=2)
    elif p < -1:
        raise ValueError(f"mesh spec {spec}: pipe must be a positive "
                         f"stage count or -1 (all devices)")
    if p > 1:
        if s > 1 or m > 1 or d not in (-1, 0, 1):
            raise ValueError(
                f"mesh spec {spec}: pipe does not compose with data/"
                f"spatial/model axes (BN statistics would become "
                f"per-shard); use mesh: {{pipe: {p}}} alone")
        if process_count() > 1:
            raise ValueError(
                "mesh: {pipe: N} is single-process only: the schedule "
                "replicates inputs, which is incompatible with "
                "per-process sharded loading (--multihost)")
        if len(devices) < p:
            raise ValueError(
                f"mesh spec {spec} needs {p} devices, have {len(devices)}")
        if p < len(devices):
            warnings.warn(
                f"mesh spec {spec} uses {p} of {len(devices)} devices; "
                f"{len(devices) - p} chip(s) will idle.", stacklevel=2)
        return Mesh(tuple(devices[:p]), ("pipe",))
    if s <= 1 and m <= 1:
        return make_mesh(devices if d in (-1, 0) else devices[:d],
                         batch_size=batch_size)
    if d in (-1, 0):
        d = len(devices) // (s * m)
        if d == 0:
            raise ValueError(
                f"mesh spec {spec} needs at least {s * m} devices, "
                f"have {len(devices)}")
    if d * s * m < len(devices):
        warnings.warn(
            f"mesh spec {spec} uses {d * s * m} of {len(devices)} devices; "
            f"{len(devices) - d * s * m} chip(s) will idle. Adjust the "
            f"spec (or use data: -1) for full utilization.", stacklevel=2)
    if batch_size is not None and batch_size % d != 0:
        raise ValueError(
            f"global batch {batch_size} does not divide over the {d}-wide "
            f"data axis of mesh spec {spec}; set the batch size to a "
            f"multiple of {d} or shrink the data axis")
    shape, axes = [d], ["data"]
    if s > 1:
        shape.append(s)
        axes.append("spatial")
    if m > 1:
        shape.append(m)
        axes.append("model")
    return make_mesh_2d(tuple(shape), axis_names=tuple(axes),
                        devices=devices)


def _default_devices(device_type: str, p: int, s: int, m: int) -> list:
    """:func:`make_mesh_from_config`'s devices when the caller names
    none."""
    if s > 1 and process_count() > 1:
        bands = band_devices(device_type, s)
        # row-major (data, spatial, model): entry i's spatial index is
        # (i // M) % S
        return [bands[(i // max(m, 1)) % s]
                for i in range(process_count() * s)]
    if p != 1 or s > 1:
        devices = local_devices(device_type)
        if s > 1 and device_type != "cpu" and len(devices) == 1:
            devices = band_devices(device_type, s)
        return devices
    return job_devices(_current_device(device_type))


def _current_device(device_type: str) -> torch.device:
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def batch_sharding(mesh: Mesh, axis_name: str = "data") -> Sharding:
    """The leading (batch) dimension split over the mesh."""
    return Sharding(mesh, (axis_name,))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def spatial_sharding(mesh: Mesh, axis_name: str = "data") -> Sharding:
    """The height (dim 1) of NHWC frames split over the mesh: one band of
    rows per device, the vision analogue of sequence parallelism."""
    return Sharding(mesh, (None, axis_name))


def dp_spatial_sharding(mesh: Mesh, data_axis: str = "data",
                        spatial_axis: str = "spatial") -> Sharding:
    """The batch over ``data`` and the height over ``spatial`` at once
    (NHWC frames and NHW label maps alike)."""
    return Sharding(mesh, (data_axis, spatial_axis))


def row_starts(height: int, n: int) -> list[int]:
    """The first row of each of ``n`` equal bands of ``height`` rows (the
    height must divide)."""
    if height % n:
        raise ValueError(f"image height {height} must divide over the "
                         f"{n}-device mesh for spatial serving")
    return [i * (height // n) for i in range(n)]


def shard_spatial(batch, mesh: Mesh) -> list:
    """NHWC frames (a tensor, or a tuple/list of them) -> one band of rows
    per device of ``mesh``, each on its device; the height must divide
    evenly (:func:`row_starts`)."""
    if isinstance(batch, (tuple, list)):
        parts = [shard_spatial(b, mesh) for b in batch]
        return [type(batch)(p[i] for p in parts) for i in range(mesh.size)]
    from rtsds_tpu_torch.parallel.spatial import split_rows

    return split_rows(batch, mesh.devices, dim=1,
                      starts=row_starts(batch.shape[1], mesh.size))


def input_sharding(mesh: Mesh) -> Sharding:
    """Input batches: split over ``data``, and their rows over ``spatial``
    when the mesh has that axis (the ``model`` axis never shards inputs:
    it shards parameters); replicated on a ``pipe`` mesh, whose schedule
    splits the batch into microbatches itself."""
    if "pipe" in mesh.axis_names:
        return replicated_sharding(mesh)
    if "spatial" in mesh.axis_names:
        return dp_spatial_sharding(mesh)
    return batch_sharding(mesh, mesh.axis_names[0])


def shard_batch(batch, mesh: Mesh) -> list:
    """A batch (a tensor, or a tuple/list of them) -> one chunk per device
    of ``mesh``, each on its device; the batch must divide evenly."""
    if isinstance(batch, (tuple, list)):
        parts = [shard_batch(b, mesh) for b in batch]
        return [type(batch)(p[i] for p in parts) for i in range(mesh.size)]
    n = batch.shape[0]
    if n % mesh.size:
        raise ValueError(f"batch {n} must be a multiple of the "
                         f"{mesh.size}-device mesh")
    return [chunk.to(dev, non_blocking=True)
            for chunk, dev in zip(batch.chunk(mesh.size), mesh.devices)]


def place_state(state, mesh: Mesh):
    """A train state on the job mesh: in a job of several ranks its
    parameters and buffers rank 0's, under a data axis of several ranks
    its BatchNorm global-batch (``parallel/distributed.py:replicate``),
    and FSDP-sharded over ``model`` when that axis is larger than 1
    (``parallel/fsdp.py:shard_state``: each rank keeps its shard of every
    large parameter and of its moments).  A spatial mesh keeps the state on
    its first device; a pipe mesh places its stages when the pipelined
    step is made (``train/pipelined.py``).  Placing a state twice (after a
    restore) changes nothing more."""
    if "data" in mesh.axis_names:
        from rtsds_tpu_torch.parallel.distributed import (
            model_group, replicate)

        if getattr(state.optimizer, "sharded", None) is not None:
            return state  # a restore re-shards through load_state_dict
        replicate(state.model)
        if mesh.axis_size("model") > 1:
            from rtsds_tpu_torch.parallel.fsdp import shard_state

            group = model_group()
            if group is None:
                raise ValueError(
                    f"a {mesh.axis_size('model')}-wide model axis needs a "
                    f"process group of that many ranks (--multihost)")
            shard_state(state, group)
    return state


def make_hybrid_mesh(n_slices: int, devices=None,
                     axis_names=("dcn", "ici")) -> Mesh:
    """A 2-D (nodes x local GPUs) mesh for jobs of several nodes: the job's
    devices (default: one per rank) laid out row-major by rank, node
    ``rank // local world size`` on the outer axis, as the JAX package's
    ``make_hybrid_mesh`` lays out slices (DCN) x chips (ICI).

    The data axis spans both axes (:func:`hybrid_batch_sharding`): a
    rank's shard is its shard on the flat data mesh of the same ranks, and
    the step runs on the flat data group, whose NCCL all-reduces already
    run hierarchically (within a node over NVLink, across nodes over the
    network)."""
    if devices is None:
        devices = job_devices(_current_device("cuda"))
    devices = list(devices)
    if len(devices) % n_slices != 0:
        raise ValueError(
            f"{len(devices)} devices do not split into {n_slices} slices")
    return Mesh(tuple(devices), tuple(axis_names),
                (n_slices, len(devices) // n_slices))


def hybrid_batch_sharding(mesh: Mesh) -> Sharding:
    """The batch dimension split over every axis of ``mesh`` (nodes x
    local GPUs), in the rank order of the flat data mesh."""
    return Sharding(mesh, (mesh.axis_names,))


def planned_process_count() -> int:
    """The job's process count as ``--multihost`` will read it, before the
    process group exists: ``RTSDS_NUM_PROCESSES``, else ``WORLD_SIZE``,
    else 1."""
    return int(os.environ.get("RTSDS_NUM_PROCESSES",
                              os.environ.get("WORLD_SIZE", "1")))


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         device_type: str = "cuda",
                         backend: str | None = None,
                         timeout_s: float | None = None,
                         spatial: int = 1) -> torch.device:
    """Join the job's process group and return this rank's device (its
    first band's, under a ``spatial`` axis of several: :func:`band_devices`
    of its local rank, which raises when the box has too few GPUs).

    The arguments default to ``RTSDS_COORDINATOR_ADDRESS`` (``host:port``),
    ``RTSDS_NUM_PROCESSES`` and ``RTSDS_PROCESS_ID``, as the JAX package
    reads them, else to torchrun's ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``.  The device is ``cuda:LOCAL_RANK * S``
    (``LOCAL_RANK``, else the rank modulo the GPU count over S; NCCL's
    ``device_id``) under NCCL, or the CPU under gloo with
    ``device_type="cpu"``.  ``backend`` overrides the
    choice (gloo on CUDA tensors runs all_reduce, broadcast and barrier,
    all this module needs).  Without a GPU, and not asked for the CPU, it
    raises: it never falls back to gloo or to the CPU on its own."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("RTSDS_COORDINATOR_ADDRESS")
        if coordinator_address is None and "MASTER_ADDR" in env:
            coordinator_address = (f"{env['MASTER_ADDR']}:"
                                   f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = planned_process_count()
    if process_id is None:
        process_id = int(env.get("RTSDS_PROCESS_ID", env.get("RANK", "0")))
    if coordinator_address is None:
        if num_processes > 1:
            raise ValueError(
                "--multihost with several processes needs the coordinator: "
                "set RTSDS_COORDINATOR_ADDRESS=host:port (or launch with "
                "torchrun)")
        coordinator_address = "127.0.0.1:0"
    if device_type == "cpu":
        device = torch.device("cpu")
        backend = backend or "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--multihost: no CUDA device is available; set device: cpu "
                "in the config to run the process group (gloo) on the CPU")
        n = torch.cuda.device_count()
        local = int(env.get("LOCAL_RANK",
                            process_id % max(n // max(spatial, 1), 1)))
        device = (band_devices("cuda", spatial, local)[0] if spatial > 1
                  else torch.device("cuda", local))
        torch.cuda.set_device(device)
        backend = backend or "nccl"
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, **kwargs)
    return device
