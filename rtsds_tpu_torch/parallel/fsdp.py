"""The ``model`` axis: fully-sharded data parallelism (FSDP).

Counterpart of ``rtsds_tpu/parallel/mesh.py:fsdp_shard_state``, where
each large array of the train state (a parameter and its mirrored
optimizer moments) is split over the mesh's ``model`` axis and XLA
all-gathers each kernel before use and reduce-scatters its gradient.  The
port does the same by hand over the model group of processes
(``parallel/distributed.py:axis_groups``), the ranks that share a batch:

* :func:`shard_dim` is JAX's placement rule in torch's layouts: an array
  of fewer than ``min_size`` (2^15) elements stays replicated; otherwise
  JAX's trailing HWIO dimension (the output channels, OIHW's dim 0) if
  the axis size divides it, else the largest dimension it divides (ties
  to the lower JAX dimension), else replicated;
* each rank keeps only its chunk of every sharded parameter (a
  :class:`ShardedParameters` shard, which the optimizer updates) and of
  that parameter's moments; the module's own parameter holds no storage
  between steps;
* before the model's forward every sharded parameter is gathered whole;
  it stays gathered until the optimizer's step, which frees it (the
  backward reads the gathered tensors);
* after the backward the gradients are summed over the data group
  (``all_reduce_gradients``), then reduce-scattered over the model group
  and divided by its size: its ranks ran the same batch, so their
  gradients are each the global batch's and the reduction is their mean,
  the gradient of one rank, as JAX's numbers on a (data, model) mesh are
  the replicated step's.  The replicated parameters' gradients, and the
  BN running statistics each rank's forward advanced, take the same mean
  by an all-reduce, so every model rank holds them alike (on a GPU two
  ranks' forwards may round apart).
  Adam and SGD are elementwise, so a shard's update is the full update's
  chunk;
* a train state's ``state_dict`` gathers the full parameters and
  moments, so a checkpoint is the replicated run's file, and
  ``load_state_dict`` cuts a full one back into this rank's chunks;
* an EMA of the model (``train/ema.py``) keeps a chunk of each sharded
  parameter's average, split as the parameter is (JAX's EMA tree follows
  the parameters' sharding): :meth:`ShardedParameters.local_parameters`
  are what it averages, :meth:`ShardedParameters.gather_like` and
  :meth:`ShardedParameters.cut` move its chunks to whole tensors and
  back.  :func:`sharded_of` finds a model's shards.

The collectives come in two forms, chosen by the group's backend, never
by catching a failure: NCCL runs ``all_gather_into_tensor`` and
``reduce_scatter_tensor``; gloo (on CPU tensors, or on CUDA tensors when
two ranks share one card) runs only ``all_reduce``, ``broadcast`` and
``barrier`` on CUDA tensors, so there the gather is a zero buffer with
the rank's chunk written in, summed (exact: every other addend is zero),
and the reduce-scatter a sum whose chunk the rank keeps.

Why not torch's FSDP2 ``fully_shard``: it shards every parameter on dim 0
(JAX keeps arrays under 2^15 elements whole and picks another dimension
when dim 0 does not divide), and its collectives are the NCCL forms that
gloo does not run on CUDA tensors.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch import nn

from rtsds_tpu_torch.parallel.distributed import (
    all_reduce_gradients, all_reduce_tensors)
from rtsds_tpu_torch.utils.dtypes import at_least_f32

MIN_SIZE = 2 ** 15

# a conv kernel's JAX (HWIO) dimension -> its torch (OIHW) dimension
_HWIO_TO_OIHW = {0: 2, 1: 3, 2: 1, 3: 0}


def jax_shape(shape: tuple) -> tuple:
    """The JAX package's shape of a torch array: an OIHW conv kernel is
    HWIO there; vectors are the same."""
    if len(shape) == 4:
        o, i, h, w = shape
        return (h, w, i, o)
    return tuple(shape)


def shard_dim(shape: tuple, axis_size: int, min_size: int = MIN_SIZE
              ) -> int | None:
    """The torch dimension an array of ``shape`` is split on over a model
    axis of ``axis_size``, by ``fsdp_shard_state``'s rule, or None when it
    stays replicated."""
    shape = tuple(int(n) for n in shape)
    if not shape or math.prod(shape) < min_size:
        return None
    js = jax_shape(shape)
    last = len(js) - 1
    for d in sorted(range(len(js)), key=lambda d: (d != last, -js[d])):
        if js[d] % axis_size == 0:
            return _HWIO_TO_OIHW[d] if len(js) == 4 else d
    return None


@dataclasses.dataclass
class _Entry:
    name: str
    param: nn.Parameter      # the module's own; no storage between steps
    dim: int
    shard: nn.Parameter      # this rank's chunk, which the optimizer holds
    shape: torch.Size        # the full shape


class ShardedParameters:
    """The large parameters of ``model`` sharded over ``group`` (see the
    module docstring).  ``install`` hands the shards to an optimizer."""

    def __init__(self, model: nn.Module, group, min_size: int = MIN_SIZE):
        self.model = model
        self.group = group
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.native = dist.get_backend(group) == "nccl"
        self.entries: list[_Entry] = []
        for name, p in model.named_parameters():
            d = shard_dim(tuple(p.shape), self.size, min_size)
            if d is None:
                continue
            chunk = p.detach().chunk(self.size, d)[self.index].clone()
            self.entries.append(_Entry(name, p, d, nn.Parameter(
                chunk, requires_grad=p.requires_grad), p.shape))
        self._by_param = {id(e.param): e for e in self.entries}
        self._by_shard = {id(e.shard): e for e in self.entries}
        self._by_name = {e.name: e for e in self.entries}
        self.gathered = True
        self.free()
        self._hook = model.register_forward_pre_hook(
            lambda module, args: self.gather())
        model._rtsds_sharded = self

    # --- the collectives --------------------------------------------------

    def _gather(self, e: _Entry) -> torch.Tensor:
        shard = e.shard.detach()
        if self.native:
            out = shard.new_empty((self.size, *shard.shape))
            dist.all_gather_into_tensor(out, shard.contiguous(),
                                        group=self.group)
            return torch.cat(list(out), dim=e.dim)
        full = shard.new_zeros(e.shape)
        full.narrow(e.dim, self.index * shard.shape[e.dim],
                    shard.shape[e.dim]).copy_(shard)
        dist.all_reduce(full, group=self.group)
        return full

    def _chunk(self, full: torch.Tensor, e: _Entry) -> torch.Tensor:
        return full.chunk(self.size, e.dim)[self.index]

    # --- the step ---------------------------------------------------------

    def gather(self) -> None:
        """Every sharded parameter whole again (before a forward; a
        validation's forward under inference mode gathers ordinary tensors,
        which the next training step may save for its backward)."""
        if self.gathered:
            return
        with torch.inference_mode(False), torch.no_grad():
            for e in self.entries:
                e.param.data = self._gather(e)
        self.gathered = True

    def free(self) -> None:
        """Drop the whole parameters (the shards stay)."""
        for e in self.entries:
            e.param.data = e.shard.detach().new_empty(0)
        self.gathered = False

    @torch.no_grad()
    def reduce_gradients(self, params) -> None:
        """The gradients of ``params`` (the optimizer's: shards and
        replicated parameters) made the global batch's, each rank keeping
        its shards' chunks: the whole gradients summed over the data group,
        then averaged over the model group, the sharded ones
        reduce-scattered into their shards' ``grad``; the BN running
        statistics averaged over the model group; the whole parameters
        and gradients are then freed."""
        whole = [e.param for e in self.entries]
        replicated = [p for p in params if id(p) not in self._by_shard]
        all_reduce_gradients(whole + replicated)
        for e in self.entries:
            g = e.param.grad
            if g is None:
                e.shard.grad = None
                continue
            if self.native:
                out = g.new_empty(e.shard.shape)
                dist.reduce_scatter_tensor(
                    out, torch.stack(g.chunk(self.size, e.dim)),
                    group=self.group)
            else:
                dist.all_reduce(g, group=self.group)
                out = self._chunk(g, e).clone()
            e.shard.grad = out.div_(self.size)
            e.param.grad = None
        grads = [p.grad for p in replicated if p.grad is not None]
        # the BN running statistics too: each rank's forward advanced them
        stats = [b for b in self.model.buffers() if b.is_floating_point()]
        all_reduce_tensors(grads + stats, self.group)
        for t in grads + stats:
            t.div_(self.size)
        self.free()

    @torch.no_grad()
    def global_norm(self, params) -> torch.Tensor:
        """The L2 norm of the whole gradient whose parts on this rank are
        the gradients of ``params`` (shards and replicated parameters), in
        at least float32: the shards' squares summed over the model group,
        the replicated ones counted once."""
        grads = [p.grad for p in params if p.grad is not None]
        device = grads[0].device

        def squares(gs):
            total = torch.zeros((), dtype=torch.float64, device=device)
            for g in gs:
                total = total + at_least_f32(g).pow(2).sum().to(
                    device, torch.float64)
            return total
        sq = squares([p.grad for p in params if p.grad is not None
                      and id(p) in self._by_shard])
        dist.all_reduce(sq, group=self.group)
        sq = sq + squares([p.grad for p in params if p.grad is not None
                           and id(p) not in self._by_shard])
        return sq.sqrt().to(torch.promote_types(grads[0].dtype,
                                                torch.float32))

    # --- tensors split as the parameters are (the EMA) --------------------

    def local_parameters(self) -> dict:
        """``{name: tensor}`` of what this rank holds of every parameter,
        in ``named_parameters`` order: a sharded one's shard, a replicated
        one itself."""
        return {name: (self._by_name[name].shard if name in self._by_name
                       else p) for name, p in self.model.named_parameters()}

    def gather_like(self, name: str, chunk: torch.Tensor) -> torch.Tensor:
        """The whole tensor of which ``chunk`` is this rank's chunk, split
        as parameter ``name`` is (a collective over the model group);
        ``chunk`` itself for a replicated parameter."""
        e = self._by_name.get(name)
        if e is None:
            return chunk
        return self._gather(dataclasses.replace(e, shard=chunk.detach()))

    def cut(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of ``full``, split as parameter ``name`` is
        (a view; ``full`` itself for a replicated parameter)."""
        e = self._by_name.get(name)
        return full if e is None else self._chunk(full, e)

    # --- the optimizer and the state dicts --------------------------------

    def install(self, optimizer) -> None:
        """Hand ``optimizer`` (a ``ScheduledOptimizer``) the shards in
        place of the whole parameters, each moment it already holds cut to
        this rank's chunk."""
        inner = optimizer.optimizer
        for group in inner.param_groups:
            group["params"] = [self._shard_of(p) for p in group["params"]]
        for e in self.entries:
            if e.param in inner.state:
                inner.state[e.shard] = self._cut(inner.state.pop(e.param), e)
        optimizer.frozen = [self._shard_of(p) for p in optimizer.frozen]
        optimizer.sharded = self

    def _shard_of(self, p):
        e = self._by_param.get(id(p))
        return p if e is None else e.shard

    def _cut(self, moments: dict, e: _Entry) -> dict:
        return {k: self._chunk(v, e).clone()
                if isinstance(v, torch.Tensor) and v.shape == e.shape else v
                for k, v in moments.items()}

    def model_state_dict(self) -> dict:
        """The model's state dict with every sharded parameter whole (a
        collective: every rank of the model group calls it)."""
        state = self.model.state_dict()
        for e in self.entries:
            state[e.name] = (e.param.detach() if self.gathered
                             else self._gather(e))
        return state

    def optimizer_state_dict(self, optimizer) -> dict:
        """``optimizer.state_dict()`` with every shard's moments whole, so
        that it is the replicated run's (a collective)."""
        state = optimizer.state_dict()
        index = {}
        for group in optimizer.optimizer.param_groups:
            for p in group["params"]:
                index[id(p)] = len(index)
        moments = state["optimizer"]["state"]
        for e in self.entries:
            i = index[id(e.shard)]
            if i in moments:
                moments[i] = {k: self.gather_like(e.name, v)
                              if isinstance(v, torch.Tensor)
                              and v.shape == e.shard.shape else v
                              for k, v in moments[i].items()}
        return state

    @torch.no_grad()
    def load_model_state_dict(self, state: dict) -> None:
        """A whole model state dict into the shards and the replicated
        tensors."""
        state = dict(state)
        own = self.model.state_dict()
        for e in self.entries:
            full = state.pop(e.name)
            if tuple(full.shape) != tuple(e.shape):
                raise RuntimeError(f"size mismatch for {e.name}: "
                                   f"{tuple(full.shape)} vs "
                                   f"{tuple(e.shape)}")
            e.shard.copy_(self._chunk(full.to(e.shard.device), e))
        unexpected = sorted(set(state) - set(own))
        if unexpected:
            raise RuntimeError(f"unexpected keys {unexpected[:8]}")
        missing = self.model.load_state_dict(state, strict=False)
        if missing.missing_keys != [e.name for e in self.entries]:
            raise RuntimeError(f"missing keys {missing.missing_keys[:8]}")
        self.free()

    def load_optimizer_state_dict(self, optimizer, state: dict) -> None:
        """A whole optimizer state dict, each shard's moments cut to this
        rank's chunk."""
        optimizer.optimizer.load_state_dict(state["optimizer"])
        optimizer.count = int(state["count"])
        inner = optimizer.optimizer
        for e in self.entries:
            if e.shard in inner.state:
                inner.state[e.shard] = self._cut(inner.state[e.shard], e)

    def resident_bytes(self, optimizer) -> int:
        """The bytes this rank keeps of the parameters and their moments
        between steps: every shard and replicated parameter, and their
        optimizer state's tensors."""
        inner = optimizer.optimizer
        params = [p for g in inner.param_groups for p in g["params"]]
        total = 0
        for p in params:
            total += p.numel() * p.element_size()
            for v in inner.state.get(p, {}).values():
                if isinstance(v, torch.Tensor) and v.dim() > 0:
                    total += v.numel() * v.element_size()
        return total


def sharded_of(model: nn.Module) -> ShardedParameters | None:
    """The :class:`ShardedParameters` of ``model``, or None when its
    parameters are whole."""
    return getattr(model, "_rtsds_sharded", None)


def shard_state(state, group, min_size: int = MIN_SIZE) -> ShardedParameters:
    """Shard a :class:`~rtsds_tpu_torch.train.state.TrainState`'s model and
    optimizer over the model ``group`` in place; returns the shards."""
    sharded = ShardedParameters(state.model, group, min_size)
    sharded.install(state.optimizer)
    return sharded


def placement_bytes(model: nn.Module, axis_size: int, moments: int,
                    min_size: int = MIN_SIZE) -> int:
    """What the placement rule leaves one rank of the parameters of an
    unsharded ``model`` and ``moments`` optimizer moments of each (1 for
    SGD with momentum, 2 for Adam), reckoned from the shapes alone."""
    total = 0
    for p in model.parameters():
        n = p.numel()
        if shard_dim(tuple(p.shape), axis_size, min_size) is not None:
            n //= axis_size
        total += n * p.element_size() * (1 + moments)
    return total
