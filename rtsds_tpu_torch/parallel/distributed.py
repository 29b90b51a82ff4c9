"""The data axis's collectives: what XLA inserts on its own when a JAX step
runs on a batch sharded over ``data``.

The port runs one process per device and sums what JAX's global batch
computes at once.  Three rules make a rank's step the JAX step's share:

* BatchNorm in train mode normalizes with the statistics of the global
  batch (:class:`GlobalBatchNorm2d`): ``[count, sum]`` all-reduced, then
  the centred squares (a two-pass variance, in at least float32), and in
  the backward ``[sum dy, sum dy * xhat]``; the running statistics take
  the global mean and the global unbiased variance;
* every mean in a loss divides by the global count (``ops/losses.py``), so
  the ranks' losses are shares of the global loss;
* the gradients are summed across ranks (:func:`all_reduce_gradients`),
  once before every optimizer update (``train/optim.py``), which gives the
  gradient of the global loss.

Only ``all_reduce`` (a sum, or a max for calibration bounds),
``broadcast`` and ``barrier`` are used: the three collectives gloo also
runs on CUDA tensors, so the same code runs under
NCCL on GPUs, under gloo on the CPU, and under gloo on CUDA tensors when
two ranks share one card.  The models are not wrapped in
``DistributedDataParallel``: the port's steps run several backward passes
per update (the adversarial steps, gradient accumulation), which its
reducer does not expect, and ``nn.SyncBatchNorm`` needs CUDA tensors and
``all_gather``.

Under a ``model`` axis (``parallel/fsdp.py``) the ranks of one model
group share a batch, so every collective above runs over the DATA group
only (the ranks that share a model index): over the whole job it would
count that batch once per model rank.  :func:`data_parallel` takes both
groups; :func:`axis_groups` builds them from the (data, model) grid.  The
job-wide acts (rank 0 writes, the barriers after its saves, the initial
broadcast, the stop flag of a shutdown signal) span every rank.

Everything here is the identity until :func:`data_parallel` names a
process group of more than one rank.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from rtsds_tpu_torch.utils.dtypes import at_least_f32

_GROUP = None   # the data axis's group, None at one rank
_MODEL = None   # the model axis's group, None at one rank
_JOB = None     # every rank of the job, None at one rank


@contextlib.contextmanager
def data_parallel(group=None, model_group=None):
    """Inside the block the data axis spans ``group`` (default: the whole
    process group) and the model axis ``model_group`` (default: none); a
    no-op at world size 1, or with no process group."""
    global _GROUP, _MODEL, _JOB
    previous = _GROUP, _MODEL, _JOB
    if dist.is_initialized():
        group = group if group is not None else dist.group.WORLD
        _GROUP = group if dist.get_world_size(group) > 1 else None
        _MODEL = (model_group if model_group is not None
                  and dist.get_world_size(model_group) > 1 else None)
        _JOB = dist.group.WORLD if dist.get_world_size() > 1 else None
    try:
        yield
    finally:
        _GROUP, _MODEL, _JOB = previous


def axis_groups(model_size: int) -> tuple:
    """``(data_group, model_group)`` of this rank in the job's (data,
    model) grid of ``world / model_size`` x ``model_size`` ranks, laid out
    row-major as the JAX package reshapes its devices: rank ``r`` has data
    index ``r // model_size`` and model index ``r % model_size``.  Every
    rank creates every group (``dist.new_group`` is collective)."""
    world, me = dist.get_world_size(), dist.get_rank()
    if model_size < 1 or world % model_size:
        raise ValueError(f"a model axis of {model_size} does not divide "
                         f"the {world} ranks")
    data_size = world // model_size
    mine = {}
    for m in range(model_size):  # the ranks that share a model index
        ranks = [d * model_size + m for d in range(data_size)]
        group = dist.new_group(ranks)
        if me in ranks:
            mine["data"] = group
    for d in range(data_size):  # the ranks that share a data index
        ranks = [d * model_size + m for m in range(model_size)]
        group = dist.new_group(ranks)
        if me in ranks:
            mine["model"] = group
    return mine["data"], mine["model"]


def data_group():
    """The data axis's process group, or None when it is one rank."""
    return _GROUP


def model_group():
    """The model axis's process group, or None when it is one rank."""
    return _MODEL


def job_group():
    """Every rank of the job, or None when it is one process."""
    return _JOB


def world_size() -> int:
    return 1 if _GROUP is None else dist.get_world_size(_GROUP)


def rank() -> int:
    return 0 if _GROUP is None else dist.get_rank(_GROUP)


def is_main_rank() -> bool:
    """Whether this rank writes: the job's rank 0, or the only process."""
    return _JOB is None or dist.get_rank(_JOB) == 0


def barrier() -> None:
    """Every rank of the job waits for the others."""
    if _JOB is not None:
        dist.barrier(group=_JOB)


def shard_positions(global_n: int, index: int, count: int,
                    micro_batches: int = 1) -> list[int]:
    """The positions in a global batch of ``global_n`` that rank ``index``
    of ``count`` holds.  With one micro-batch, its contiguous slice.  With
    K, its ``1 / count`` of each of the global batch's K contiguous
    micro-batches, in order: the rank's own K-way split
    (``train/accumulate.py:split_microbatches``) then holds its share of
    micro-batch k, as the JAX package splits the global batch."""
    if global_n % (count * micro_batches):
        raise ValueError(
            f"global batch {global_n} does not split into {micro_batches} "
            f"micro-batches over {count} processes")
    micro = global_n // micro_batches
    part = micro // count
    return [k * micro + index * part + i
            for k in range(micro_batches) for i in range(part)]


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data axis's ranks (a new tensor; ``t`` itself
    when there is one rank)."""
    if _GROUP is None:
        return t
    t = t.clone()
    dist.all_reduce(t, group=_GROUP)
    return t


class _SumOverRanks(torch.autograd.Function):
    """``t`` summed over ``group``; its gradient is the ranks' gradients
    of the sum summed too (each rank's loss is a share of the global loss,
    so the gradient of the sum is the sum of the shares' gradients)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def summed_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """:func:`global_sum` through which autograd differentiates: the
    backward all-reduces the gradient over the data axis's ranks.  The
    banded BatchNorm sums its statistics with it (``parallel/spatial.py``),
    so that its backward's ``sum dy`` and ``sum dy * xhat`` are the global
    batch's, as :class:`GlobalBatchNorm2d`'s are."""
    if _GROUP is None:
        return t
    return _SumOverRanks.apply(t, _GROUP)


def global_count(n) -> torch.Tensor | int:
    """A count summed over the ranks: a tensor is all-reduced, an int (a
    shape's size, equal on every rank) multiplied by the world size."""
    if isinstance(n, torch.Tensor):
        return global_sum(n)
    return n * world_size()


def global_max(t: torch.Tensor) -> torch.Tensor:
    """``t``'s elementwise maximum over the data axis's ranks (a new
    tensor; ``t`` itself when there is one rank)."""
    if _GROUP is None:
        return t
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_GROUP)
    return t


def rank_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of ``t``, a tensor drawn for the whole global batch
    (its dim 0): the rows at the rank's :func:`shard_positions` (``t``
    itself at one rank)."""
    if _GROUP is None:
        return t
    return t[shard_positions(t.shape[0], rank(), world_size())]


def cyclic_partners(partner: torch.Tensor, n: int) -> torch.Tensor:
    """The partners of this rank's rows of a global batch of ``n`` frames:
    global row ``i`` pairs with row ``i % m`` of another global batch of
    ``m`` frames, whose contiguous shard ``partner`` this rank holds (FDA's
    target frame of each source frame, ClassMix's source frame of each
    target frame, as the JAX package pairs them over its global arrays).

    At one rank this is ``partner[arange(n) % m]``.  On several, a rank
    takes its partners from its own shard when every rank finds all of its
    partners in its own shard; otherwise the ranks' shards are assembled
    into the global batch by one all-reduce (each shard at its rows, zeros
    elsewhere), and each rank takes its partners from it.  Height bands
    (``parallel/spatial.py``) pair band by band: every rank runs the same
    bands in the same order."""
    from rtsds_tpu_torch.parallel.spatial import Bands, FrameBands

    if isinstance(partner, (Bands, FrameBands)):
        return partner._per_band(lambda p: cyclic_partners(p, n))
    if _GROUP is None:
        return partner[torch.arange(n, device=partner.device)
                       % partner.shape[0]]
    world, me = world_size(), rank()
    local = partner.shape[0]
    m = local * world
    if n == m:  # equal global batches: the same rows on the same rank
        return partner

    def wanted(r):
        return [i % m for i in shard_positions(n, r, world)]
    if all(r * local <= j < (r + 1) * local
           for r in range(world) for j in wanted(r)):
        return partner[[j - me * local for j in wanted(me)]]
    whole = torch.zeros((m, *partner.shape[1:]), dtype=partner.dtype,
                        device=partner.device)
    whole[me * local:(me + 1) * local] = partner
    dist.all_reduce(whole, group=_GROUP)
    return whole[wanted(me)]


@torch.no_grad()
def all_reduce_gradients(params, group=None) -> None:
    """Sum the gradients of ``params`` over the data axis's ranks (or over
    ``group``), in place, with one all-reduce per (device, dtype) bucket.
    Parameters without a gradient are skipped; every rank runs the same
    graph, so they agree on which."""
    group = _GROUP if group is None else group
    if group is None:
        return
    all_reduce_tensors([p.grad for p in params if p.grad is not None],
                       group)


def all_reduce_tensors(tensors, group) -> None:
    """Sum ``tensors`` over ``group``, in place, one all-reduce per
    (device, dtype) bucket."""
    buckets: dict = {}
    for t in tensors:
        buckets.setdefault((t.device, t.dtype), []).append(t)
    for ts in buckets.values():
        flat = _flatten_dense_tensors(ts)
        dist.all_reduce(flat, group=group)
        for t, reduced in zip(ts, _unflatten_dense_tensors(flat, ts)):
            t.copy_(reduced)


# integer metrics that count a shape's elements: equal on every rank
_SHAPE_COUNTS = ("total",)


def reduce_metrics(metrics: dict) -> dict:
    """A step's metrics summed over the ranks: its tensors (the loss
    shares, the pixel counts) in one all-reduce, its shape counts times
    the world size; a float (a schedule's value) is every rank's.  Adds
    ``preempted``, the count of ranks of the whole job that received a
    shutdown signal (``utils/preemption.py``), so that all of them stop at
    one step.  The metrics are summed over the data group alone: the
    ranks of a model group ran the same batch."""
    if _JOB is None:
        return metrics
    from rtsds_tpu_torch.utils.preemption import stop_requested

    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    device = metrics[keys[0]].device if keys else None
    flag = torch.tensor([float(bool(stop_requested()))], dtype=torch.float64,
                        device=device)
    packed = torch.cat([metrics[k].detach().reshape(1).to(torch.float64)
                        for k in keys] + [flag])
    if _MODEL is None:  # the data group is the job
        dist.all_reduce(packed, group=_JOB)
    else:
        if _GROUP is not None:
            dist.all_reduce(packed[:-1], group=_GROUP)
        dist.all_reduce(packed[-1:], group=_JOB)
    out = dict(metrics)
    for i, k in enumerate(keys):
        out[k] = packed[i].to(metrics[k].dtype)
    for k in _SHAPE_COUNTS:
        if isinstance(out.get(k), int):
            out[k] = out[k] * world_size()
    out["preempted"] = packed[-1]
    return out


def broadcast_state(module: nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of ``module`` broadcast from the job's
    rank ``src`` to every rank, in place: after the init or a restore
    every rank holds rank 0's weights."""
    if _JOB is None:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=_JOB)


def _channel_view(x: torch.Tensor):
    dims = [0] + list(range(2, x.dim()))
    shape = [1, x.shape[1]] + [1] * (x.dim() - 2)
    return dims, shape


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch norm over the data axis's global batch."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps,
                momentum, group):
        dims, shape = _channel_view(x)
        xf = at_least_f32(x)
        # [count, sum] then the centred squares: a two-pass variance
        local_count = x.numel() // x.shape[1]
        stats = torch.cat([
            torch.full((1,), float(local_count), dtype=torch.float64,
                       device=x.device),
            xf.sum(dims).to(torch.float64)])
        dist.all_reduce(stats, group=group)
        count = stats[0]
        mean = (stats[1:] / count).to(xf.dtype)
        centred = xf - mean.view(shape)
        sq = (centred * centred).sum(dims).to(torch.float64)
        dist.all_reduce(sq, group=group)
        var = (sq / count).to(xf.dtype)
        invstd = torch.rsqrt(var + eps)
        y = centred * invstd.view(shape)
        if weight is not None:
            y = y * weight.to(xf.dtype).view(shape)
        if bias is not None:
            y = y + bias.to(xf.dtype).view(shape)
        if running_mean is not None:
            unbiased = sq / (count - 1).clamp(min=1)
            running_mean.mul_(1.0 - momentum).add_(
                mean.to(running_mean.dtype), alpha=momentum)
            running_var.mul_(1.0 - momentum).add_(
                unbiased.to(running_var.dtype), alpha=momentum)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.count = count
        ctx.group = group
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        dims, shape = _channel_view(x)
        xf = at_least_f32(x)
        dyf = dy.to(xf.dtype)
        xhat = (xf - mean.view(shape)) * invstd.view(shape)
        sum_dy = dyf.sum(dims)
        sum_dy_xhat = (dyf * xhat).sum(dims)
        grad_x = grad_w = grad_b = None
        if ctx.needs_input_grad[0]:
            both = torch.cat([sum_dy, sum_dy_xhat]).to(torch.float64)
            dist.all_reduce(both, group=ctx.group)
            c = x.shape[1]
            mean_dy = (both[:c] / ctx.count).to(xf.dtype)
            mean_dy_xhat = (both[c:] / ctx.count).to(xf.dtype)
            scale = invstd if weight is None else invstd * weight.to(
                xf.dtype)
            grad_x = (scale.view(shape) * (
                dyf - mean_dy.view(shape) - xhat * mean_dy_xhat.view(shape))
            ).to(x.dtype)
        # the parameters' gradients are this rank's shares, summed with
        # the others' by all_reduce_gradients before the update
        if weight is not None and ctx.needs_input_grad[1]:
            grad_w = sum_dy_xhat.to(weight.dtype)
        if ctx.needs_input_grad[2]:
            grad_b = sum_dy.to(weight.dtype if weight is not None
                               else x.dtype)
        return grad_x, grad_w, grad_b, None, None, None, None, None


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode reads the global batch of the
    data axis (:func:`data_parallel`); in eval mode, and at world size 1,
    it is ``nn.BatchNorm2d`` itself.  On the bands of a spatial axis (a
    ``parallel/spatial.py:Bands``, not a tensor) ``F.batch_norm``'s banded
    form runs, which sums the bands' statistics and then the data axis's
    (:func:`summed_over_ranks`).  The state dict is unchanged."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or _GROUP is None \
                or not isinstance(x, torch.Tensor):
            return super().forward(x)
        self._check_input_dim(x)
        momentum = 0.0 if self.momentum is None else self.momentum
        running_mean = running_var = None
        if self.track_running_stats:
            self.num_batches_tracked.add_(1)
            if self.momentum is None:
                momentum = 1.0 / float(self.num_batches_tracked)
            running_mean, running_var = self.running_mean, self.running_var
        return _GlobalBatchNorm.apply(
            x, self.weight, self.bias, running_mean, running_var, self.eps,
            momentum, _GROUP)


def replicate(*models: nn.Module) -> None:
    """In a job of several ranks: every model's parameters and buffers
    rank 0's, and under a data axis of several ranks its BatchNorm made
    global-batch; nothing at one rank.  Run after the init and after a
    restore."""
    for model in models:
        if _GROUP is not None:
            convert_global_batchnorm(model)
        broadcast_state(model)


def convert_global_batchnorm(model: nn.Module) -> nn.Module:
    """Every ``nn.BatchNorm2d`` of ``model`` made a
    :class:`GlobalBatchNorm2d`, in place (same parameters, buffers and
    state-dict keys); returns ``model``."""
    for m in model.modules():
        if type(m) is nn.BatchNorm2d:
            m.__class__ = GlobalBatchNorm2d
    return model
