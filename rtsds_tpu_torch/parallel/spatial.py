"""Height-band (spatial) inference and training: one frame's rows split
over the devices of a mesh, for frames too large for one device.

Counterpart of what XLA's SPMD partitioner does to the JAX package's
serving forward under ``rtsds_tpu/parallel/mesh.py:spatial_sharding``
(``P(None, "data")``: NHWC frames split along H, the weights replicated),
where it inserts the conv halo exchanges and the all-reduces of the global
pools itself.  No PyTorch partitioner does that for these nets: DTensor's
halo conv splits the width only, needs dilation 1 and, with padding, stride
1, which rules out BiSeNet's stride-2 convs and DeepLab's dilated ASPP.  So
the split is written here.

:class:`Bands` is a tensor-like (not a ``torch.Tensor``): its ``parts``
are one (N, C, h_i, W) tensor per device holding the global rows
``[starts[i], starts[i + 1])`` of an (N, C, H, W) map (H is always the
second-to-last dim, so an argmax's (N, H, W) masks are bands too), and its
``shape`` is the global one.  A model's own ``forward`` runs on it
unchanged: ``__torch_function__`` gives every torch function the model
calls a banded form, and refuses the ones it has none for, so no op ever
runs on a band alone when it reads across rows.

* Ops that read across rows: ``conv2d`` and ``max_pool2d`` read
  ``dilation * (k - 1)`` rows past their band, gathered from whichever
  bands hold them (a halo may be wider than a neighbour band: DeepLab's
  ASPP dilation of 24 at 1/8 of a small frame), zeros (or -inf for the
  pool) only beyond the global edges, with no row padding inside; band
  ``i`` of a stride-``s`` output holds the output rows ``[ceil(a_i / s),
  ceil(a_{i+1} / s))`` of the input rows ``[a_i, a_{i+1})``, so that every
  level stays a partition whatever H / 32 is (a band may hold no row).
  ``interpolate`` (bilinear, half-pixel) takes each output row's taps from
  the GLOBAL heights, as torch's kernels compute them (the plain kernel's
  two clamped taps, or the antialiased kernel's widened triangle where it
  shrinks), on the rows gathered for it, then resizes the width with
  torch's own kernel.  ``mean`` over H sums each band in at least float32,
  adds the sums on the first device and divides by the global count
  (BiSeNet's ARM/FFM gates, the ResNet tail): a plain tensor.
* Train-mode ``batch_norm`` reads the whole batch: each band's sums in at
  least float32, added on the first device, the mean, then the centred
  squares the same way (a two-pass variance, as
  ``parallel/distributed.py:GlobalBatchNorm2d`` computes it), the running
  mean and the unbiased running variance from the global count; its
  backward, as every op's here, is autograd's over the bands' tensors and
  their copies, which is the whole batch's.  Under the data axis each of
  the two sums is then all-reduced over the data group by an op whose
  backward all-reduces its gradient
  (``distributed.py:summed_over_ranks``), and the count is the global
  batch's, so the statistics and the backward's ``sum dy`` and ``sum dy
  * xhat`` are the global batch's; those all-reduces run in the backward
  in autograd's order, which one autograd thread keeps alike on every
  rank (the CLI turns off autograd's per-device threads when the spatial
  axis spans processes).  ``cross_entropy`` sums each
  band's losses and counts its valid pixels, and divides on the first
  device; ``sum`` over every dim is a plain tensor there too.  The
  discriminators pool their logits over H (a plain tensor), so their BCE
  never meets a band.
* Every other op is per band: elementwise ops (a plain operand must not
  vary along H: the pooled gates), eval-mode ``batch_norm``, ``softmax``
  and ``log_softmax``, ``exp``, ``leaky_relu``, ``argmax`` and ``max``
  over channels, ``where``, comparisons, sums and ``cat`` over the
  channel or batch dims, batch slicing and width flips, and a small
  plain table indexed by banded ids (a per-class threshold).
* The training extras' ops over H (ROADMAP item 17.5b): a nearest resize
  of labels (:func:`take_rows`: each output row's source row by the rule
  on the global heights, from whichever band holds it); the adaptive
  average pool (to the map's own height each band pools its own rows,
  to another one each output band reads the rows its windows span); the
  gradient reversal and an int8 teacher's conv walk (:func:`banded_walk`)
  band by band; remat, whose recompute meets the same partitions
  (``_Layout.partitions`` is filled by the first forward); a banded batch
  split into micro-batches (:func:`split_micro_batches`).  FDA's FFTs read
  every row: ``ops/fda.py`` gathers the frames on the first band's
  device, the one gather of a training step.

The int8 walks (``models/{bisenet,deeplab}_int8.py``) take their convs
through an ``op(name, x, stride, padding, dilation)`` argument:
:class:`SpatialModel` passes a banded ``op`` that calls each device's
replica's quantized conv on the band's rows with the padding ``(0, pw)``;
the quantize and dequantize steps are elementwise, so per band.

Bands move between devices by device copies (``Tensor.to``), in one
process, and every op is a differentiable torch op, so a training step
runs on bands as it runs on a tensor (ROADMAP item 17.4): the weights stay
on the first device, ``Tensor.to`` copies carry them to the others, and
the backward carries each copy's gradient back to the first device's
parameter.  A training layout (:func:`split_batch`'s) caches no copy: a
parameter the model axis gathers anew each step (``parallel/fsdp.py``)
may reuse a freed pointer, which a cache keyed by ``data_ptr`` would
take for the old copy.  :class:`FrameBands` holds NHWC frames banded
the same way, whose ``permute(0, 3, 1, 2)`` is the model's input;
:func:`split_batch` bands a training or validation batch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.nn.modules.utils import _pair

NOT_BANDED = ("has no height-band form: gather the map first "
              "(parallel/spatial.py:gather)")


class _Layout:
    """What the bands of one frame batch share: the devices, each weight's
    copy on each device, and the row partition met at each height."""

    def __init__(self, devices, copies: dict | None = None):
        self.devices = [torch.device(d) for d in devices]
        self.copies = copies or {}
        self.partitions: dict = {}

    def on(self, t, i: int):
        """``t`` (a tensor, or None) on device ``i``: the replica's copy of
        a weight, else a copy of ``t`` (a pooled gate: small)."""
        if not isinstance(t, torch.Tensor):
            return t
        dev = self.devices[i]
        if t.device == dev:
            return t
        copy = self.copies.get((t.data_ptr(), t.dtype, tuple(t.shape)))
        return copy[i] if copy is not None else t.to(dev)


class Bands:
    """An (..., H, W) map split by rows over devices: ``parts[i]`` holds the
    global rows ``[starts[i], starts[i + 1])`` (the last band up to
    ``height``) on ``layout.devices[i]``."""

    def __init__(self, parts, starts, height: int, layout: _Layout):
        self.parts = list(parts)
        self.starts = tuple(int(s) for s in starts)
        self.height = int(height)
        self.layout = layout
        layout.partitions.setdefault(self.height, self.starts)

    # --- what a tensor tells about itself ---------------------------------

    @property
    def shape(self) -> torch.Size:
        s = list(self.parts[0].shape)
        s[-2] = self.height
        return torch.Size(s)

    @property
    def ndim(self) -> int:
        return self.parts[0].dim()

    def dim(self) -> int:
        return self.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.layout.devices[0]

    def bounds(self, i: int) -> tuple[int, int]:
        return _bounds(self.starts, self.height, i)

    def _like(self, parts) -> "Bands":
        return Bands(parts, self.starts, self.height, self.layout)

    def _per_band(self, fn) -> "Bands":
        return self._like([fn(p) for p in self.parts])

    def _hdim(self, dims) -> bool:
        """Whether ``dims`` name the H dim."""
        if dims is None:
            return True
        dims = dims if isinstance(dims, (tuple, list)) else (dims,)
        return any(d % self.ndim == self.ndim - 2 for d in dims)

    def _below_rows(self, dim, what: str) -> int:
        """``dim`` normalized, when it lies before the H and W dims."""
        d = dim % self.ndim
        if d >= self.ndim - 2:
            raise NotImplementedError(f"{what} over dim {dim} of a banded "
                                      f"map {NOT_BANDED}")
        return d

    # --- tensor methods ---------------------------------------------------

    def to(self, *args, **kwargs) -> "Bands":
        if "device" in kwargs or any(isinstance(a, (torch.device, str))
                                     for a in args):
            raise NotImplementedError("a banded map stays on its devices; "
                                      "gather it first")
        return self._per_band(lambda p: p.to(*args, **kwargs))

    def float(self) -> "Bands":
        return self.to(torch.float32)

    def contiguous(self) -> "Bands":
        return self._per_band(torch.Tensor.contiguous)

    def flip(self, *dims) -> "Bands":
        dims = tuple(dims[0]) if len(dims) == 1 and isinstance(
            dims[0], (tuple, list)) else dims
        if self._hdim(dims):
            raise NotImplementedError(f"flip over H {NOT_BANDED}")
        return self._per_band(lambda p: p.flip(dims))

    def __getitem__(self, key):
        if isinstance(key, slice):
            return self._per_band(lambda p: p[key])
        if key == (Ellipsis, None) and self.ndim == 3:
            # (N, H, W) maps -> (N, H, W, 1): NHWC, rows at dim 1
            return FrameBands([p[..., None] for p in self.parts],
                              self.starts, self.height, self.layout)
        raise NotImplementedError(f"indexing with {key!r} {NOT_BANDED}"
                                  f" (batch slices and [..., None] only)")

    def permute(self, *dims) -> "FrameBands":
        if tuple(dims) != (0, 2, 3, 1):
            raise NotImplementedError(f"permute{tuple(dims)} of a banded "
                                      f"map {NOT_BANDED}")
        return FrameBands([p.permute(0, 2, 3, 1) for p in self.parts],
                          self.starts, self.height, self.layout)

    def max(self, dim=None, keepdim: bool = False):
        """Per band over a dim before the rows: ``(values, indices)``."""
        if dim is None:
            raise NotImplementedError(f"a flat max {NOT_BANDED}")
        self._below_rows(dim, "max")
        outs = [p.max(dim=dim, keepdim=keepdim) for p in self.parts]
        return (self._like([o.values for o in outs]),
                self._like([o.indices for o in outs]))

    def exp(self) -> "Bands":
        return self._per_band(torch.exp)

    def neg(self) -> "Bands":
        return self._per_band(torch.neg)

    __neg__ = neg

    def clamp(self, min=None, max=None) -> "Bands":  # noqa: A002
        return self._per_band(lambda p: p.clamp(min, max))

    def sub(self, other):
        return _binary(torch.sub, self, other)

    __sub__ = sub

    def __rsub__(self, other):
        return _binary(torch.sub, other, self)

    def argmax(self, dim=None, keepdim: bool = False) -> "Bands":
        if dim is None:
            raise NotImplementedError(f"a flat argmax {NOT_BANDED}")
        self._below_rows(dim, "argmax")
        return self._per_band(lambda p: p.argmax(dim=dim, keepdim=keepdim))

    def mean(self, dim=None, keepdim: bool = False, dtype=None):
        """Per band over dims without H; over H (and any others) the
        bands' sums in at least float32, added on the first device and
        divided by the global count: a plain tensor."""
        if not self._hdim(dim):
            return self._per_band(lambda p: p.mean(dim, keepdim=keepdim,
                                                   dtype=dtype))
        dims = tuple(range(self.ndim)) if dim is None else (
            tuple(dim) if isinstance(dim, (tuple, list)) else (dim,))
        acc = torch.promote_types(self.dtype, torch.float32)
        total = None
        for p in self.parts:
            s = p.sum(dims, keepdim=keepdim, dtype=acc).to(self.device)
            total = s if total is None else total + s
        count = math.prod(self.shape[d] for d in dims)
        return (total / count).to(dtype or self.dtype)

    def __add__(self, other):
        return _binary(torch.add, self, other)

    def __radd__(self, other):
        return _binary(torch.add, other, self)

    def __mul__(self, other):
        return _binary(torch.mul, self, other)

    def __rmul__(self, other):
        return _binary(torch.mul, other, self)

    def __truediv__(self, other):
        return _binary(torch.div, self, other)

    def __eq__(self, other):  # noqa: D105 -- elementwise, as a tensor's
        return _binary(torch.eq, self, other)

    def __ne__(self, other):
        return _binary(torch.ne, self, other)

    def __ge__(self, other):
        return _binary(torch.ge, self, other)

    __hash__ = object.__hash__

    def long(self) -> "Bands":
        return self.to(torch.long)

    def detach(self) -> "Bands":
        return self._per_band(torch.Tensor.detach)

    def numel(self) -> int:
        return math.prod(self.shape)

    def sum(self, dim=None, keepdim: bool = False, dtype=None):
        """Per band over dims without H; over every dim the bands' sums
        added on the first device: a plain tensor."""
        if dim is not None and not self._hdim(dim):
            return self._per_band(lambda p: p.sum(dim, keepdim=keepdim,
                                                  dtype=dtype))
        if dim is not None:
            raise NotImplementedError(f"a sum over H but not every dim "
                                      f"{NOT_BANDED}")
        total = None
        for p in self.parts:
            s = p.sum(dtype=dtype).to(self.device)
            total = s if total is None else total + s
        return total

    # --- torch functions ----------------------------------------------------

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        handler = _HANDLERS.get(func)
        if handler is None:
            name = getattr(func, "__name__", repr(func))
            raise NotImplementedError(f"{name} {NOT_BANDED}")
        return handler(*args, **kwargs)


# --- moving rows --------------------------------------------------------------

def _bounds(starts, height: int, i: int) -> tuple[int, int]:
    """Band ``i``'s global rows under the partition ``starts``."""
    return starts[i], starts[i + 1] if i + 1 < len(starts) else height


def _rows(x: Bands, lo: int, hi: int, i: int, fill: float = 0.0
          ) -> torch.Tensor:
    """The global rows ``[lo, hi)`` of ``x`` on device ``i``: ``fill`` where
    they lie outside ``[0, H)``, the others from whichever bands hold them.
    A range inside band ``i`` is a view of it."""
    a, b = x.bounds(i)
    if a <= lo and hi <= b:
        return x.parts[i][..., lo - a:hi - a, :]
    dev = x.layout.devices[i]
    ref = x.parts[i]
    pieces = []

    def filled(n):
        return torch.full((*ref.shape[:-2], n, ref.shape[-1]), fill,
                          dtype=ref.dtype, device=dev)
    if lo < 0:
        pieces.append(filled(min(hi, 0) - lo))
    for j in range(len(x.parts)):
        a, b = x.bounds(j)
        s, e = max(lo, a), min(hi, b)
        if s < e:
            pieces.append(x.parts[j][..., s - a:e - a, :].to(dev))
    if hi > x.height:
        pieces.append(filled(hi - max(lo, x.height)))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=-2)


def _repartition(x: Bands, starts) -> Bands:
    """``x`` with the row partition ``starts``."""
    if tuple(starts) == x.starts:
        return x
    return Bands([_rows(x, *_bounds(starts, x.height, i), i)
                  for i in range(len(starts))], starts, x.height, x.layout)


def gather(x: Bands, device=None) -> torch.Tensor:
    """The whole map on ``device`` (default: the first band's)."""
    device = x.device if device is None else torch.device(device)
    return torch.cat([p.to(device) for p in x.parts], dim=-2)


def split_rows(t: torch.Tensor, devices, dim: int = -2,
               starts=None) -> list[torch.Tensor]:
    """``t``'s rows along ``dim`` cut at ``starts`` (default: equal bands)
    and each cut on its device."""
    devices = list(devices)
    height = t.shape[dim]
    if starts is None:
        starts = [i * height // len(devices) for i in range(len(devices))]
    ends = [*starts[1:], height]
    return [t.narrow(dim, s, e - s).to(dev, non_blocking=True)
            for s, e, dev in zip(starts, ends, devices)]


def bands_of(parts, layout: _Layout) -> Bands:
    """Bands from per-device NCHW row cuts, in order."""
    starts, height = [], 0
    for p in parts:
        starts.append(height)
        height += p.shape[-2]
    return Bands(parts, starts, height, layout)


# --- banded ops -----------------------------------------------------------

def _out_starts(x: Bands, stride: int, out_height: int) -> list[int]:
    return [min(-(-a // stride), out_height) for a in x.starts]


def _window(x: Bands, k: int, stride: int, padding: int, dilation: int,
            out_height: int, fill: float, fn) -> Bands:
    """A sliding-window op over H: output band ``i``'s rows from the input
    rows they read, the row padding made of ``fill`` at the global edges
    only; ``fn(rows, i)`` runs the op with no row padding on device ``i``.
    A band with no output row runs one and keeps none of it, so that its
    empty part has the right channels, width and dtype."""
    starts = _out_starts(x, stride, out_height)
    ends = [*starts[1:], out_height]
    parts = []
    for i, (oa, ob) in enumerate(zip(starts, ends)):
        n = ob - oa
        end = ob if n else oa + 1
        lo = oa * stride - padding
        hi = (end - 1) * stride - padding + dilation * (k - 1) + 1
        out = fn(_rows(x, lo, hi, i, fill), i)
        parts.append(out if n else out[..., :0, :])
    return Bands(parts, starts, out_height, x.layout)


def _conv_out(h: int, k: int, s: int, p: int, d: int) -> int:
    return (h + 2 * p - d * (k - 1) - 1) // s + 1


def _pool_out(h: int, k: int, s: int, p: int, d: int, ceil: bool) -> int:
    """``max_pool2d``'s output size, by torch's rule."""
    out = (h + 2 * p - d * (k - 1) - 1 + (s - 1 if ceil else 0)) // s + 1
    if ceil and (out - 1) * s >= h + p:
        out -= 1
    return out


def banded_conv(x: Bands, k: int, stride, padding, dilation, fn) -> Bands:
    """A conv of kernel height ``k`` over bands: ``fn(rows, i,
    padding=(0, pw))`` convolves one band's rows on device ``i``."""
    (sh, _), (ph, pw), (dh, _) = _pair(stride), _pair(padding), \
        _pair(dilation)
    out_h = _conv_out(x.height, k, sh, ph, dh)
    return _window(x, k, sh, ph, dh, out_h, 0.0,
                   lambda rows, i: fn(rows, i, (0, pw)))


def _conv2d(input, weight, bias=None, stride=1, padding=0, dilation=1,
            groups=1):
    if isinstance(padding, str):
        raise NotImplementedError(f"conv2d padding={padding!r} "
                                  f"{NOT_BANDED}")
    lay = input.layout
    return banded_conv(
        input, weight.shape[2], stride, padding, dilation,
        lambda rows, i, pad: F.conv2d(rows, lay.on(weight, i),
                                      lay.on(bias, i), stride, pad,
                                      dilation, groups))


def _max_pool2d(input, kernel_size, stride=None, padding=0, dilation=1,
                ceil_mode=False, return_indices=False):
    if return_indices:
        raise NotImplementedError(f"max_pool2d's indices {NOT_BANDED}")
    (kh, kw) = _pair(kernel_size)
    (sh, sw) = _pair(stride if stride not in (None, ()) else kernel_size)
    (ph, pw), (dh, dw) = _pair(padding), _pair(dilation)
    out_h = _pool_out(input.height, kh, sh, ph, dh, ceil_mode)
    return _window(
        input, kh, sh, ph, dh, out_h, -math.inf,
        lambda rows, i: F.max_pool2d(rows, (kh, kw), (sh, sw), (0, pw),
                                     (dh, dw), ceil_mode))


def _row_taps(in_h: int, out_rows: torch.Tensor, out_h: int,
              antialias: bool, dtype: torch.dtype):
    """(taps, rows) input-row indices and weights of the output rows
    ``out_rows`` of a bilinear resize of the height ``in_h`` to ``out_h``,
    half-pixel centres, in ``dtype``, as torch's kernels compute them: the
    plain kernel's two taps clamped at the global edges, or, with
    ``antialias``, the triangle widened by the shrink factor and
    normalized."""
    scale = torch.tensor(in_h, dtype=dtype) / out_h
    o = out_rows.to(dtype)
    if not antialias:
        src = (scale * (o + 0.5) - 0.5).clamp(min=0)
        h0 = src.long()
        h1 = h0 + (h0 < in_h - 1).long()
        l1 = src - h0.to(dtype)
        return torch.stack([h0, h1]), torch.stack([1 - l1, l1])
    support = scale if scale >= 1 else torch.ones((), dtype=dtype)
    invscale = 1 / scale if scale >= 1 else torch.ones((), dtype=dtype)
    center = scale * (o + 0.5)
    xmin = (center - support + 0.5).long().clamp(min=0)
    xmax = (center + support + 0.5).long().clamp(max=in_h)
    n = int((xmax - xmin).max())
    j = torch.arange(n)[:, None]
    w = (1 - ((j + xmin - center + 0.5) * invscale).abs()).clamp(min=0)
    w = torch.where(j < (xmax - xmin), w, torch.zeros((), dtype=dtype))
    total = w.sum(0)
    w = torch.where(total != 0, w / total, w)
    idx = torch.minimum(j + xmin, torch.tensor(in_h - 1))
    return idx, w


def _interpolate(input, size=None, scale_factor=None, mode="nearest",
                 align_corners=None, recompute_scale_factor=None,
                 antialias=False):
    if mode != "bilinear" or align_corners or size is None:
        raise NotImplementedError(f"interpolate mode={mode!r}, align_corners"
                                  f"={align_corners}, size={size} "
                                  f"{NOT_BANDED}")
    out_h, out_w = (int(v) for v in _pair(size))
    x, lay = input, input.layout
    starts = lay.partitions.get(out_h) or [
        min(-(-a * out_h // x.height), out_h) for a in x.starts]
    ends = [*starts[1:], out_h]
    acc = torch.promote_types(x.dtype, torch.float32)
    parts = []
    for i, (oa, ob) in enumerate(zip(starts, ends)):
        n = ob - oa
        rows = torch.arange(oa, ob if n else oa + 1)
        rows = rows.clamp(max=out_h - 1)
        idx, w = _row_taps(x.height, rows, out_h, antialias, acc)
        lo, hi = int(idx.min()), int(idx.max()) + 1
        src = _rows(x, lo, hi, i).to(acc)
        dev = lay.devices[i]
        idx, w = (idx - lo).to(dev), w.to(dev)
        tmp = None
        for t in range(idx.shape[0]):
            term = src.index_select(-2, idx[t]) * w[t][:, None]
            tmp = term if tmp is None else tmp + term
        if out_w != x.shape[-1]:
            tmp = F.interpolate(tmp, size=(tmp.shape[-2], out_w),
                                mode="bilinear", align_corners=False,
                                antialias=antialias)
        out = tmp.to(x.dtype)
        parts.append(out if n else out[..., :0, :])
    return Bands(parts, starts, out_h, lay)


def _binary(fn, a, b):
    """``fn(a, b)`` band by band: two maps on one partition, or a map and a
    number or a tensor that does not vary along H."""
    x = a if isinstance(a, Bands) else b
    if isinstance(a, Bands) and isinstance(b, Bands):
        b = _repartition(b, a.starts)
        return a._like([fn(p, q) for p, q in zip(a.parts, b.parts)])
    other = b if x is a else a
    parts = []
    for i, p in enumerate(x.parts):
        o = _plain_on(x, other, i)
        parts.append(fn(p, o) if x is a else fn(o, p))
    return x._like(parts)


def _unary(fn):
    def run(input, *args, **kwargs):
        return input._per_band(lambda p: fn(p, *args, **kwargs))
    return run


def _softmax(fn):
    def run(input, dim=None, *args, **kwargs):
        input._below_rows(dim, "softmax")
        return input._per_band(lambda p: fn(p, dim, *args, **kwargs))
    return run


def _cat(tensors, dim=0):
    first = tensors[0]
    first._below_rows(dim, "cat")
    tensors = [_repartition(t, first.starts) for t in tensors]
    return first._like([torch.cat([t.parts[i] for t in tensors], dim=dim)
                        for i in range(len(first.parts))])


def _batch_norm(input, running_mean, running_var, weight=None, bias=None,
                training=False, momentum=0.1, eps=1e-5):
    if training:
        return _batch_norm_train(input, running_mean, running_var, weight,
                                 bias, momentum, eps)
    lay = input.layout
    return input._like([
        F.batch_norm(p, lay.on(running_mean, i), lay.on(running_var, i),
                     lay.on(weight, i), lay.on(bias, i), False, momentum,
                     eps) for i, p in enumerate(input.parts)])


def _batch_norm_train(x: Bands, running_mean, running_var, weight, bias,
                      momentum, eps) -> Bands:
    """Train-mode batch norm with the whole batch's statistics over the
    bands (see the module docstring) and, under the data axis, over its
    ranks' bands: each sum of the bands is all-reduced over the data group
    (``parallel/distributed.py:summed_over_ranks``, whose backward sums the
    gradients alike) and the count is the global batch's.  The running
    statistics, when given, advance by ``momentum`` as ``F.batch_norm``'s
    do, the variance unbiased by the global count."""
    from rtsds_tpu_torch.parallel.distributed import (
        global_count, summed_over_ranks)

    lay, dev = x.layout, x.device
    acc = torch.promote_types(x.dtype, torch.float32)
    dims = [0] + list(range(2, x.ndim))
    view = [1, x.shape[1]] + [1] * (x.ndim - 2)
    count = global_count(x.numel() // x.shape[1])
    mean = summed_over_ranks(
        sum(p.to(acc).sum(dims).to(dev) for p in x.parts)) / count
    means = [lay.on(mean, i).view(view) for i in range(len(x.parts))]
    centred = [p.to(acc) - m for p, m in zip(x.parts, means)]
    sq = summed_over_ranks(sum((c * c).sum(dims).to(dev) for c in centred))
    invstd = torch.rsqrt(sq / count + eps)
    if running_mean is not None:
        with torch.no_grad():
            running_mean.mul_(1.0 - momentum).add_(
                mean.detach().to(running_mean.dtype), alpha=momentum)
            running_var.mul_(1.0 - momentum).add_(
                (sq.detach() / max(count - 1, 1)).to(running_var.dtype),
                alpha=momentum)
    parts = []
    for i, (p, c) in enumerate(zip(x.parts, centred)):
        y = c * lay.on(invstd, i).view(view)
        if weight is not None:
            y = y * lay.on(weight, i).to(acc).view(view)
        if bias is not None:
            y = y + lay.on(bias, i).to(acc).view(view)
        parts.append(y.to(p.dtype))
    return x._like(parts)


def _cross_entropy(input, target, weight=None, size_average=None,
                   ignore_index=-100, reduce=None, reduction="mean",
                   label_smoothing=0.0):
    """The cross entropy of banded logits against banded labels: each
    band's summed loss, added on the first device, over the count of valid
    pixels (``mean``) or alone (``sum``)."""
    if weight is not None or label_smoothing or size_average is not None \
            or reduce is not None or reduction not in ("mean", "sum"):
        raise NotImplementedError(f"cross_entropy with weight, smoothing "
                                  f"or reduction={reduction!r} "
                                  f"{NOT_BANDED}")
    target = _repartition(target, input.starts)
    total = sum(F.cross_entropy(p, t, ignore_index=ignore_index,
                                reduction="sum").to(input.device)
                for p, t in zip(input.parts, target.parts))
    if reduction == "sum":
        return total
    return total / (target != ignore_index).sum().to(total.dtype)


def _plain_on(first, t, i: int):
    """A plain operand of a banded op on band ``i``'s device: a number, or
    a tensor that does not vary along the rows of ``first``."""
    if not isinstance(t, torch.Tensor):
        return t
    row_dim = 1 if isinstance(first, FrameBands) else -2
    if t.dim() >= (4 if row_dim == 1 else 2) and t.shape[row_dim] != 1:
        raise NotImplementedError(f"a plain tensor of shape "
                                  f"{tuple(t.shape)} varies along H and "
                                  f"{NOT_BANDED}")
    return first.layout.on(t, i)


def _on_partition(t, starts):
    """A banded map or batch on the row partition ``starts``; anything else
    as it is."""
    if isinstance(t, Bands):
        return _repartition(t, starts)
    if isinstance(t, FrameBands) and t.starts != tuple(starts):
        return _repartition(t.permute(0, 3, 1, 2), starts).permute(
            0, 2, 3, 1)
    return t


def _where(condition, input=None, other=None):  # noqa: A002
    """``torch.where`` band by band: every banded operand (maps or NHWC
    batches alike) on the partition of the first."""
    args = (condition, input, other)
    first = next(a for a in args if isinstance(a, (Bands, FrameBands)))
    args = [_on_partition(a, first.starts) for a in args]
    return first._like([
        torch.where(*[a.parts[i] if isinstance(a, (Bands, FrameBands))
                      else _plain_on(first, a, i) for a in args])
        for i in range(len(first.parts))])


def _full_like(input, fill_value, **kwargs):  # noqa: A002
    return input._per_band(lambda p: torch.full_like(p, fill_value,
                                                     **kwargs))


def _getitem(t, key):
    """A plain (small) tensor indexed by a banded map of indices: a lookup
    table read band by band, on each band's device."""
    if not isinstance(t, torch.Tensor) or not isinstance(key, Bands):
        raise NotImplementedError(f"indexing a banded map {NOT_BANDED}")
    return key._like([key.layout.on(t, i)[p]
                      for i, p in enumerate(key.parts)])


def _adaptive_avg_pool2d(input, output_size):  # noqa: A002
    """Adaptive average pooling over bands, by torch's windows: output row
    ``o`` averages the global input rows ``[floor(o * H / OH), ceil((o + 1)
    * H / OH))``.  To the map's own height each band pools its own rows
    (exactly ``F.adaptive_avg_pool2d``'s); to another height each output
    band reads the rows its windows span from whichever bands hold them,
    averages them over the rows in at least float32, then pools the width
    with torch's kernel."""
    x, lay = input, input.layout
    out_h, out_w = (int(v) for v in _pair(output_size))
    if out_h == x.height:
        return x._per_band(
            lambda p: F.adaptive_avg_pool2d(p, (p.shape[-2], out_w))
            if p.shape[-2] else p[..., :0].new_zeros((*p.shape[:-1], out_w)))
    starts = lay.partitions.get(out_h) or [
        min(-(-a * out_h // x.height), out_h) for a in x.starts]
    ends = [*starts[1:], out_h]
    acc = torch.promote_types(x.dtype, torch.float32)
    parts = []
    for i, (oa, ob) in enumerate(zip(starts, ends)):
        n = ob - oa  # a band with no output row pools one and keeps none
        rows = torch.arange(oa, ob if n else oa + 1).clamp(max=out_h - 1)
        lo_row = (rows * x.height) // out_h
        hi_row = -((-(rows + 1) * x.height) // out_h)
        lo, hi = int(lo_row.min()), int(hi_row.max())
        src = _rows(x, lo, hi, i).to(acc)
        j = torch.arange(lo, hi)[None, :]
        inside = (j >= lo_row[:, None]) & (j < hi_row[:, None])
        w = inside.to(acc) / (hi_row - lo_row)[:, None].to(acc)
        tmp = torch.einsum("oh,nchw->ncow", w.to(src.device), src)
        out = F.adaptive_avg_pool2d(tmp, (tmp.shape[-2], out_w)).to(x.dtype)
        parts.append(out if n else out[..., :0, :])
    return Bands(parts, starts, out_h, lay)


_HANDLERS = {
    F.conv2d: _conv2d,
    F.max_pool2d: _max_pool2d,
    F.interpolate: _interpolate,
    F.batch_norm: _batch_norm,
    F.cross_entropy: _cross_entropy,
    F.relu: _unary(F.relu),
    torch.relu: _unary(torch.relu),
    F.leaky_relu: _unary(F.leaky_relu),
    torch.sigmoid: _unary(torch.sigmoid),
    torch.softmax: _softmax(torch.softmax),
    F.softmax: _softmax(F.softmax),
    torch.log_softmax: _softmax(torch.log_softmax),
    F.log_softmax: _softmax(F.log_softmax),
    torch.cat: _cat,
    torch.where: _where,
    torch.full_like: _full_like,
    torch.Tensor.__getitem__: _getitem,
    F.adaptive_avg_pool2d: _adaptive_avg_pool2d,
}


class FrameBands:
    """NHWC frames split by rows over devices (``parts[i]`` the global rows
    ``[starts[i], starts[i + 1])``), as a training or validation batch
    arrives: ``permute(0, 3, 1, 2)`` gives the NCHW :class:`Bands` a model
    takes, and ``to`` casts each band."""

    def __init__(self, parts, starts, height: int, layout: _Layout):
        self.parts = list(parts)
        self.starts = tuple(int(s) for s in starts)
        self.height = int(height)
        self.layout = layout

    @property
    def shape(self) -> torch.Size:
        s = list(self.parts[0].shape)
        s[1] = self.height
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.layout.devices[0]

    @property
    def ndim(self) -> int:
        return self.parts[0].dim()

    def _like(self, parts) -> "FrameBands":
        return FrameBands(parts, self.starts, self.height, self.layout)

    def _per_band(self, fn) -> "FrameBands":
        return self._like([fn(p) for p in self.parts])

    def to(self, *args, **kwargs) -> "FrameBands":
        if "device" in kwargs or any(isinstance(a, (torch.device, str))
                                     for a in args):
            raise NotImplementedError("a banded batch stays on its "
                                      "devices; gather it first")
        return self._per_band(lambda p: p.to(*args, **kwargs))

    def __getitem__(self, key) -> "FrameBands":
        if not isinstance(key, slice):
            raise NotImplementedError(f"indexing banded frames with "
                                      f"{key!r} {NOT_BANDED} (batch slices "
                                      f"only)")
        return self._per_band(lambda p: p[key])

    def cut(self, frames: torch.Tensor) -> "FrameBands":
        """Whole NHWC ``frames`` (on the first band's device) cut at these
        bands' rows, each cut on its band's device."""
        return self._like(split_rows(frames, self.layout.devices, dim=1,
                                     starts=self.starts))

    def permute(self, *dims) -> Bands:
        if tuple(dims) != (0, 3, 1, 2):
            raise NotImplementedError(f"permute{tuple(dims)} of banded "
                                      f"frames {NOT_BANDED}")
        return Bands([p.permute(0, 3, 1, 2) for p in self.parts],
                     self.starts, self.height, self.layout)

    def gather(self, device=None) -> torch.Tensor:
        device = self.device if device is None else torch.device(device)
        return torch.cat([p.to(device) for p in self.parts], dim=1)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func is torch.where:  # ClassMix's paste of source frames
            return _where(*args, **(kwargs or {}))
        name = getattr(func, "__name__", repr(func))
        raise NotImplementedError(f"{name} of banded frames {NOT_BANDED}")


def split_batch(images: torch.Tensor, labels: torch.Tensor, devices
                ) -> tuple[FrameBands, Bands]:
    """A batch of NHWC ``images`` and (N, H, W) ``labels`` on one device ->
    their bands of rows over ``devices`` (equal bands; a band may be
    empty at a deep level), on a fresh layout: ``(frames, labels)``."""
    layout = _Layout(devices)
    height = images.shape[1]
    n = len(layout.devices)
    starts = [i * height // n for i in range(n)]
    frames = FrameBands(split_rows(images, layout.devices, dim=1,
                                   starts=starts), starts, height, layout)
    bands = Bands(split_rows(labels, layout.devices, dim=-2, starts=starts),
                  starts, height, layout)
    return frames, bands


class BandedBatches:
    """``batches`` of ``(images, labels)`` on the first device, each split
    into bands over ``devices`` (:func:`split_batch`) as it is drawn;
    ``close`` closes ``batches``."""

    def __init__(self, batches, devices):
        self.batches = batches
        self.devices = list(devices)
        self._it = None

    def __iter__(self):
        self._it = iter(self.batches)
        return self

    def __next__(self):
        if self._it is None:
            self._it = iter(self.batches)
        images, labels = next(self._it)
        return split_batch(images, labels, self.devices)

    def close(self) -> None:
        close = getattr(self.batches, "close", None)
        if close is not None:
            close()


class MicroBatches(list):
    """K micro-batches of one banded batch (each a batch slice of every
    band), stacked as a (K, micro, ...) batch is: ``shape``, ``device`` and
    ``numel`` are the stack's."""

    @property
    def shape(self) -> torch.Size:
        return torch.Size((len(self), *self[0].shape))

    @property
    def device(self) -> torch.device:
        return self[0].device

    def numel(self) -> int:
        return len(self) * self[0].numel()


def split_micro_batches(batch, k: int) -> MicroBatches:
    """A banded batch (maps or NHWC frames) of ``k * micro`` frames -> its
    ``k`` micro-batches of ``micro`` consecutive frames, each banded on the
    same rows."""
    n = batch.shape[0]
    if n % k:
        raise ValueError(f"batch {n} does not split into {k} micro-batches")
    m = n // k
    return MicroBatches(batch[i * m:(i + 1) * m] for i in range(k))


def take_rows(x: Bands, rows: torch.Tensor) -> Bands:
    """The global rows ``rows`` (one source row per output row, as a
    nearest resize picks them) of a banded map: each output band gathers
    its rows from whichever bands hold them, on the partition met before
    at the output height (else bands in proportion to the input's)."""
    out_h = int(rows.shape[0])
    lay = x.layout
    starts = lay.partitions.get(out_h) or [
        min(-(-a * out_h // x.height), out_h) for a in x.starts]
    ends = [*starts[1:], out_h]
    parts = []
    for i, (oa, ob) in enumerate(zip(starts, ends)):
        n = ob - oa
        src = rows[oa:ob] if n else rows[min(oa, out_h - 1)][None]
        lo, hi = int(src.min()), int(src.max()) + 1
        band = _rows(x, lo, hi, i).index_select(
            -2, (src - lo).to(lay.devices[i]))
        parts.append(band if n else band[..., :0, :])
    return Bands(parts, starts, out_h, lay)


def banded_walk(walk, ops, kernel_h: dict, x: Bands):
    """An int8 model's conv walk (``walk(op, x)``, a
    :class:`~rtsds_tpu_torch.ops.quant.QuantizedSegmentor`'s) on banded
    input: each conv a :func:`banded_conv` whose band ``i`` runs ``ops[i]``
    (the quantized convs on device ``i``), ``kernel_h`` each conv's kernel
    height; outside autocast, in bf16, as the walk runs on one device."""
    def op(name, h, stride, padding, dilation):
        if not isinstance(h, Bands):
            return ops[0](name, h, stride, padding, dilation)
        return banded_conv(
            h, kernel_h[name], stride, padding, dilation,
            lambda rows, i, pad: ops[i](name, rows, stride, pad, dilation))

    with torch.autocast(device_type=x.device.type, enabled=False):
        return walk(op, x.to(torch.bfloat16))


def banded_hist(labels: Bands, preds: Bands, num_classes: int
                ) -> torch.Tensor:
    """The confusion matrix of banded labels and predictions: the
    confusion-matrix kernel (K1) on each band's device, the matrices summed
    on the first device; a band with no row adds nothing."""
    from rtsds_tpu_torch.ops.cuda.hist import fast_hist_cuda

    preds = _repartition(preds, labels.starts)
    total = None
    for lab, pred in zip(labels.parts, preds.parts):
        if lab.numel() == 0:
            continue
        h = fast_hist_cuda(lab, pred, num_classes).to(labels.device)
        total = h if total is None else total + h
    return total


def gathered(t) -> torch.Tensor:
    """``t`` whole on its first device: a banded map or batch gathered, a
    tensor as it is."""
    if isinstance(t, (Bands, FrameBands)):
        return gather(t) if isinstance(t, Bands) else t.gather()
    return t


class SpatialModel:
    """A model's eval forward on :class:`Bands`, one replica per device of
    ``devices`` (``replicas[i]`` on ``devices[i]``): a float model's own
    ``forward`` (its weights on each band's device are its replica's), or
    an int8 :class:`~rtsds_tpu_torch.ops.quant.QuantizedSegmentor`'s walk
    with a banded conv ``op`` over each replica's quantized convs."""

    def __init__(self, replicas, devices):
        self.replicas = list(replicas)
        self.devices = [torch.device(d) for d in devices]
        first = self.replicas[0]
        self._copies = {}
        named = [dict(r.state_dict(keep_vars=True)) for r in self.replicas]
        for name, t in named[0].items():
            self._copies[(t.data_ptr(), t.dtype, tuple(t.shape))] = {
                i: n[name] for i, n in enumerate(named)}
        from rtsds_tpu_torch.ops.quant import (
            QuantizedSegmentor, kernel_heights, make_quant_op)
        self.int8 = isinstance(first, QuantizedSegmentor)
        if self.int8:
            self._ops = [make_quant_op(r.qtree) for r in self.replicas]
            self._kernel_h = kernel_heights(first.qtree)
        self.compute_dtype = getattr(first, "compute_dtype", None)

    def layout(self) -> _Layout:
        """A fresh layout over the devices, with the replicas' weights."""
        return _Layout(self.devices, self._copies)

    def __call__(self, x: Bands) -> Bands:
        if not self.int8:
            return self.replicas[0](x)
        return banded_walk(self.replicas[0]._walk, self._ops, self._kernel_h,
                           x)
