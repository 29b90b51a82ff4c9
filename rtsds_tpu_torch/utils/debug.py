"""Debug mode (``--debug``): stop at the first non-finite value.

``enable_debug()`` switches on, each undone by :func:`disable_debug`:

* ``nans``: autograd's anomaly mode with its NaN check (a backward that
  produces a NaN raises, naming the forward op whose gradient it was), and
  a forward hook on every module that raises ``FloatingPointError`` on
  the first non-finite floating output, naming the module (by its name in
  a model passed to :func:`name_modules`, else its class).  Each check
  reads the value on the host, so debug mode runs slowly;
* ``disable_optimizations``: TF32 off in cuBLAS and cuDNN and float32
  matmuls at ``"highest"`` precision, for bisecting a numerical fault;
* ``disable_jit``: nothing to turn off, since the port runs eagerly (the
  JAX package's switch turns off ``jax.jit``).
"""

from __future__ import annotations

import weakref

import torch
from torch import nn

_NAMES: "weakref.WeakKeyDictionary[nn.Module, str]" = \
    weakref.WeakKeyDictionary()
_state: dict = {}


def name_modules(model: nn.Module, prefix: str = "") -> nn.Module:
    """Let the non-finite check name ``model``'s submodules by their
    qualified names (``ffm.convblock.conv``), after ``prefix``."""
    for name, module in model.named_modules():
        _NAMES[module] = prefix + name if name else (
            prefix.rstrip(".") or type(model).__name__)
    return model


def _tensors(value):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)


def _raise_on_nonfinite(module: nn.Module, inputs, output) -> None:
    for t in _tensors(output):
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            name = _NAMES.get(module, type(module).__name__)
            raise FloatingPointError(
                f"debug: non-finite output of module {name!r} "
                f"({type(module).__name__}, shape {tuple(t.shape)})")


def enable_debug(nans: bool = True, disable_jit: bool = False,
                 disable_optimizations: bool = False) -> None:
    if nans and "hook" not in _state:
        _state["anomaly"] = (torch.is_anomaly_enabled(),
                             torch.is_anomaly_check_nan_enabled())
        torch.autograd.set_detect_anomaly(True, check_nan=True)
        _state["hook"] = nn.modules.module.register_module_forward_hook(
            _raise_on_nonfinite)
    if disable_optimizations and "precision" not in _state:
        _state["precision"] = (torch.backends.cuda.matmul.allow_tf32,
                               torch.backends.cudnn.allow_tf32,
                               torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")


def disable_debug() -> None:
    """Undo :func:`enable_debug`: the hook removed and the anomaly mode
    and the matmul precision restored to what they were."""
    if "hook" in _state:
        _state.pop("hook").remove()
        enabled, check_nan = _state.pop("anomaly")
        torch.autograd.set_detect_anomaly(enabled, check_nan=check_nan)
    if "precision" in _state:
        matmul, cudnn, precision = _state.pop("precision")
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(precision)
