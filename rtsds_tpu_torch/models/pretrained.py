"""Weight bridge: the JAX package's Flax variable trees -> these modules.

A Flax tree is ``{"params": ..., "batch_stats": ...}`` of nested dicts of
numpy arrays.  Its scopes flatten torchvision's names (``layer2_1`` for
``layer2.1``, ``downsample_conv``/``downsample_bn`` for ``downsample.0/1``),
its conv kernels are HWIO where torch's are OIHW, and its BN leaves are
``scale``/``bias`` in params and ``mean``/``var`` in batch_stats.

:func:`load_deeplab_pretrained` ingests an external DeepLab checkpoint (a
torch state dict) the way the reference does.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

# Heads that a Flax tree initialised with ``train=False`` does not hold:
# Flax creates them only when the train-mode forward runs.
TRAIN_ONLY_SCOPES = ("supervision1", "supervision2")


def torch_scope(name: str) -> str:
    """One Flax scope name -> its dotted torch module path."""
    if name == "downsample_conv":
        return "downsample.0"
    if name == "downsample_bn":
        return "downsample.1"
    m = re.fullmatch(r"(layer\d+|conv2d_list)_(\d+)", name)
    if m:
        return f"{m.group(1)}.{m.group(2)}"
    return name


def _leaves(node: Mapping, path: tuple[str, ...] = ()):
    for k, v in node.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, (*path, k))
        else:
            yield path, k, np.asarray(v)


def state_dict_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """Flax variable tree -> torch state dict (CPU tensors, float32 as
    stored).  BN ``num_batches_tracked`` counters are not part of a Flax
    tree and are not emitted."""
    out: dict[str, torch.Tensor] = {}

    def key(path, leaf):
        return ".".join([*(torch_scope(p) for p in path), leaf])

    for path, leaf, arr in _leaves(variables.get("params", {})):
        if leaf == "kernel":
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            name = "weight"
        elif leaf == "scale":
            name = "weight"
        elif leaf == "bias":
            name = "bias"
        else:
            raise KeyError(f"unknown Flax parameter leaf {'/'.join(path)}/"
                           f"{leaf}")
        out[key(path, name)] = torch.tensor(arr)
    for path, leaf, arr in _leaves(variables.get("batch_stats") or {}):
        names = {"mean": "running_mean", "var": "running_var"}
        if leaf not in names:
            raise KeyError(f"unknown Flax batch_stats leaf {'/'.join(path)}/"
                           f"{leaf}")
        out[key(path, names[leaf])] = torch.tensor(arr)
    return out


def load_flax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Load a Flax variable tree into ``module`` with ``strict=True``.

    Every tensor of the module must come from the tree, except BN
    ``num_batches_tracked`` counters and the :data:`TRAIN_ONLY_SCOPES`
    heads, which a tree initialised for eval lacks: those keep the module's
    own values.  Any other missing or unexpected key raises.
    """
    state = state_dict_from_flax(variables)
    own = module.state_dict()
    missing = [k for k in own if k not in state
               and not k.endswith("num_batches_tracked")]
    if missing and all(k.split(".")[0] in TRAIN_ONLY_SCOPES
                       for k in missing):
        for k in missing:
            state[k] = own[k]
        missing = []
    if missing:
        raise KeyError(f"Flax tree lacks {len(missing)} tensors of the "
                       f"module: {missing[:8]}")
    for k, v in own.items():
        if k.endswith("num_batches_tracked"):
            state[k] = v
    module.load_state_dict(state, strict=True)
    return module


def load_deeplab_pretrained(module: nn.Module, source) -> dict:
    """Load a DeepLab checkpoint (a path to a torch state dict, or the dict)
    into ``module`` by the reference's rule: the first dotted segment of
    every key is dropped (``Scale.layer1.0.conv1.weight`` ->
    ``layer1.0.conv1.weight``), then the load is not strict: keys the
    module lacks and tensors of another shape are skipped.  BN
    ``num_batches_tracked`` counters are neither loaded nor reported.
    Prints and returns ``{"loaded": count, "skipped": [key, ...]}``."""
    state = source
    if not isinstance(source, Mapping):
        state = torch.load(source, map_location="cpu", weights_only=True)
    own = module.state_dict()
    take: dict[str, torch.Tensor] = {}
    skipped: list[str] = []
    for key, value in state.items():
        key = key.split(".", 1)[-1]
        if key.endswith("num_batches_tracked"):
            continue
        value = torch.as_tensor(value)
        if key not in own:
            skipped.append(key)
        elif tuple(value.shape) != tuple(own[key].shape):
            skipped.append(f"{key} (shape {tuple(value.shape)} vs "
                           f"{tuple(own[key].shape)})")
        else:
            take[key] = value
    module.load_state_dict(take, strict=False)
    print(f"pretrained: loaded {len(take)} tensors"
          + (f", skipped {len(skipped)}" if skipped else ""))
    return {"loaded": len(take), "skipped": skipped}
