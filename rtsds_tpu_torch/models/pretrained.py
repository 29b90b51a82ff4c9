"""Weight bridge: the JAX package's Flax variable trees -> these modules.

A Flax tree is ``{"params": ..., "batch_stats": ...}`` of nested dicts of
numpy arrays.  Its scopes flatten torchvision's names (``layer2_1`` for
``layer2.1``, ``downsample_conv``/``downsample_bn`` for ``downsample.0/1``),
its conv kernels are HWIO where torch's are OIHW, and its BN leaves are
``scale``/``bias`` in params and ``mean``/``var`` in batch_stats.

:func:`load_deeplab_pretrained` ingests an external DeepLab checkpoint (a
torch state dict) the way the reference does.  :func:`ema_from_flax` maps a
Flax ``params`` tree (an EMA) to the port's EMA dict,
:func:`state_dict_from_reference` reads back what ``export_torch`` writes,
and :func:`state_dict_to_reference` writes it.
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


def ema_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """A Flax ``params`` tree (the JAX package's ``ema`` item holds one
    under ``"params"``) -> the port's EMA dict (``train/ema.py``): the
    parameters' torch names, no buffers."""
    return state_dict_from_flax({"params": params})


def load_segmentor_state(module: nn.Module,
                         state: Mapping[str, torch.Tensor]) -> nn.Module:
    """Load a torch state dict into ``module`` with ``strict=True``.

    Every tensor of the module must come from ``state``, except BN
    ``num_batches_tracked`` counters and the :data:`TRAIN_ONLY_SCOPES`
    heads, which weights kept for evaluation may lack: those keep the
    module's own values.  Any other missing or unexpected key raises.
    """
    state = dict(state)
    own = module.state_dict()
    missing = [k for k in own if k not in state
               and not k.endswith("num_batches_tracked")]
    if missing and all(k.split(".")[0] in TRAIN_ONLY_SCOPES
                       for k in missing):
        for k in missing:
            state[k] = own[k]
        missing = []
    if missing:
        raise KeyError(f"the weights lack {len(missing)} tensors of the "
                       f"module: {missing[:8]}")
    for k, v in own.items():
        if k.endswith("num_batches_tracked") and k not in state:
            state[k] = v
    module.load_state_dict(state, strict=True)
    return module


def load_flax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Load a Flax variable tree into ``module`` with ``strict=True``, as
    :func:`load_segmentor_state` loads a state dict: train-only heads and
    BN counters, which the tree lacks, keep the module's own values."""
    return load_segmentor_state(module, state_dict_from_flax(variables))


# the reference BiSeNet's module names -> the port's (the JAX package's
# export_torch writes the reference's, including its 'saptial_path')
REFERENCE_BISENET_NAMES = {
    "saptial_path": "spatial_path",
    "attention_refinement_module1": "arm1",
    "attention_refinement_module2": "arm2",
    "feature_fusion_module": "ffm",
}


def state_dict_from_reference(state: Mapping) -> dict[str, torch.Tensor]:
    """A state dict that ``python -m rtsds_tpu.export_torch`` wrote ->
    the port's names.  A dotted prefix shared by every key (``--prefix``)
    is stripped, the reference BiSeNet's module names are mapped to the
    port's, and its ``context_path.features.*`` aliases of the context
    path's tensors are dropped.  The DeepLab and raw layouts already use
    the port's names."""
    state = {k: torch.as_tensor(v) for k, v in state.items()}
    while state:
        heads = {k.split(".", 1)[0] for k in state}
        if len(heads) != 1 or any("." not in k for k in state):
            break
        state = {k.split(".", 1)[1]: v for k, v in state.items()}
    out = {}
    for k, v in state.items():
        if k.startswith("context_path.features."):
            continue
        head, _, rest = k.partition(".")
        out[".".join([REFERENCE_BISENET_NAMES.get(head, head), rest])] = v
    return out


def state_dict_to_reference(state: Mapping, bisenet: bool = False,
                            prefix: str = "") -> dict[str, torch.Tensor]:
    """The inverse of :func:`state_dict_from_reference`: the port's state
    dict in the layout the JAX package's ``export_torch`` writes.  With
    ``bisenet`` the port's module names become the reference BiSeNet's and
    every ``context_path.*`` tensor gains its ``context_path.features.*``
    alias (a ``load_state_dict(strict=True)`` into the reference model
    demands both); ``prefix`` is prepended to every key (``"Scale."`` for
    MSCOCO-style DeepLab checkpoints).  Tensors go to the CPU."""
    to_reference = {v: k for k, v in REFERENCE_BISENET_NAMES.items()}
    out = {}
    for k, v in state.items():
        head, _, rest = k.partition(".")
        if bisenet:
            head = to_reference.get(head, head)
        out[f"{head}.{rest}"] = v.detach().cpu()
    if bisenet:
        for k in [k for k in out if k.startswith("context_path.")]:
            out["context_path.features." + k[len("context_path."):]] = out[k]
    return {prefix + k: v for k, v in out.items()}


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
