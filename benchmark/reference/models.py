"""The reference's networks, found by the module name a configuration
gives (``benchmark/reference/<name>.py``, with ``build(classes)`` and,
where the recipe keeps parameters still, ``frozen(model)``)."""

from __future__ import annotations

import importlib

import torch


def _module(name: str):
    return importlib.import_module(f"benchmark.reference.{name}")


def network(name: str, classes: int, device="meta"):
    with torch.device(device):
        return _module(name).build(classes)


def frozen_names(name: str, model) -> frozenset:
    """Parameters that the configuration's recipe does not train."""
    frozen = getattr(_module(name), "frozen", None)
    return frozenset(frozen(model)) if frozen else frozenset()


def loaded(model, state: dict, device):
    """``model`` (on ``meta``) materialized on ``device`` with ``state``
    in float32."""
    model = model.to_empty(device=device)
    model.load_state_dict({k: v.float() if v.is_floating_point() else v
                           for k, v in state.items()})
    return model
