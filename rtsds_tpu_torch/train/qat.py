"""Quantization-aware fine-tuning (QAT) over the W8A8 serving grid.

Counterpart of ``rtsds_tpu/train/qat.py``.  Take a trained model, fold its
BN and calibrate the activation scales exactly as int8 serving does, then
fine-tune the FOLDED weights with the quantizers in the forward as
straight-through estimators (``ops/quant.py:fake_quant_kernel`` and
``fake_quant_act``).  The tuned weights re-export onto the real int8
serving path with the same quantization (:func:`export_int8`: the
fake-quant grid and ``quantize_kernel``'s grid are the same by
construction), and :func:`writeback` turns them back into a state dict of
the model (convs = tuned folded kernels, each BN the exact identity
carrying the folded bias), which every serving surface reads unchanged.
The activation scales travel beside the checkpoint
(:data:`SCALES_SIDECAR`), so int8 serving uses the grid the weights were
tuned for.

BN is frozen-folded during QAT, so the written-back state is a SERVING
state: its identity BNs carry no meaningful running statistics; do not
resume batch-statistics training from it.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Iterable, Mapping, NamedTuple

import torch
from torch import nn

from rtsds_tpu_torch.device import resolve_device
from rtsds_tpu_torch.models.layers import BN_EPS
from rtsds_tpu_torch.ops.quant import (
    QuantizedSegmentor, build_quantized_net, calibrate_net, folded_on,
    int8_model_module, make_fake_quant_op)
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.state import TrainState


class QATPrep(NamedTuple):
    """What :func:`prepare_qat` derives from the trained model.  ``folded``
    is the INITIAL float32 folded tree; training evolves the copy that
    :func:`make_qat_apply` holds as parameters."""

    model_name: str
    folded: dict
    act_scales: dict
    quant_names: frozenset


def prepare_qat(model_name: str, state: Mapping, calib_batches: Iterable,
                policy: Callable | None = None, calib_stat: str = "max",
                calib_percentile: float = 99.9, device=None) -> QATPrep:
    """Fold + calibrate + select, exactly as PTQ serving would.

    ``state``: the trained model's float32 state dict; ``calib_batches``:
    (N, 3, H, W) tensors after the production preprocess, on ``device``
    (the GPU unless the caller names the CPU).  The prep carries the
    float32 folded tree on ``device``, the static activation scales the
    fine-tune trains against, and the policy's conv set."""
    q = int8_model_module(model_name)
    folded = folded_on(q.fold(state), resolve_device(device))
    scales = calibrate_net(q.make_walk(folded), folded, calib_batches,
                           stat=calib_stat, percentile=calib_percentile)
    policy = q.default_policy if policy is None else policy
    quant_names = frozenset(
        name for name, (kernel, _) in folded.items()
        if policy(name, tuple(kernel.shape)) and name in scales)
    folded = {name: (kernel.to(torch.float32),
                     None if bias is None else bias.to(torch.float32))
              for name, (kernel, bias) in folded.items()}
    return QATPrep(model_name, folded, dict(scales), quant_names)


class QATSegmentor(nn.Module):
    """The fake-quant walk as a model whose parameters are the float32
    folded tree (``kernels[name]``, ``biases[name]``): (N, 3, H, W) input
    -> (N, classes, H, W) float32 logits, in train and eval mode alike.
    The supervised step (``train/supervised.py``) drives it unchanged."""

    def __init__(self, prep: QATPrep):
        super().__init__()
        self.model_name = prep.model_name
        self.act_scales = dict(prep.act_scales)
        self.quant_names = prep.quant_names
        self.kernels = nn.ParameterDict(
            {name: nn.Parameter(kernel.detach().clone())
             for name, (kernel, _) in prep.folded.items()})
        self.biases = nn.ParameterDict(
            {name: nn.Parameter(bias.detach().clone())
             for name, (_, bias) in prep.folded.items() if bias is not None})
        self._walk = int8_model_module(prep.model_name).make_walk(
            prep.folded)

    @property
    def folded(self) -> dict:
        """The live folded tree ``{name: (kernel, bias or None)}``."""
        return {name: (kernel, self.biases[name] if name in self.biases
                       else None)
                for name, kernel in self.kernels.items()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        op = make_fake_quant_op(self.folded, self.act_scales,
                                self.quant_names)
        return self._walk(op, x.to(torch.float32))


def make_qat_apply(prep: QATPrep) -> QATSegmentor:
    """The fake-quant forward of ``prep`` as a trainable model."""
    return QATSegmentor(prep)


def create_qat_state(prep: QATPrep, learning_rate=1e-5,
                     optimizer: str = "Adam") -> TrainState:
    """A float32 :class:`~rtsds_tpu_torch.train.state.TrainState` over the
    folded tree (BN is frozen-folded by construction), ready for
    ``train/supervised.py:make_train_step``."""
    model = make_qat_apply(prep)
    return TrainState(model, make_optimizer(optimizer, model.parameters(),
                                            learning_rate))


def export_int8(prep: QATPrep, folded: dict | None = None
                ) -> QuantizedSegmentor:
    """Re-quantize the (tuned) folded tree onto the real serving path: a
    :class:`~rtsds_tpu_torch.ops.quant.QuantizedSegmentor` whose ``qtree``
    has per-channel max weights recomputed on the tuned kernels, the SAME
    static activation scales and the SAME conv selection, so its grid is
    the one the fine-tune saw."""
    folded = prep.folded if folded is None else folded
    folded = {name: (kernel.detach(), None if bias is None else bias.detach())
              for name, (kernel, bias) in folded.items()}
    qtree = build_quantized_net(folded, prep.act_scales,
                                lambda name, shape: name in prep.quant_names)
    walk = int8_model_module(prep.model_name).make_walk(folded)
    return QuantizedSegmentor(walk, qtree, prep.act_scales)


# ---------------------------------------------------------------------------
# The activation-scale sidecar: the QAT grid follows the checkpoint.
# Recalibrating the written-back weights is not the same as serving the
# scales QAT trained against: a percentile statistic clips the same
# probability mass again.
# ---------------------------------------------------------------------------

SCALES_SIDECAR = "qat_act_scales.json"


def save_act_scales(out_dir: str, prep: QATPrep, calib_stat: str,
                    calib_percentile: float) -> str:
    """Write the QAT activation scales next to the written-back
    checkpoint; ``Predictor.from_checkpoint(quantize='int8')`` reads them.
    The file's layout is the JAX package's."""
    path = os.path.join(out_dir, SCALES_SIDECAR)
    with open(path, "w") as f:
        json.dump({
            "model": prep.model_name,
            "calib_stat": calib_stat,
            "calib_percentile": calib_percentile,
            "scales": {name: float(s)
                       for name, s in prep.act_scales.items()},
        }, f, indent=1, sort_keys=True)
    return path


def load_act_scales(checkpoint_dir: str):
    """The :data:`SCALES_SIDECAR` in ``checkpoint_dir`` as ``(scales,
    meta)``, or None when there is none."""
    path = os.path.join(checkpoint_dir, SCALES_SIDECAR)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        meta = json.load(f)
    return {name: float(s) for name, s in meta.pop("scales").items()}, meta


# ---------------------------------------------------------------------------
# Write-back: the tuned folded tree -> the model's state dict.
# ---------------------------------------------------------------------------


def _identity_bn(out: dict, bn: str, bias_f: torch.Tensor) -> None:
    """A BN rewritten to the exact identity plus the folded bias: weight 1,
    running mean 0, running variance ``1 - eps`` (so ``var + eps`` is
    exactly 1 in float32) and bias ``bias_f``.  Re-folding it returns the
    folded (kernel, bias) bit for bit."""
    shape = out[f"{bn}.weight"].shape
    out[f"{bn}.weight"] = torch.ones(shape, dtype=torch.float32)
    out[f"{bn}.bias"] = bias_f.detach().to("cpu", torch.float32).clone()
    out[f"{bn}.running_mean"] = torch.zeros(shape, dtype=torch.float32)
    out[f"{bn}.running_var"] = torch.full(shape, 1.0 - BN_EPS,
                                          dtype=torch.float32)


def writeback(model_name: str, state: Mapping, folded: dict) -> dict:
    """Write a (tuned) folded tree back into the model's state dict (a new
    dict of CPU float32 tensors; ``state`` is not modified).

    Every conv weight becomes its folded kernel and its BN the identity
    carrying the folded bias, so the model's EVAL forward equals the
    folded walk and re-folding returns ``folded``.  A conv with both a bias
    and a BN (the ARM gates) gets a zero bias.  The FFM's split parts are
    concatenated back along the input channels.  Train-only tensors
    (BiSeNet's supervision heads) and BN counters pass through."""
    q = int8_model_module(model_name)
    out = {k: v.detach().to("cpu").clone() for k, v in state.items()}
    folded = dict(folded)
    if model_name == "bisenet":
        parts = [folded.pop(f"ffm/convblock:p{i}") for i in range(3)]
        folded["ffm/convblock"] = (torch.cat([k for k, _ in parts], dim=1),
                                   parts[0][1])
    for name, conv, bn in q.conv_bn_pairs(state):
        kernel, bias = folded[name]
        out[f"{conv}.weight"] = kernel.detach().to("cpu", torch.float32)
        if bn is None:
            out[f"{conv}.bias"] = bias.detach().to("cpu", torch.float32)
            continue
        if f"{conv}.bias" in out:
            out[f"{conv}.bias"] = torch.zeros_like(out[f"{conv}.bias"])
        _identity_bn(out, bn, bias)
    return out
