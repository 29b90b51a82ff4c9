"""Knowledge distillation: a frozen teacher's soft classes guide the student.

Counterpart of ``rtsds_tpu/train/distill.py`` (Hinton et al. 2015).  The
loss is ``alpha * CE + (1 - alpha) * KL_T``: the student's main and
auxiliary cross entropy on the labels, and the temperature-scaled KL
divergence of the student's main output from the teacher's, over every
pixel.  The teacher (typically DeepLabV2-R101, distilled into BiSeNet) runs
in eval mode without gradients.

:func:`load_teacher` reads a teacher's weights from the port's own
checkpoints or from a state dict that ``python -m rtsds_tpu.export_torch``
wrote from a JAX-trained checkpoint.
"""

from __future__ import annotations

import os
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from rtsds_tpu_torch.callbacks.checkpoint import CheckpointManager
from rtsds_tpu_torch.models.pretrained import state_dict_from_reference
from rtsds_tpu_torch.ops.losses import segmentation_loss
from rtsds_tpu_torch.train.state import TrainState
from rtsds_tpu_torch.train.supervised import check_batch
from rtsds_tpu_torch.utils.dtypes import at_least_f32


def distillation_kl(student_logits: torch.Tensor,
                    teacher_logits: torch.Tensor,
                    temperature: float = 2.0) -> torch.Tensor:
    """Mean over pixels of KL(teacher_T || student_T) x T^2, of (N, C, H, W)
    logits, in at least float32.  Every pixel counts, ignored ones too."""
    t = at_least_f32(teacher_logits) / temperature
    s = at_least_f32(student_logits) / temperature
    log_t = F.log_softmax(t, dim=1)
    kl = (log_t.exp() * (log_t - F.log_softmax(s, dim=1))).sum(dim=1)
    return kl.mean() * temperature ** 2


def make_distill_step(teacher: nn.Module, ignore_index: int | None = 19, *,
                      temperature: float = 2.0, alpha: float = 0.5
                      ) -> Callable:
    """``train_step(state, images, labels) -> metrics``, the supervised
    step's signature: the teacher's eval-mode forward under ``no_grad``,
    the student's train-mode forward, ``alpha * CE + (1 - alpha) * KL_T``
    on the main head, backward, one optimizer step.  The metrics:
    ``train_loss``, ``loss_ce``, ``loss_distill``, ``correct``, ``total``.
    ``alpha = 1`` is the supervised step."""
    teacher.eval()
    for p in teacher.parameters():
        p.requires_grad_(False)

    def train_step(state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor) -> dict:
        check_batch(state.model, images)
        x = images.permute(0, 3, 1, 2)
        with torch.no_grad(), state.autocast():
            t_out = teacher(x.to(next(teacher.parameters()).dtype))
        if isinstance(t_out, (tuple, list)):
            t_out = t_out[0]
        model = state.model.train()
        with state.autocast():
            outputs = model(x)
            ce = segmentation_loss(outputs, labels, ignore_index)
            main = outputs[0] if isinstance(outputs, (tuple, list)) \
                else outputs
            kd = distillation_kl(main, t_out, temperature)
            loss = alpha * ce + (1.0 - alpha) * kd
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        with torch.no_grad():
            correct = (main.argmax(dim=1) == labels).sum()
        return {"train_loss": loss.detach(), "loss_ce": ce.detach(),
                "loss_distill": kd.detach(), "correct": correct,
                "total": labels.numel()}

    return train_step


def load_teacher(source: str, use_ema: bool = True
                 ) -> dict[str, torch.Tensor]:
    """A trained segmentor's state dict (parameters and BN buffers), on the
    CPU, from ``source``:

    * a directory of the port's checkpoints (``callbacks/checkpoint.py``):
      the best epoch, else the latest; the ``model`` item (a supervised
      run), else ``generator`` (domain adaptation); its parameters replaced
      by the ``ema`` item's when ``use_ema`` and the checkpoint holds one;
    * a file written by ``python -m rtsds_tpu.export_torch`` (any of its
      ``--model`` layouts; ``--prefix`` stripped), which already holds the
      EMA weights unless it was exported with ``--no-ema``.

    Load the result into the model with
    :func:`rtsds_tpu_torch.models.pretrained.load_segmentor_state`.
    """
    if os.path.isfile(source):
        state = torch.load(source, map_location="cpu", weights_only=True)
        return state_dict_from_reference(state)
    if not os.path.isdir(source):
        raise FileNotFoundError(f"distillation teacher: no checkpoint "
                                f"directory or file at {source}")
    mgr = CheckpointManager(source)
    step = mgr.best_step()
    if step is None:
        step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(
            f"distillation teacher: no checkpoints in {source}")
    payload = mgr.load(step)
    item = payload.get("model", payload.get("generator"))
    if item is None:
        raise KeyError(f"distillation teacher: epoch {step} under {source} "
                       f"holds {sorted(payload)}, neither 'model' nor "
                       f"'generator'")
    state = dict(item["model"])
    if use_ema and "ema" in payload:
        state.update(payload["ema"]["params"])
    return state
