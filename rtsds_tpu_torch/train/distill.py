"""Knowledge distillation: a frozen teacher's soft classes guide the student.

Counterpart of ``rtsds_tpu/train/distill.py`` (Hinton et al. 2015).  The
loss is ``alpha * CE + (1 - alpha) * KL_T``: the student's main and
auxiliary cross entropy on the labels, and the temperature-scaled KL
divergence of the student's main output from the teacher's, over every
pixel.  The teacher (typically DeepLabV2-R101, distilled into BiSeNet) runs
in eval mode without gradients.

:func:`load_teacher` (:func:`rtsds_tpu_torch.serve.load_checkpoint_state`)
reads a teacher's weights from the port's own checkpoints or from a state
dict that ``export_torch`` wrote; :func:`quantize_teacher` makes the W8A8
int8 teacher of them.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from rtsds_tpu_torch.ops.losses import global_mean, segmentation_loss
from rtsds_tpu_torch.parallel.distributed import reduce_metrics
from rtsds_tpu_torch.ops.quant import quantize_model
from rtsds_tpu_torch.serve import load_checkpoint_state
from rtsds_tpu_torch.train.state import TrainState
from rtsds_tpu_torch.train.supervised import check_batch
from rtsds_tpu_torch.utils.dtypes import at_least_f32, model_dtype


def distillation_kl(student_logits: torch.Tensor,
                    teacher_logits: torch.Tensor,
                    temperature: float = 2.0) -> torch.Tensor:
    """Mean over pixels of KL(teacher_T || student_T) x T^2, of (N, C, H, W)
    logits, in at least float32.  Every pixel counts, ignored ones too;
    under the data axis the mean runs over the global batch's pixels
    (``ops/losses.py:global_mean``)."""
    t = at_least_f32(teacher_logits) / temperature
    s = at_least_f32(student_logits) / temperature
    log_t = F.log_softmax(t, dim=1)
    kl = (log_t.exp() * (log_t - F.log_softmax(s, dim=1))).sum(dim=1)
    return global_mean(kl) * temperature ** 2


def make_distill_step(teacher: nn.Module, ignore_index: int | None = 19, *,
                      temperature: float = 2.0, alpha: float = 0.5
                      ) -> Callable:
    """``train_step(state, images, labels) -> metrics``, the supervised
    step's signature: the teacher's eval-mode forward under ``no_grad``,
    the student's train-mode forward, ``alpha * CE + (1 - alpha) * KL_T``
    on the main head, backward, one optimizer step.  The metrics:
    ``train_loss``, ``loss_ce``, ``loss_distill``, ``correct``, ``total``.
    ``alpha = 1`` is the supervised step.  Under the data axis the
    metrics come back summed over the ranks, as the supervised step's do.
    The teacher's input is cast to
    its ``compute_dtype`` when it declares one (the int8 teacher of
    :func:`quantize_teacher`, whose walk runs outside autocast in bf16),
    else to its first parameter's dtype."""
    teacher.eval()
    for p in teacher.parameters():
        p.requires_grad_(False)

    def train_step(state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor) -> dict:
        check_batch(state.model, images)
        x = images.permute(0, 3, 1, 2)
        with torch.no_grad(), state.autocast():
            t_out = teacher(x.to(model_dtype(teacher)))
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
        return reduce_metrics({"train_loss": loss.detach(),
                               "loss_ce": ce.detach(),
                               "loss_distill": kd.detach(),
                               "correct": correct, "total": labels.numel()})

    return train_step


def quantize_teacher(teacher_name: str, teacher_state, calib_batches,
                     policy=None, device=None):
    """W8A8-quantize the frozen distillation teacher.

    The teacher's forward is a pure eval-mode inference run every step,
    the serving profile of the PTQ pipeline (``ops/quant.py``), while the
    student stays full precision.  ``teacher_state``: the teacher's float32
    state dict; ``calib_batches``: (N, 3, H, W) image batches after the
    production preprocess, on ``device`` (the distribution the teacher will
    see in the step; under the data axis this rank's shards of the first
    global batches, whose bounds ``ops/quant.py:abs_bound`` takes over the
    ranks).  Under the spatial axis the CLI gathers each banded batch on
    the first band's device first: the calibration sees the frames the
    one-device run sees, so its scales are the same, and the teacher then
    runs its walk on the bands (``ops/quant.py:QuantizedSegmentor``).
    Returns the :class:`~rtsds_tpu_torch.ops.quant.QuantizedSegmentor`, a
    drop-in ``teacher`` for :func:`make_distill_step`."""
    return quantize_model(teacher_name, teacher_state, calib_batches,
                          policy=policy, device=device)


# a teacher's weights are read as served weights are: the best epoch, else
# the latest, its ``ema`` item preferred, or an ``export_torch`` file
load_teacher = load_checkpoint_state
