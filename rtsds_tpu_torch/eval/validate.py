"""Validation: an eval step with a device-resident confusion matrix.

The (n, n) int32 matrix stays on the device across the epoch, updated by
the confusion-matrix kernel after each batch's forward and argmax; the host
fetches it once, at the end.  ``val`` and ``val_GTA5`` are the entry points
shaped like the reference training script's.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable

import numpy as np
import torch
from torch import nn

from rtsds_tpu_torch.device import resolve_device
from rtsds_tpu_torch.ops.cuda.hist import fast_hist_cuda
from rtsds_tpu_torch.utils.dtypes import model_dtype
from rtsds_tpu_torch.utils.metrics import per_class_iou


def plain_predict(model: nn.Module) -> Callable:
    """``predict(x) -> preds``: the argmax of ``model``'s logits of (N, C,
    H, W) images, (N, H, W) class ids."""
    def predict(x):
        outputs = model(x)
        if isinstance(outputs, (tuple, list)):
            outputs = outputs[0]
        return outputs.argmax(dim=1)
    return predict


def make_eval_step(model: nn.Module, num_classes: int,
                   return_preds: bool = False,
                   compute_dtype: torch.dtype | None = None,
                   predict: Callable | None = None) -> Callable:
    """Returns ``eval_step(images, labels, hist) -> hist`` (or
    ``(hist, preds)`` with ``return_preds``, for image-plot callbacks).

    ``images`` are normalized (N, H, W, 3) floats and ``labels`` (N, H, W)
    integer ids, both on the model's device; the model must be in eval
    mode (:func:`validate` sees to it).  The returned ``hist`` is a new
    tensor: the one passed in is not modified.  ``compute_dtype`` (e.g.
    bf16 for a model trained in it) runs the forward under autocast.
    ``predict`` maps (N, 3, H, W) images in the parameters' dtype to class
    ids: :func:`plain_predict` by default, or a protocol's
    (``eval/sliding.py``, ``eval/ensemble.py``).
    """
    dtype = model_dtype(model)
    autocast = compute_dtype not in (None, dtype)
    if predict is None:
        predict = plain_predict(model)

    @torch.inference_mode()
    def eval_step(images, labels, hist):
        with (torch.autocast(device_type=images.device.type,
                             dtype=compute_dtype) if autocast
              else contextlib.nullcontext()):
            preds = predict(images.to(dtype).permute(0, 3, 1, 2))
        new_hist = hist + fast_hist_cuda(labels, preds, num_classes)
        if return_preds:
            return new_hist, preds
        return new_hist

    return eval_step


def validate(model: nn.Module, val_iter: Iterable, num_classes: int,
             class_names: list[str] | None = None, epoch: int = 0,
             callbacks: list | None = None, detailed_report: bool = False,
             eval_step=None, per_batch_callbacks: bool = False,
             device=None):
    """Run validation over an iterator of (images, labels) batches.

    The model is moved to ``device`` (``None`` means the GPU, and raises
    without one) and run in eval mode; its train/eval mode is restored at
    the end.  Returns ``(mean_iou, per_class)``, ``per_class`` being a list
    of ``(class_name, iou)`` when ``class_names`` is given.  Per-batch
    callbacks receive ``1 - running_pixel_accuracy`` and force a host fetch
    per batch, so they are off unless ``per_batch_callbacks``.
    """
    device = resolve_device(device)
    callbacks = callbacks or []
    for cb in callbacks:
        cb.on_validation_begin()

    plot_cbs = [cb for cb in callbacks if hasattr(cb, "add_sample")]
    model.to(device)
    was_training = model.training
    model.eval()
    if eval_step is None:
        eval_step = make_eval_step(model, num_classes,
                                   return_preds=bool(plot_cbs))

    try:
        hist = torch.zeros((num_classes, num_classes), dtype=torch.int32,
                           device=device)
        for batch_idx, (images, labels) in enumerate(val_iter):
            images = torch.as_tensor(images).to(device, non_blocking=True)
            labels = torch.as_tensor(labels).to(device, non_blocking=True)
            result = eval_step(images, labels, hist)
            if isinstance(result, tuple):
                hist, preds = result
                if plot_cbs:
                    host = [t.cpu().numpy() for t in (images, labels, preds)]
                    for cb in plot_cbs:
                        cb.set_epoch(epoch)
                        cb.add_sample(*host)
            else:
                hist = result
            if callbacks and per_batch_callbacks:
                h = hist.cpu().numpy()
                total = h.sum()
                pixel_acc = (np.trace(h) / total) if total else 0.0
                for cb in callbacks:
                    cb.on_validation_batch_end(batch_idx, 1.0 - pixel_acc)
    finally:
        model.train(was_training)

    ious = per_class_iou(hist.cpu()).numpy()
    miou = float(np.nanmean(ious))
    print(f"Validation mIoU for Epoch {epoch + 1}: {miou:.4f}")

    per_class = None
    if class_names is not None:
        per_class = list(zip(class_names, [float(i) for i in ious]))
        if detailed_report:
            for name, iou in per_class:
                print(f"  {name:<15} {iou:.4f}")

    for cb in callbacks:
        cb.on_validation_end({"validation_mIoU": miou}, data=per_class)
    return miou, per_class


def val(epoch, model, val_iter, num_classes, callbacks=None, eval_step=None,
        device=None):
    """Validation with per-batch callbacks; returns the mIoU."""
    miou, _ = validate(model, val_iter, num_classes, epoch=epoch,
                       callbacks=callbacks, eval_step=eval_step,
                       per_batch_callbacks=True, device=device)
    return miou


def val_GTA5(epoch, model, val_iter, num_classes, class_names,
             callbacks=None, eval_step=None, device=None):
    """Validation with per-batch callbacks and the per-class IoU report."""
    return validate(model, val_iter, num_classes, class_names=class_names,
                    epoch=epoch, callbacks=callbacks, detailed_report=True,
                    eval_step=eval_step, per_batch_callbacks=True,
                    device=device)
