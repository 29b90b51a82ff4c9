"""Self-training domain adaptation: a mean teacher's pseudo-labels on the
target, fused with the v1 adversarial step.

Counterpart of ``rtsds_tpu/train/self_training.py`` (CBST, Zou et al.
ECCV'18; DACS ClassMix, Tranheden et al. WACV'21).  The EMA of the
generator (``train/ema.py``) predicts the unlabelled target batch; pixels
whose softmax confidence clears a threshold (one for all classes, or one
per class, calibrated by CBST) become labels, the rest ``ignore_index``;
the generator takes a ``lambda_pl``-weighted cross entropy on them beside
its v1 losses, or, with ClassMix, on a batch that pastes half of each
source frame's classes onto a target frame.  Then the v1 discriminator
update, then the EMA update on the updated generator.

ClassMix draws one uniform score per (frame, class) to pick the classes.
The JAX package draws them with ``fold_in(key(classmix_seed), step)``,
which torch cannot reproduce; here a CPU ``torch.Generator`` seeded from
``(classmix_seed, step)`` draws them, so a resumed run replays the same
mixes, and a caller may pass its own scores (the tests pass JAX's).
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rtsds_tpu_torch.ops.fda import fda_source_to_target
from rtsds_tpu_torch.ops.losses import (
    bce_with_logits, entropy_loss, segmentation_loss)
from rtsds_tpu_torch.ops.resize import resize_images, resize_labels_nearest
from rtsds_tpu_torch.train.adversarial import (
    _accuracy, _check_batches, _forward, _frozen, _with_entropy,
    v1_discriminator_update)
from rtsds_tpu_torch.train.ema import ema_update, ema_weights
from rtsds_tpu_torch.utils.dtypes import at_least_f32, model_dtype


def pseudo_labels(logits: torch.Tensor, threshold, ignore_index: int = 19
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Confidence-thresholded argmax labels of (N, C, H, W) teacher logits.

    ``threshold`` is a number, or one per class (a sequence or tensor of C
    values): each pixel is held to the threshold of its argmax class.
    Returns ``(labels, coverage)``: (N, H, W) int32 labels, ``ignore_index``
    where the confidence falls short, and the float32 share of pixels kept.
    """
    probs = F.softmax(at_least_f32(logits), dim=1)
    conf, labels = probs.max(dim=1)
    labels = labels.to(torch.int32)
    thr = torch.as_tensor(np.asarray(threshold), dtype=conf.dtype,
                          device=conf.device)
    if thr.ndim == 1:
        thr = thr[labels.long()]
    keep = conf >= thr
    labels = torch.where(keep, labels,
                         torch.full_like(labels, ignore_index))
    return labels, keep.to(torch.float32).mean()


def classmix_scores(seed: int, step: int, n: int, num_classes: int
                    ) -> torch.Tensor:
    """(n, num_classes) uniform float32 scores on the CPU, the same for the
    same ``(seed, step)``."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(2)
    gen = torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))
    return torch.rand((n, num_classes), generator=gen)


def classmix_masks(labels: torch.Tensor, scores: torch.Tensor,
                   num_classes: int) -> torch.Tensor:
    """(N, H, W) bool masks of the pixels of ``ceil(present / 2)`` of the
    classes present in each label map: the classes of least score among
    those present, ``scores`` being (N, C) numbers.  Ids outside [0, C)
    (void, ignore) are never chosen."""
    n = labels.shape[0]
    lab = labels.reshape(n, -1).long()
    ids = torch.where((lab >= 0) & (lab < num_classes), lab, num_classes)
    present = torch.zeros((n, num_classes + 1), dtype=torch.bool,
                          device=labels.device)
    present.scatter_(1, ids, True)
    present = present[:, :num_classes]
    scores = torch.where(present, scores.to(labels.device),
                         torch.full_like(present, float("inf"),
                                         dtype=scores.dtype))
    k = (present.sum(dim=1) + 1) // 2
    kth = scores.sort(dim=1).values.gather(
        1, (k - 1).clamp(0, num_classes - 1)[:, None])
    selected = (scores <= kth) & present
    selected = F.pad(selected, (0, 1))  # the void id selects nothing
    return selected.gather(1, ids).reshape(labels.shape)


@torch.no_grad()
def calibrate_class_thresholds(model: nn.Module, batches: Iterable,
                               num_classes: int, portion: float = 0.5,
                               bins: int = 512, max_threshold: float = 0.999,
                               compute_dtype: torch.dtype | None = None
                               ) -> np.ndarray:
    """CBST calibration: per class, the confidence that keeps the top
    ``portion`` of the pixels the teacher assigns to that class.

    ``model`` runs in eval mode on each batch (NHWC images, or tuples whose
    first item they are); the joint class x confidence-bin counts add up on
    the device (``torch.bincount``), and only the (C, bins) table comes to
    the host, where each class's quantile is walked down from the most
    confident bin.  Returns (C,) float32 thresholds; a class the teacher
    never predicts gets ``max_threshold``.
    """
    was_training = model.training
    model.eval()
    dtype = model_dtype(model)
    hist = None
    try:
        for batch in batches:
            images = batch[0] if isinstance(batch, (tuple, list)) else batch
            with torch.autocast(device_type=images.device.type,
                                dtype=compute_dtype or dtype,
                                enabled=compute_dtype not in (None, dtype)):
                out = model(images.to(dtype).permute(0, 3, 1, 2))
            if isinstance(out, (tuple, list)):
                out = out[0]
            conf, cls = F.softmax(at_least_f32(out), dim=1).max(dim=1)
            b = (conf * bins).to(torch.int32).clamp(0, bins - 1)
            joint = (cls.to(torch.int32) * bins + b).reshape(-1)
            counts = torch.bincount(joint, minlength=num_classes * bins)
            hist = counts if hist is None else hist + counts
    finally:
        model.train(was_training)

    thr = np.full((num_classes,), max_threshold, np.float32)
    if hist is None:
        return thr
    h = hist.reshape(num_classes, bins).cpu().numpy()
    for c in range(num_classes):
        total = int(h[c].sum())
        if total == 0:
            continue
        cum = np.cumsum(h[c][::-1])
        k = int(np.searchsorted(cum, portion * total))
        thr[c] = min((bins - 1 - k) / bins, max_threshold)
    return thr


def make_self_training_step(lambda_: float, iterations: int,
                            ignore_index: int = 19, *, threshold=0.9,
                            lambda_pl: float = 1.0, ema_decay: float = 0.999,
                            lambda_ent: float = 0.0, fda_beta: float = 0.0,
                            classmix: bool = False,
                            classmix_seed: int = 42) -> Callable:
    """``step(gen_state, dis_state, ema_params, src_images, src_labels,
    tgt_images, scores=None) -> metrics``, updating both states and the
    EMA dict ``ema_params`` (the teacher) in place.

    In order: FDA of the source by the target (``fda_beta > 0``); the
    teacher's eval-mode forward of the target, on ``ema_params`` with the
    generator's batch-norm statistics as they stand before this step, and
    its pseudo-labels; with ``classmix``, the mixed batch (the source and
    its labels resized to the target's size, bilinear and nearest, tiled
    over the target batch; ``scores``, (Nt, C), pick the classes, drawn
    from ``(classmix_seed, step)`` when not given); the generator update,
    v1's losses plus ``lambda_pl`` x the cross entropy on the pseudo-labels
    or on the mixed batch, plus MinEnt with ``lambda_ent``, every loss
    divided by ``iterations``; the v1 discriminator update; the EMA update
    on the updated generator at its new step.  The metrics add
    ``loss_pseudo``, ``pl_coverage`` and, with ClassMix, ``mix_coverage``
    to v1's.
    """
    if ignore_index is None:
        raise ValueError("self-training needs an ignore_index to mask "
                         "sub-threshold pixels (the reference uses 19)")
    inv_iters = 1.0 / float(iterations)

    def step(gen, dis, ema_params, src_images, src_labels, tgt_images,
             scores=None) -> dict:
        _check_batches(gen, src_images, tgt_images)
        src_images = fda_source_to_target(src_images, tgt_images, fda_beta)
        model = gen.model

        # the teacher: eval mode, EMA weights, the student's BN statistics
        with ema_weights(model, ema_params), torch.no_grad(), \
                gen.autocast():
            t_out = model.eval()(tgt_images.permute(0, 3, 1, 2))
        model.train()
        if isinstance(t_out, (tuple, list)):
            t_out = t_out[0]
        num_classes = t_out.shape[1]
        pl, coverage = pseudo_labels(t_out, threshold, ignore_index)
        del t_out

        mix_images = mix_labels = mix_coverage = None
        if classmix:
            tgt_hw = tuple(tgt_images.shape[1:3])
            src_small = resize_images(src_images, tgt_hw)
            lbl_small = resize_labels_nearest(src_labels, tgt_hw)
            nt = tgt_images.shape[0]
            if src_small.shape[0] != nt:
                idx = torch.arange(nt, device=src_small.device) \
                    % src_small.shape[0]
                src_small, lbl_small = src_small[idx], lbl_small[idx]
            if scores is None:
                scores = classmix_scores(classmix_seed, gen.step, nt,
                                         num_classes)
            mask = classmix_masks(lbl_small, scores, num_classes)
            mix_images = torch.where(mask[..., None],
                                     src_small.to(tgt_images.dtype),
                                     tgt_images)
            mix_labels = torch.where(mask, lbl_small.to(torch.int32), pl)
            mix_coverage = mask.to(torch.float32).mean()
            del src_small, lbl_small, mask

        # the generator: source CE; target adversarial BCE (+ pseudo-label
        # CE without ClassMix, + MinEnt); the mixed batch's CE
        dis.model.train()
        gen.optimizer.zero_grad()
        with gen.autocast():
            src_out = _forward(model, src_images)
            seg_loss = segmentation_loss(src_out, src_labels,
                                         ignore_index) * inv_iters
        seg_loss.backward()
        src_main = src_out[0].detach()
        del src_out
        ent_loss = pl_loss = None
        with _frozen(dis.model):
            with gen.autocast():
                tgt_out = _forward(model, tgt_images)
            tgt_main = tgt_out[0]
            with dis.autocast():
                d_tgt = dis.model(F.softmax(tgt_main, dim=1))
                adv_loss = lambda_ * bce_with_logits(d_tgt, 1.0) * inv_iters
            total = adv_loss
            if not classmix:
                with gen.autocast():
                    pl_loss = lambda_pl * segmentation_loss(
                        tgt_out, pl, ignore_index) * inv_iters
                total = total + pl_loss
            if lambda_ent:
                ent_loss = lambda_ent * entropy_loss(tgt_main) * inv_iters
                total = total + ent_loss
            total.backward()
        tgt_main = tgt_main.detach()
        del tgt_out, total
        if classmix:
            with gen.autocast():
                mix_out = _forward(model, mix_images)
                pl_loss = lambda_pl * segmentation_loss(
                    mix_out, mix_labels, ignore_index) * inv_iters
            pl_loss.backward()
            del mix_out
        gen.optimizer.step()

        loss_src, loss_tgt = v1_discriminator_update(dis, src_main, tgt_main,
                                                     iterations)
        ema_update(ema_params, model, ema_decay, gen.step)

        metrics = {"loss_gen_source": seg_loss.detach(),
                   "loss_adversarial": adv_loss.detach(),
                   "loss_pseudo": pl_loss.detach(), "pl_coverage": coverage,
                   "loss_disc_source": loss_src, "loss_disc_target": loss_tgt,
                   **_accuracy(src_main, src_labels)}
        if mix_coverage is not None:
            metrics["mix_coverage"] = mix_coverage
        return _with_entropy(
            metrics, None if ent_loss is None else ent_loss.detach())

    return step
