"""Adversarial domain-adaptation step: one generator (G) and one
discriminator (D) update per call, on a labelled source batch (GTA5) and an
unlabelled target batch (Cityscapes).

Single-level adversarial adaptation (Tsai et al., CVPR'18).  The generator
takes the cross entropy of its three heads on the source plus a
lambda-weighted BCE that pushes D(softmax(G(target))) toward the source
label; the discriminator then learns source = 1 and target = 0 on both
detached softmax maps.  D's parameters require no gradient while G's
losses run backward, so D never takes G's gradient; G's forwards run in
train mode, so BN's running statistics advance once per forward, source
first.

Three steps, picked by :func:`make_adversarial_step`:
  * v1: every loss divided by ``iterations``; D sees the softmax of the
    generator's outputs from before its update;
  * the gradient-reversal step (``grl_alpha > 0``, v1 only): one backward
    over ``CE/it + [BCE(D(src), 1) + BCE(D(tgt), 0)]/it`` with a
    ``-lambda * alpha`` gradient reversal at D's input, so D's update is
    v1's and G maximizes D's error on both domains;
  * v2: unscaled losses, the adversarial weight ``max(lambda, 10 * lambda -
    0.001 * epoch)``, G pushed toward the fake (source) label 0 under v2's
    real = target convention, and D trained on the *updated* generator's
    outputs, recomputed in train mode without gradients (BN advances twice
    more) and pooled to the target's size.

Two options compose with all three: ``lambda_ent > 0`` adds MinEnt, the
``lambda_ent``-weighted entropy of the generator's main target logits, to
G's losses (divided by ``iterations`` under v1 and the reversal step, as
their other losses are; unscaled under v2), reported as ``loss_entropy``;
``fda_beta > 0`` restyles each source batch with the target batch's
low-frequency amplitude (``ops/fda.py``) before the step sees it.

Under the data axis (``parallel/distributed.py``) the batches are this
rank's shards: both networks' BatchNorm, every loss (CE, BCE, entropy) and
G's and D's gradients are the global batch's, and the metrics come back
summed over the ranks.  FDA restyles each source frame with its own
rank's target frames, as the JAX step's per-frame FFT does with the
frames at the same global index.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from rtsds_tpu_torch.models.discriminator import gradient_reversal
from rtsds_tpu_torch.ops.fda import fda_source_to_target
from rtsds_tpu_torch.ops.losses import (
    bce_with_logits, entropy_loss, segmentation_loss)
from rtsds_tpu_torch.ops.pool import adaptive_avg_pool2d
from rtsds_tpu_torch.parallel.distributed import reduce_metrics
from rtsds_tpu_torch.train.state import TrainState
from rtsds_tpu_torch.train.supervised import check_batch
from rtsds_tpu_torch.utils.schedules import lambda_adv_schedule


def make_adversarial_step(lambda_: float, iterations: int, epochs: int,
                          ignore_index: int | None = 19,
                          variant: str = "v1", lambda_ent: float = 0.0,
                          fda_beta: float = 0.0,
                          grl_alpha: float = 0.0) -> Callable:
    """``step(gen_state, dis_state, src_images, src_labels, tgt_images) ->
    metrics``.

    Images are normalized (N, H, W, 3) float32 and labels (N, H, W) ints,
    all on the models' device; source and target may differ in size.  Both
    states are updated in place.  ``metrics`` holds the losses and
    ``correct`` (main-head source pixels equal to the label) as device
    tensors, which the caller reads when it needs them, and ``total``
    (every source pixel, ignored ones too) as an int; v2 adds
    ``loss_gen_total``, ``loss_disc_total`` and ``lambda_adv`` (a float),
    and ``lambda_ent > 0`` adds ``loss_entropy``.  A BiSeNet generator
    needs at least 2 frames in each batch.  ``epochs`` is part of the
    signature only: no step depends on it.
    """
    if grl_alpha and variant != "v1":
        raise ValueError("grl composes with the v1 step only; "
                         f"got variant={variant!r}")
    if grl_alpha:
        step = _make_grl_step(lambda_, iterations, ignore_index, grl_alpha,
                              lambda_ent)
    elif variant == "v1":
        step = _make_v1_step(lambda_, iterations, ignore_index, lambda_ent)
    elif variant == "v2":
        step = _make_v2_step(lambda_, iterations, ignore_index, lambda_ent)
    else:
        raise ValueError(f"unknown adversarial variant {variant!r}")
    return _with_fda(step, fda_beta)


def _with_fda(step: Callable, fda_beta: float) -> Callable:
    """``step`` with each source batch FDA-restyled by the target batch
    first; ``step`` itself when ``fda_beta`` is 0."""
    if not fda_beta:
        return _reduced(step)

    def fda_step(gen, dis, src_images, src_labels, tgt_images) -> dict:
        return step(gen, dis,
                    fda_source_to_target(src_images, tgt_images, fda_beta),
                    src_labels, tgt_images)

    return _reduced(fda_step)


def _reduced(step: Callable) -> Callable:
    """``step`` with its metrics summed over the data axis's ranks."""
    def reduced(*args) -> dict:
        return reduce_metrics(step(*args))
    return reduced


def _check_batches(gen: TrainState, src_images: torch.Tensor,
                   tgt_images: torch.Tensor):
    check_batch(gen.model, src_images, "source")
    check_batch(gen.model, tgt_images, "target")


def _forward(model: nn.Module, images: torch.Tensor) -> tuple:
    """Train-mode outputs of NHWC ``images``: ``(main, aux1, aux2)``."""
    outputs = model(images.permute(0, 3, 1, 2))
    if isinstance(outputs, (tuple, list)):
        return tuple(outputs)
    return outputs, None, None


@contextlib.contextmanager
def _frozen(model: nn.Module):
    """``model``'s parameters require no gradient inside the block."""
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _accuracy(src_main: torch.Tensor, src_labels: torch.Tensor) -> dict:
    with torch.no_grad():
        correct = (src_main.argmax(dim=1) == src_labels).sum()
    return {"correct": correct, "total": src_labels.numel()}


def v1_generator_update(gen: TrainState, dis: TrainState,
                        src_images: torch.Tensor, src_labels: torch.Tensor,
                        tgt_images: torch.Tensor, lambda_: float,
                        iterations: int, ignore_index: int | None = 19,
                        lambda_ent: float = 0.0):
    """v1's G phase: the source CE, then the adversarial BCE through the
    frozen D, each backward in turn (the source graph is freed before the
    target forward), and G's optimizer step.  ``lambda_ent`` adds MinEnt
    on the main target logits to the target backward, divided by
    ``iterations``.  Returns the detached main logits of source and target
    and the losses: ``(src_main, tgt_main, seg_loss, adv_loss, ent_loss or
    None)``."""
    inv_iters = 1.0 / float(iterations)
    gen.model.train()
    dis.model.train()
    gen.optimizer.zero_grad()
    with gen.autocast():
        src_out = _forward(gen.model, src_images)
        seg_loss = segmentation_loss(src_out, src_labels,
                                     ignore_index) * inv_iters
    seg_loss.backward()
    src_main = src_out[0].detach()
    del src_out
    ent_loss = None
    with _frozen(dis.model):
        with gen.autocast():
            tgt_main = _forward(gen.model, tgt_images)[0]
        with dis.autocast():
            d_tgt = dis.model(F.softmax(tgt_main, dim=1))
            adv_loss = lambda_ * bce_with_logits(d_tgt, 1.0) * inv_iters
        total = adv_loss
        if lambda_ent:
            ent_loss = lambda_ent * entropy_loss(tgt_main) * inv_iters
            total = total + ent_loss
        total.backward()
    gen.optimizer.step()
    return (src_main, tgt_main.detach(), seg_loss.detach(), adv_loss.detach(),
            _detached(ent_loss))


def _detached(loss):
    return None if loss is None else loss.detach()


def v1_discriminator_update(dis: TrainState, src_main: torch.Tensor,
                            tgt_main: torch.Tensor, iterations: int):
    """v1's D phase on the softmax of the given (detached) main logits:
    source = 1, target = 0, each BCE divided by ``iterations``.  Returns
    the two losses."""
    inv_iters = 1.0 / float(iterations)
    dis.model.train()
    dis.optimizer.zero_grad()
    with dis.autocast():
        loss_src = bce_with_logits(
            dis.model(F.softmax(src_main, dim=1)), 1.0) * inv_iters
        loss_tgt = bce_with_logits(
            dis.model(F.softmax(tgt_main, dim=1)), 0.0) * inv_iters
    (loss_src + loss_tgt).backward()
    dis.optimizer.step()
    return loss_src.detach(), loss_tgt.detach()


def _with_entropy(metrics: dict, ent_loss) -> dict:
    if ent_loss is not None:
        metrics["loss_entropy"] = ent_loss
    return metrics


def _make_v1_step(lambda_: float, iterations: int, ignore_index,
                  lambda_ent: float = 0.0):
    def step(gen, dis, src_images, src_labels, tgt_images) -> dict:
        _check_batches(gen, src_images, tgt_images)
        src_main, tgt_main, seg_loss, adv_loss, ent_loss = \
            v1_generator_update(gen, dis, src_images, src_labels,
                                tgt_images, lambda_, iterations,
                                ignore_index, lambda_ent)
        loss_src, loss_tgt = v1_discriminator_update(dis, src_main, tgt_main,
                                                     iterations)
        return _with_entropy(
            {"loss_gen_source": seg_loss, "loss_adversarial": adv_loss,
             "loss_disc_source": loss_src, "loss_disc_target": loss_tgt,
             **_accuracy(src_main, src_labels)}, ent_loss)

    return step


def _make_grl_step(lambda_: float, iterations: int, ignore_index,
                   grl_alpha: float, lambda_ent: float = 0.0):
    inv_iters = 1.0 / float(iterations)
    rev_scale = float(lambda_) * float(grl_alpha)

    def step(gen, dis, src_images, src_labels, tgt_images) -> dict:
        _check_batches(gen, src_images, tgt_images)
        gen.model.train()
        dis.model.train()
        with gen.autocast():
            src_out = _forward(gen.model, src_images)
            seg_loss = segmentation_loss(src_out, src_labels,
                                         ignore_index) * inv_iters
            tgt_main = _forward(gen.model, tgt_images)[0]
        src_feat = gradient_reversal(F.softmax(src_out[0], dim=1), rev_scale)
        tgt_feat = gradient_reversal(F.softmax(tgt_main, dim=1), rev_scale)
        with dis.autocast():
            # unweighted BCE: D's update is v1's; G's weight is rev_scale
            loss_src = bce_with_logits(dis.model(src_feat), 1.0) * inv_iters
            loss_tgt = bce_with_logits(dis.model(tgt_feat), 0.0) * inv_iters
        total = seg_loss + loss_src + loss_tgt
        ent_loss = None
        if lambda_ent:
            ent_loss = lambda_ent * entropy_loss(tgt_main) * inv_iters
            total = total + ent_loss
        gen.optimizer.zero_grad()
        dis.optimizer.zero_grad()
        total.backward()
        gen.optimizer.step()
        dis.optimizer.step()
        loss_src, loss_tgt = loss_src.detach(), loss_tgt.detach()
        return _with_entropy(
            {"loss_gen_source": seg_loss.detach(),
             "loss_adversarial": rev_scale * (loss_src + loss_tgt),
             "loss_disc_source": loss_src, "loss_disc_target": loss_tgt,
             **_accuracy(src_out[0], src_labels)}, _detached(ent_loss))

    return step


def _make_v2_step(lambda_: float, iterations: int, ignore_index,
                  lambda_ent: float = 0.0):
    lam_schedule = lambda_adv_schedule(lambda_, iterations)

    def step(gen, dis, src_images, src_labels, tgt_images) -> dict:
        _check_batches(gen, src_images, tgt_images)
        tgt_size = tuple(tgt_images.shape[1:3])
        lam = lam_schedule(gen.step)
        gen.model.train()
        dis.model.train()

        # G: the source CE plus lam * BCE(D(target), fake = 0)
        gen.optimizer.zero_grad()
        with gen.autocast():
            src_out = _forward(gen.model, src_images)
            seg_loss = segmentation_loss(src_out, src_labels, ignore_index)
        seg_loss.backward()
        src_main = src_out[0].detach()
        del src_out
        ent_loss = None
        with _frozen(dis.model):
            with gen.autocast():
                tgt_main = _forward(gen.model, tgt_images)[0]
            with dis.autocast():
                d_real = dis.model(F.softmax(
                    adaptive_avg_pool2d(tgt_main, tgt_size), dim=1))
                loss_adv = bce_with_logits(d_real, 0.0)
            total = lam * loss_adv
            if lambda_ent:
                ent_loss = lambda_ent * entropy_loss(tgt_main)
                total = total + ent_loss
            total.backward()
        del tgt_main
        gen.optimizer.step()

        # D on the updated generator's outputs: real = target, fake = source
        with torch.no_grad(), gen.autocast():
            fake_main = _forward(gen.model, src_images)[0]
            real_main = _forward(gen.model, tgt_images)[0]
        fake_seg = F.softmax(adaptive_avg_pool2d(fake_main, tgt_size), dim=1)
        real_seg = F.softmax(adaptive_avg_pool2d(real_main, tgt_size), dim=1)
        dis.optimizer.zero_grad()
        with dis.autocast():
            d_real_loss = bce_with_logits(dis.model(real_seg), 1.0)
            d_fake_loss = bce_with_logits(dis.model(fake_seg), 0.0)
            d_total = d_real_loss + d_fake_loss
        d_total.backward()
        dis.optimizer.step()

        seg_loss, loss_adv = seg_loss.detach(), loss_adv.detach()
        ent_loss = _detached(ent_loss)
        g_total = seg_loss + lam * loss_adv
        if ent_loss is not None:
            g_total = g_total + ent_loss
        return _with_entropy(
            {"loss_gen_source": seg_loss, "loss_adversarial": loss_adv,
             "loss_gen_total": g_total,
             "loss_disc_source": d_fake_loss.detach(),
             "loss_disc_target": d_real_loss.detach(),
             "loss_disc_total": d_total.detach(), "lambda_adv": lam,
             **_accuracy(src_main, src_labels)}, ent_loss)

    return step
