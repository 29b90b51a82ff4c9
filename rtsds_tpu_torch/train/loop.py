"""The training loops: supervised (``supervised_fit``) and adversarial
domain adaptation (``adversarial_fit``), each with validation every
``do_validation`` epochs, callbacks and checkpoints, and optionally an
exponential moving average of the trained model's parameters
(``train/ema.py``) that validation runs on and checkpoints carry as their
``ema`` item.

The loops read each step's metrics one step late: they queue the next step
on the device before they fetch the previous step's losses and counts, so
the host never waits for the step it has just launched.  The best
validation metric is tracked across epochs by :class:`ModelCheckpoint`.

At each epoch's start a loop with a checkpoint copies its states on their
devices (:func:`~rtsds_tpu_torch.callbacks.checkpoint.snapshot_states`:
the model, the optimizer with its moments and count, the EMA); when an
exception (``Preempted`` on SIGTERM among them) leaves the loop, that copy
is saved as the interrupted epoch's emergency checkpoint before the
exception propagates, and ``--resume`` replays the epoch from it.

Under the data axis every rank runs the loop on its shards; the steps'
metrics come back summed over the ranks, so every rank prints and decides
alike.  A shutdown signal recorded by any rank (``utils/preemption.py``,
deferred) stops all of them at the step whose metrics report it.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Iterator

from rtsds_tpu_torch.callbacks.checkpoint import snapshot_states
from rtsds_tpu_torch.device import resolve_device
from rtsds_tpu_torch.eval.validate import make_eval_step, validate
from rtsds_tpu_torch.parallel.pipeline import to_device
from rtsds_tpu_torch.train.ema import ema_update, ema_weights, setup_ema
from rtsds_tpu_torch.utils.preemption import check_stop


def _fan_out(callbacks, method: str, *args, **kwargs):
    for cb in callbacks or []:
        getattr(cb, method)(*args, **kwargs)


def train_epoch(state, train_step: Callable, batches: Iterable, epoch: int,
                callbacks=None) -> dict:
    """One epoch over ``batches`` of device-ready (images, labels).

    Returns ``{'train_loss', 'train_accuracy'}``; each batch's callbacks
    get the step's loss and the running pixel accuracy in percent.
    """
    _fan_out(callbacks, "on_train_begin")
    running_loss = 0.0
    correct = 0
    total = 0
    pending = None  # (batch_idx, metrics) of the previous step
    n_batches = 0

    def consume(item):
        nonlocal running_loss, correct, total
        batch_idx, metrics = item
        check_stop(metrics.get("preempted"))
        loss = float(metrics["train_loss"])
        running_loss += loss
        correct += int(metrics["correct"])
        total += int(metrics["total"])
        logs = {"train_loss": loss,
                "train_accuracy": 100.0 * correct / max(total, 1)}
        for k, v in metrics.items():
            if k not in ("train_loss", "correct", "total", "preempted"):
                logs[k] = float(v)
        _fan_out(callbacks, "on_batch_end", batch_idx, logs)

    for batch_idx, (images, labels) in enumerate(batches):
        metrics = train_step(state, images, labels)
        n_batches += 1
        if pending is not None:
            consume(pending)
        pending = (batch_idx, metrics)
    if pending is not None:
        consume(pending)

    train_loss = running_loss / max(n_batches, 1)
    train_accuracy = 100.0 * correct / max(total, 1)
    print(f"Train Epoch: {epoch + 1} Loss: {train_loss:.6f} "
          f"Acc: {train_accuracy:.2f}%")
    logs = {"train_loss": train_loss, "train_accuracy": train_accuracy}
    _fan_out(callbacks, "on_epoch_end", epoch, logs)
    return logs


def on_ema(eval_step: Callable, model, ema) -> Callable:
    """``eval_step`` computing with the EMA's weights (``ema`` an
    :class:`~rtsds_tpu_torch.train.ema.EMA`, or None for ``eval_step``
    itself).  They are swapped into ``model`` for each batch's step only,
    so a callback between batches, a checkpoint's save among them, sees
    the model's own weights."""
    if ema is None:
        return eval_step

    def step(*args):
        with ema_weights(model, ema.params):
            return eval_step(*args)
    return step


def supervised_fit(state, train_step: Callable, make_train_batches: Callable,
                   make_val_batches: Callable, epochs: int, num_classes: int,
                   class_names=None, callbacks=None, do_validation: int = 1,
                   checkpoint=None, start_epoch: int = 0, device=None,
                   eval_step=None, ema_decay: float | None = None,
                   ema_params=None):
    """Epochs ``start_epoch .. epochs - 1`` of training and validation.

    ``make_train_batches(epoch)`` and ``make_val_batches(epoch)`` return
    iterables of device batches.  The model is moved to ``device``
    (``None`` means the GPU, and raises without one).  ``checkpoint`` (a
    :class:`~rtsds_tpu_torch.callbacks.checkpoint.ModelCheckpoint`) saves
    ``{"model": state}``.  ``eval_step`` validates (a protocol's, from
    ``eval/sliding.py`` or ``eval/ensemble.py``); ``None`` builds the plain
    one.  ``ema_decay`` keeps an EMA of the model's parameters, updated
    after each step at the optimizer's new count, validates on it (with the
    model's own BN buffers) and checkpoints it as ``ema``; ``ema_params``
    (a restored EMA dict) seeds it, else it starts from the parameters.
    Returns ``(state, history)``, one history entry per validation.
    """
    device = resolve_device(device)
    to_device(state.model, device)
    callbacks = list(callbacks or [])
    ema = None
    if ema_decay is not None:
        ema = setup_ema(state.model, ema_params)
        base_step = train_step

        def train_step(st, images, labels):  # noqa: F811 -- EMA wrapper
            metrics = base_step(st, images, labels)
            ema_update(ema.params, st.model, ema_decay, st.step)
            return metrics
    def states():
        return ({"model": state} if ema is None
                else {"model": state, "ema": ema})

    if checkpoint is not None and checkpoint not in callbacks:
        callbacks.append(checkpoint)
    if eval_step is None:
        eval_step = make_eval_step(
            state.model, num_classes,
            return_preds=any(hasattr(cb, "add_sample") for cb in callbacks),
            compute_dtype=state.compute_dtype)

    history = []
    try:
        for epoch in range(start_epoch, epochs):
            _epoch_start(checkpoint, epoch, states)
            train_logs = train_epoch(state, train_step,
                                     make_train_batches(epoch), epoch,
                                     callbacks)
            if do_validation and epoch % do_validation == 0:
                miou, _ = validate(
                    state.model, make_val_batches(epoch), num_classes,
                    class_names=class_names, epoch=epoch,
                    callbacks=callbacks,
                    detailed_report=class_names is not None,
                    eval_step=on_ema(eval_step, state.model, ema),
                    device=device)
                history.append({"epoch": epoch, **train_logs,
                                "validation_mIoU": miou})
            if any(getattr(cb, "should_stop", False) for cb in callbacks):
                break
    except Exception:
        if checkpoint is not None:
            checkpoint.save_emergency()
        raise
    _fan_out(callbacks, "on_train_end")
    return state, history


def _epoch_start(checkpoint, epoch: int, states: Callable[[], dict]) -> None:
    """Point ``checkpoint`` at ``epoch``, with the live ``states`` for its
    regular saves and a copy of them as they start the epoch for an
    emergency save."""
    if checkpoint is None:
        return
    checkpoint.set_epoch(epoch)
    snapshot = snapshot_states(states())
    checkpoint.attach(states, lambda: snapshot)


# the adversarial steps' losses, in the epoch table's order: self-training
# adds the pseudo-label loss and coverages, MinEnt the entropy, v2 the two
# totals
DA_LOSS_KEYS = ("loss_gen_source", "loss_adversarial", "loss_pseudo",
                "pl_coverage", "mix_coverage", "loss_entropy",
                "loss_disc_source", "loss_disc_target", "loss_gen_total",
                "loss_disc_total")


def tabular_print(row: dict) -> None:
    """Print a one-row ASCII table of ``row``."""
    keys = [str(k) for k in row]
    vals = [f"{v:.6g}" if isinstance(v, float) else str(v)
            for v in row.values()]
    widths = [max(len(k), len(v)) for k, v in zip(keys, vals)]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"

    def line(cells):
        return "|" + "|".join(f" {c:<{w}} " for c, w in zip(cells, widths)) \
            + "|"
    print("\n".join([sep, line(keys), sep, line(vals), sep]))


def adversarial_fit(gen_state, dis_state, da_step: Callable,
                    source_iter: Iterator, target_iter: Iterator,
                    make_val_batches: Callable, iterations: int, epochs: int,
                    num_classes: int, class_names=None, callbacks=None,
                    do_validation: int = 1, checkpoint=None,
                    when_print: int = -1, start_epoch: int = 0, device=None,
                    eval_step=None, ema_decay: float | None = None,
                    ema_params=None, ema_in_step: bool = False):
    """Epochs ``start_epoch .. epochs - 1`` of domain adaptation.

    ``source_iter`` and ``target_iter`` are endless iterators of device
    batches (GTA5 and Cityscapes); each epoch runs ``iterations`` calls of
    ``da_step(gen_state, dis_state, src_images, src_labels, tgt_images)``,
    prints the epoch table (the mean of each loss, ``Generator Accuracy``
    and ``steps_per_sec``), validates the generator, and hands
    ``{"generator", "discriminator"}`` to ``checkpoint``.  ``when_print >
    0`` prints every ``when_print``-th step's losses.  Both models are
    moved to ``device`` (``None`` means the GPU, and raises without one).
    ``eval_step`` validates the generator, as for :func:`supervised_fit`.
    ``ema_decay`` keeps an EMA of the generator as :func:`supervised_fit`
    does, checkpointed as ``ema`` beside both networks; ``ema_params``
    seeds it.  ``ema_in_step``: the step updates the EMA itself (the
    self-training step, ``train/self_training.py``) and is called as
    ``da_step(gen_state, dis_state, ema_dict, src_images, src_labels,
    tgt_images)``; the loop then only seeds, validates on and checkpoints
    the EMA, and ``ema_decay`` is not read.  Returns ``(gen_state,
    dis_state, history)``, one history entry per validation.
    """
    device = resolve_device(device)
    to_device(gen_state.model, device)
    dis_state.model.to(device)
    callbacks = list(callbacks or [])
    ema = None
    if ema_in_step or ema_decay is not None:
        ema = setup_ema(gen_state.model, ema_params)
    def states():
        return {"generator": gen_state, "discriminator": dis_state,
                **({} if ema is None else {"ema": ema})}

    if checkpoint is not None and checkpoint not in callbacks:
        callbacks.append(checkpoint)
    if eval_step is None:
        eval_step = make_eval_step(
            gen_state.model, num_classes,
            return_preds=any(hasattr(cb, "add_sample") for cb in callbacks),
            compute_dtype=gen_state.compute_dtype)

    history = []
    try:
        for epoch in range(start_epoch, epochs):
            _epoch_start(checkpoint, epoch, states)
            _fan_out(callbacks, "on_train_begin")
            running = {}
            counts = {"correct": 0, "total": 0}
            pending = None  # (step index, metrics) of the previous step

            def consume(item):
                i, metrics = item
                check_stop(metrics.get("preempted"))
                logs = {k: float(metrics[k]) for k in DA_LOSS_KEYS
                        if k in metrics}
                for k, v in logs.items():
                    running[k] = running.get(k, 0.0) + v
                counts["correct"] += int(metrics["correct"])
                counts["total"] += int(metrics["total"])
                _fan_out(callbacks, "on_batch_end", i, logs)
                if when_print > 0 and (i + 1) % when_print == 0:
                    print(f"  iter {i + 1}/{iterations}: " + ", ".join(
                        f"{k}={v:.4f}" for k, v in logs.items()))

            t0 = time.perf_counter()
            for i in range(iterations):
                src_images, src_labels = next(source_iter)
                tgt_images, _ = next(target_iter)
                if ema_in_step:
                    metrics = da_step(gen_state, dis_state, ema.params,
                                      src_images, src_labels, tgt_images)
                else:
                    metrics = da_step(gen_state, dis_state, src_images,
                                      src_labels, tgt_images)
                    if ema is not None:
                        ema_update(ema.params, gen_state.model, ema_decay,
                                   gen_state.step)
                if pending is not None:
                    consume(pending)
                pending = (i, metrics)
            if pending is not None:
                consume(pending)
            dt = time.perf_counter() - t0

            summary = {k: v / iterations for k, v in running.items()}
            summary["Generator Accuracy"] = (100.0 * counts["correct"]
                                             / max(counts["total"], 1))
            summary["steps_per_sec"] = iterations / dt
            print(f"Epoch Results {epoch}")
            tabular_print(summary)
            _fan_out(callbacks, "on_epoch_end", epoch, summary)

            if do_validation and epoch % do_validation == 0:
                print("-" * 50, "Validation", "-" * 50)
                miou, _ = validate(
                    gen_state.model, make_val_batches(epoch), num_classes,
                    class_names=class_names, epoch=epoch, callbacks=callbacks,
                    detailed_report=class_names is not None,
                    eval_step=on_ema(eval_step, gen_state.model, ema),
                    device=device)
                print("-" * 100)
                history.append({"epoch": epoch, **summary,
                                "validation_mIoU": miou})
            if any(getattr(cb, "should_stop", False) for cb in callbacks):
                break
    except Exception:
        if checkpoint is not None:
            checkpoint.save_emergency()
        raise
    _fan_out(callbacks, "on_train_end")
    return gen_state, dis_state, history
