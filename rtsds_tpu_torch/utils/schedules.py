"""Learning-rate schedules: plain functions of the integer optimizer step.

``poly_lr_schedule`` reproduces the training script's poly decay with its
call-site gating: the rate is refreshed only at steps that are multiples of
``lr_decay_iter`` and not past ``max_iter``, and holds its value between.
"""

from __future__ import annotations

from typing import Callable

Schedule = Callable[[int], float]


def poly_lr_schedule(init_lr: float, max_iter: int, power: float = 0.9,
                     lr_decay_iter: int = 1) -> Schedule:
    """``init_lr * (1 - it / max_iter) ** power``, where ``it`` is the
    largest multiple of ``lr_decay_iter`` that is at most both the step and
    ``max_iter``."""
    lr_decay_iter = max(int(lr_decay_iter), 1)
    max_update = (max_iter // lr_decay_iter) * lr_decay_iter

    def schedule(step: int) -> float:
        it = min((int(step) // lr_decay_iter) * lr_decay_iter, max_update)
        return init_lr * (1.0 - it / float(max_iter)) ** power

    return schedule


def poly_epoch_schedule(init_lr: float, epochs: int, power: float,
                        iterations_per_epoch: int) -> Schedule:
    """Poly decay once per epoch: ``init_lr * (1 - epoch / epochs) **
    power`` with ``epoch = step // iterations_per_epoch`` (the adversarial
    discriminator's rate under v1)."""

    def schedule(step: int) -> float:
        epoch = int(step) // iterations_per_epoch
        return init_lr * (1.0 - epoch / float(epochs)) ** power

    return schedule


def lambda_adv_schedule(lambda_: float, iterations_per_epoch: int
                        ) -> Schedule:
    """The v2 adversarial weight ``max(lambda, 10 * lambda - 0.001 *
    epoch)``, ``epoch = step // iterations_per_epoch``."""

    def schedule(step: int) -> float:
        epoch = int(step) // iterations_per_epoch
        return max(lambda_, lambda_ * 10.0 - 0.001 * epoch)

    return schedule


def with_warmup(schedule: Schedule, warmup_iters: int) -> Schedule:
    """Linear warmup: the schedule scaled by ``min((step + 1) / warmup,
    1)``.  ``warmup_iters <= 0`` returns the schedule unchanged."""
    if int(warmup_iters) <= 0:
        return schedule
    w = float(warmup_iters)

    def warmed(step: int) -> float:
        return schedule(step) * min((int(step) + 1.0) / w, 1.0)

    return warmed
