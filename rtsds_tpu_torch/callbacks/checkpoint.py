"""Checkpoints and early stopping, on ``torch.save``/``torch.load``.

A checkpoint holds whole train states: each named state's
``state_dict()`` (model, optimizer with its moments and step count).  One
directory per run, ``<save_dir>/<save_name>/``, holds ``epoch_<N>.pt`` for
each saved epoch N and ``metrics.json``, the monitored value of each saved
epoch.  ``save_best`` saves an epoch only when its monitored metric beats
the best so far, across epochs; otherwise every ``save_freq``-th epoch is
saved.  The last ``max_to_keep`` epochs are kept, and the best one always.

When training dies (an exception, or SIGTERM turned into
``utils/preemption.Preempted``), the loops call
:meth:`ModelCheckpoint.save_emergency`: it saves the epoch-start snapshot
of the interrupted epoch as that epoch and writes an ``EMERGENCY`` marker
holding its number, so that ``resume`` replays the epoch from its start.

Under the data axis every rank holds the same states, and only rank 0
writes (``parallel/distributed.py:is_main_rank``); a regular save ends
with a barrier, so no rank reads a checkpoint before it is whole, and on
``--resume`` every rank reads rank 0's files.  Under the model axis a
state's ``state_dict`` gathers the whole tensors from the ranks' shards
(``parallel/fsdp.py``), a collective, so every rank takes it and rank 0
writes the replicated run's file; a restore cuts it back into shards.
The emergency save has no barrier: the ranks stop at the same step and
exit after it, saving the epoch-start snapshot every rank took.
"""

from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np
import torch

from rtsds_tpu_torch.callbacks.base import Callback
from rtsds_tpu_torch.parallel.distributed import barrier, is_main_rank


# the file that marks a directory's latest save as a mid-epoch snapshot;
# it holds that epoch's number
EMERGENCY = "EMERGENCY"


def emergency_step(save_dir: str) -> int | None:
    """The epoch of ``save_dir``'s emergency snapshot, or None."""
    try:
        with open(os.path.join(save_dir, EMERGENCY)) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


class CheckpointManager:
    """Saves and restores ``{name: state}`` dicts of objects with
    ``state_dict``/``load_state_dict``, by epoch."""

    def __init__(self, save_dir: str, max_to_keep: int = 3,
                 best_mode: str = "max"):
        self.save_dir = os.path.abspath(save_dir)
        os.makedirs(self.save_dir, exist_ok=True)
        self.max_to_keep = max(int(max_to_keep), 1)
        self.best_mode = best_mode
        self._metrics_path = os.path.join(self.save_dir, "metrics.json")

    def _path(self, step: int) -> str:
        return os.path.join(self.save_dir, f"epoch_{int(step)}.pt")

    def metrics(self) -> dict[int, float | None]:
        """Monitored value of each saved epoch (None when none was given)."""
        if not os.path.exists(self._metrics_path):
            return {}
        with open(self._metrics_path) as f:
            return {int(k): v for k, v in json.load(f).items()}

    def all_steps(self) -> list[int]:
        return sorted(s for s in self.metrics()
                      if os.path.exists(self._path(s)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> int | None:
        scored = {s: v for s, v in self.metrics().items()
                  if v is not None and s in self.all_steps()}
        if not scored:
            return None
        pick = max if self.best_mode == "max" else min
        return pick(scored, key=scored.get)

    def save(self, step: int, states: dict, monitor: float | None = None):
        """Write ``states`` as epoch ``step``, replacing an earlier save of
        the same epoch; then drop the oldest saves beyond ``max_to_keep``,
        never the best."""
        payload = {name: state.state_dict() for name, state in states.items()}
        tmp = self._path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        metrics = self.metrics()
        metrics[int(step)] = None if monitor is None else float(monitor)
        self._write_metrics(metrics)
        best = self.best_step()
        for old in self.all_steps()[:-self.max_to_keep]:
            if old != best:
                os.remove(self._path(old))
                metrics.pop(old, None)
        self._write_metrics(metrics)

    def _write_metrics(self, metrics: dict):
        tmp = self._metrics_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({str(k): v for k, v in sorted(metrics.items())}, f)
        os.replace(tmp, self._metrics_path)

    def load(self, step: int) -> dict:
        """The saved ``{name: state_dict}`` of epoch ``step``, on the CPU."""
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def items(self, step: int) -> list[str]:
        """The names of the states saved as epoch ``step``, sorted.  The
        file is memory-mapped, so no tensor's bytes are read."""
        return sorted(torch.load(self._path(step), map_location="cpu",
                                 weights_only=True, mmap=True))

    def restore(self, states: dict, step: int | None = None,
                optional: tuple[str, ...] = ()) -> frozenset:
        """Load epoch ``step`` (default: the latest) into ``states`` in
        place.  Returns the names restored: every name of ``states``, less
        those of ``optional`` that the checkpoint does not hold (they are
        left as they were).  Returns an empty set, and leaves ``states`` as
        they were, when no checkpoint exists or it does not hold every
        other named state with matching tensors."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return frozenset()
        payload = self.load(step)
        missing = sorted(set(states) - set(payload) - set(optional))
        if missing:
            print(f"checkpoint restore skipped: epoch {step} holds "
                  f"{sorted(payload)}, wanted {sorted(states)}")
            return frozenset()
        names = [name for name in states if name in payload]
        backup = {name: _copy(states[name].state_dict()) for name in names}
        try:
            for name in names:
                states[name].load_state_dict(payload[name])
        except (RuntimeError, KeyError, ValueError) as e:
            for name in names:
                states[name].load_state_dict(backup[name])
            print(f"checkpoint restore skipped: {e}")
            return frozenset()
        return frozenset(names)


class Snapshot:
    """A frozen copy of a state's ``state_dict()`` (its tensors cloned on
    their devices, unless ``copy`` is off), itself a checkpoint item."""

    def __init__(self, state, copy: bool = True):
        self._state = state.state_dict()
        if copy:
            self._state = _copy(self._state)

    def state_dict(self) -> dict:
        return self._state


def snapshot_states(states: dict) -> dict:
    """``{name: Snapshot}`` of ``{name: state}``: the emergency provider
    the loops attach at each epoch's start."""
    return {name: Snapshot(state) for name, state in states.items()}


def _copy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree


def _improved(value: float, best: float | None, mode: str) -> bool:
    if best is None or not np.isfinite(best):
        return True
    return value > best if mode == "max" else value < best


class ModelCheckpoint(Callback):
    """Save-best / save-freq checkpoints of the live train state, which the
    loop hands over with :meth:`attach`."""

    def __init__(self, save_dir: str = "checkpoints", save_name: str = "model",
                 save_best: bool = True, monitor: str = "validation_mIoU",
                 mode: str = "max", save_freq: int = 1, max_to_keep: int = 3):
        self.save_dir = os.path.join(save_dir, save_name)
        self.save_best = save_best
        self.monitor = monitor
        self.mode = mode
        self.save_freq = max(int(save_freq), 1)
        self.best: float | None = None
        self.best_step: int | None = None
        self._get_states: Callable[[], dict] | None = None
        self._get_emergency: Callable[[], dict] | None = None
        self._max_to_keep = max_to_keep
        self._manager: CheckpointManager | None = None
        self._epoch = 0

    @property
    def manager(self) -> CheckpointManager:
        if self._manager is None:
            self._manager = CheckpointManager(self.save_dir,
                                              max_to_keep=self._max_to_keep,
                                              best_mode=self.mode)
        return self._manager

    def attach(self, get_states: Callable[[], dict],
               get_emergency_states: Callable[[], dict] | None = None
               ) -> "ModelCheckpoint":
        """``get_states`` feeds the regular saves, after an epoch;
        ``get_emergency_states`` feeds :meth:`save_emergency`.  The loops
        pass the epoch-start snapshot (:func:`snapshot_states`) as the
        latter: replayed from it, the interrupted epoch trains on the
        batches of the uninterrupted run, where a mid-epoch state would
        re-train on batches already consumed."""
        self._get_states = get_states
        self._get_emergency = get_emergency_states
        return self

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    @property
    def emergency_marker(self) -> str:
        return os.path.join(self.save_dir, EMERGENCY)

    def _save(self, states: dict, monitor: float | None = None) -> None:
        """A regular save of epoch ``self._epoch`` (rank 0's; every rank
        waits for it); it supersedes an emergency snapshot, so the marker
        goes.  Every rank takes the states' dicts (under the model axis
        that gathers the shards)."""
        states = {name: Snapshot(state, copy=False)
                  for name, state in states.items()}
        if is_main_rank():
            self.manager.save(self._epoch, states, monitor=monitor)
            try:
                os.remove(self.emergency_marker)
            except OSError:
                pass
        barrier()

    def on_epoch_end(self, epoch, logs=None):
        self._epoch = epoch
        if self._get_states is None:
            return
        if not self.save_best and (epoch + 1) % self.save_freq == 0:
            self._save(self._get_states())

    def on_validation_end(self, logs=None, data=None):
        if self._get_states is None or not logs:
            return
        value = logs.get(self.monitor)
        if value is None:
            return
        value = float(value)
        if not self.save_best:
            self._save(self._get_states(), monitor=value)
        elif _improved(value, self.best, self.mode):
            self.best = value
            self.best_step = self._epoch
            self._save(self._get_states(), monitor=value)
            print(f"Best Model Saved at Epoch {self._epoch}")

    def save_emergency(self) -> bool:
        """Save the interrupted epoch's snapshot (the emergency provider's,
        else the live states) as that epoch and mark it mid-epoch; the
        loops call this before an exception leaves them.  An epoch that is
        already saved is kept as it is: a post-epoch save lets ``resume``
        start the next epoch, an earlier emergency snapshot replays this
        one.  Returns True when the epoch is on disk; never raises, so the
        original error propagates."""
        if self._get_states is None:
            return False
        if not is_main_rank():
            return True
        try:
            if self._epoch in self.manager.all_steps():
                marked = os.path.exists(self.emergency_marker)
                print(f"Emergency: epoch {self._epoch} already has a "
                      f"{'mid-epoch' if marked else 'post-epoch'} snapshot;"
                      f" keeping it ({self.save_dir})")
                return True
            provider = self._get_emergency or self._get_states
            self.manager.save(self._epoch, provider())
            with open(self.emergency_marker, "w") as f:
                f.write(str(int(self._epoch)))
            print(f"Emergency checkpoint saved at epoch {self._epoch} "
                  f"({self.save_dir})")
            return True
        except Exception as e:
            print(f"emergency checkpoint failed: {e}")
            return False

    def resume(self, states: dict, optional: tuple[str, ...] = ()
               ) -> tuple[dict, int]:
        """Load the latest checkpoint into ``states``; returns ``(restored,
        start_epoch)``: the states restored (all of ``states`` but the
        ``optional`` ones the checkpoint lacks) and the epoch after the
        saved one, or the saved epoch itself when it is an emergency
        snapshot (the ``EMERGENCY`` marker names it), which then replays
        from its start; ``(states, 0)`` when nothing was restored.  The
        best value so far is re-armed from the stored metrics, so
        save-best cannot regress after a resume."""
        mgr = self.manager
        latest = mgr.latest_step()
        restored = (mgr.restore(states, latest, optional)
                    if latest is not None else frozenset())
        if not restored:
            return states, 0
        states = {name: states[name] for name in states if name in restored}
        start_epoch = int(latest) + 1
        if emergency_step(self.save_dir) == int(latest):
            start_epoch = int(latest)  # replay the interrupted epoch
        best = mgr.best_step()
        if best is not None:
            self.best = mgr.metrics()[best]
            self.best_step = best
        self._epoch = start_epoch
        print(f"Resuming from epoch {start_epoch} "
              f"(best {self.monitor}={self.best})")
        return states, start_epoch


class EarlyStopping(Callback):
    """Stop when the monitored metric stops improving; the loop polls
    :attr:`should_stop`."""

    def __init__(self, monitor: str = "validation_mIoU", mode: str = "max",
                 patience: int = 5, min_delta: float = 0.0):
        self.monitor = monitor
        self.mode = mode
        self.patience = patience
        self.min_delta = min_delta
        self.best: float | None = None
        self.wait = 0
        self.should_stop = False

    def on_validation_end(self, logs=None, data=None):
        if not logs or self.monitor not in logs:
            return
        value = float(logs[self.monitor])
        if self.best is None or (
                value > self.best + self.min_delta if self.mode == "max"
                else value < self.best - self.min_delta):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.should_stop = True
                print(f"EarlyStopping: no {self.monitor} improvement for "
                      f"{self.patience} validations; stopping.")
