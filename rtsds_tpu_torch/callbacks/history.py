"""Training history: one JSON line per event, appended to a file.

Every ``train_begin``, epoch, validation and ``train_end`` event is written
as it happens, so runs can be compared and plotted offline.  Non-finite
numbers are written as null (strict JSON).

Config: ``callbacks: {history: {path: runs/history.jsonl}}``.
"""

from __future__ import annotations

import json
import math
import os
import time

from rtsds_tpu_torch.callbacks.base import Callback


def _jsonable(logs: dict | None) -> dict:
    out = {}
    for k, v in (logs or {}).items():
        try:
            f = float(v)
            out[k] = f if math.isfinite(f) else None
        except (TypeError, ValueError):
            out[k] = str(v)
    return out


class HistoryCallback(Callback):
    """Append-only JSONL event log of a training run."""

    def __init__(self, path: str = "history.jsonl"):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._epoch = None

    def _write(self, event: str, payload: dict):
        record = {"event": event, "time": time.time(), **payload}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def on_train_begin(self, logs=None):
        self._write("train_begin", _jsonable(logs))

    def on_epoch_end(self, epoch, logs=None):
        self._epoch = epoch
        self._write("epoch", {"epoch": int(epoch), **_jsonable(logs)})

    def on_validation_end(self, logs=None, data=None):
        payload = _jsonable(logs)
        if self._epoch is not None:
            payload["epoch"] = int(self._epoch)
        if data is not None:  # the per-class IoU table: [(name, iou), ...]
            try:
                payload["per_class_iou"] = {
                    str(name): (None if value != value else float(value))
                    for name, value in data}
            except (TypeError, ValueError):
                pass
        self._write("validation", payload)

    def on_train_end(self, logs=None):
        self._write("train_end", _jsonable(logs))


def read_history(path: str) -> list[dict]:
    """The event dicts of a history file, in order."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
