"""Validation image plots (``callbacks.images_plots``): the first frames of
a few validation batches, drawn at the end of each validation."""

from __future__ import annotations

import os

from rtsds_tpu_torch.callbacks.base import Callback
from rtsds_tpu_torch.utils.viz import visualize_batches


class ImagePlotsCallback(Callback):
    """Collects up to ``number_of_samples`` (inputs, targets, preds) host
    arrays that ``validate`` passes to :meth:`add_sample`, one per batch,
    and draws them to ``<save_dir>/val_epoch_<N>.png`` when validation
    ends."""

    def __init__(self, save_dir: str = "images", number_of_samples: int = 4):
        self.save_dir = save_dir
        self.number_of_samples = number_of_samples
        self._inputs: list = []
        self._targets: list = []
        self._preds: list = []
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def add_sample(self, inputs, targets, preds):
        if len(self._inputs) < self.number_of_samples:
            self._inputs.append(inputs)
            self._targets.append(targets)
            self._preds.append(preds)

    def on_validation_begin(self, logs=None):
        self._inputs, self._targets, self._preds = [], [], []

    def on_validation_end(self, logs=None, data=None):
        if not self._inputs:
            return
        os.makedirs(self.save_dir, exist_ok=True)
        path = os.path.join(self.save_dir, f"val_epoch_{self._epoch}.png")
        visualize_batches(self._inputs, self._targets, self._preds,
                          num_batches=self.number_of_samples, save_path=path)
