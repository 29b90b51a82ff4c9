"""Callback protocol: nine no-op hooks the training and validation loops
fan out to."""

from __future__ import annotations


class Callback:
    """Base class for all callbacks; subclass and override what you need."""

    def on_train_begin(self, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_batch_end(self, batch, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_validation_batch_end(self, batch, logs=None):
        pass

    def on_validation_begin(self, logs=None):
        pass

    def on_validation_end(self, logs=None, data=None):
        pass

    def on_test_begin(self, logs=None):
        pass

    def on_test_end(self, logs=None):
        pass
