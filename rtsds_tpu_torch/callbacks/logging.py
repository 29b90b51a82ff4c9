"""W&B and TensorBoard callbacks.

Both SDKs are imported when the callback is made, not with this module,
and a missing SDK degrades the callback to the console (W&B) or to nothing
(TensorBoard), as in the JAX package.  ``--wandb`` reads the W&B API key
from the environment, which ``utils/dotenv.py`` can fill from ``.env``.
"""

from __future__ import annotations

from rtsds_tpu_torch.callbacks.base import Callback


class WandBCallback(Callback):
    """``wandb.log`` of each batch's and epoch's logs, and of the per-class
    IoU table when validation ends."""

    def __init__(self, project_name: str, run_name: str | None = None,
                 config: dict | None = None, note: str = ""):
        try:
            import wandb
        except ImportError:
            print("wandb is not installed; WandBCallback degrades to console")
            self._wandb = None
            return
        self._wandb = wandb.init(project=project_name, name=run_name,
                                 config=config, notes=note)
        self._wandb_module = wandb

    def on_train_end(self, logs=None):
        if self._wandb is None:
            return
        print("The train finished completely and terminate the wandb logger.")
        self._wandb.finish()

    def on_batch_end(self, batch, logs=None):
        if self._wandb is not None and logs:
            self._wandb.log({**logs})

    def on_epoch_end(self, epoch, logs=None):
        if self._wandb is not None and logs:
            self._wandb.log({**logs})

    def on_validation_end(self, logs=None, data=None):
        if self._wandb is None:
            if logs:
                print("validation:", logs)
            return
        if logs:
            self._wandb.log(logs)
        if data is not None:
            table = self._wandb_module.Table(
                columns=["Class", "IoU"],
                data=[[name, f"{iou:.4f}"] for name, iou in data])
            self._wandb.log({"per class mIoU": table})


class TensorBoardCallback(Callback):
    """One scalar per epoch-log key, at the epoch's index."""

    def __init__(self, log_dir: str = "./logs"):
        try:
            from torch.utils.tensorboard import SummaryWriter
            self.writer = SummaryWriter(log_dir)
        except ImportError:
            print("tensorboard is not installed; TensorBoardCallback disabled")
            self.writer = None

    def on_epoch_end(self, epoch, logs=None):
        if self.writer is None or not logs:
            return
        for key, value in logs.items():
            try:
                self.writer.add_scalar(key, float(value), epoch)
            except (TypeError, ValueError):
                pass

    def on_train_end(self, logs=None):
        if self.writer is not None:
            self.writer.close()
