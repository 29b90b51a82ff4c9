"""Validation figures: input, ground truth and prediction side by side.

matplotlib is imported only when a figure is drawn, with the Agg backend;
without it the three panels of each row are written as PNGs with PIL.
Without either, drawing raises ``ImportError`` naming both.
"""

from __future__ import annotations

import os

import numpy as np

from rtsds_tpu_torch.utils.colors import apply_color_map


def rescale_for_display(x: np.ndarray) -> np.ndarray:
    """Min-max rescale to [0, 1]."""
    x = np.asarray(x, dtype=np.float32)
    lo, hi = x.min(), x.max()
    if hi <= lo:
        return np.zeros_like(x)
    return (x - lo) / (hi - lo)


def visualize_batches(inputs_list, targets_list, predictions,
                      num_batches: int = 5, save_path: str | None = None):
    """A 3-column grid (input, colorized ground truth, colorized
    prediction) of the first frame of each of the first ``num_batches``
    batches.  Inputs are (N, H, W, 3) float arrays, targets and
    predictions (N, H, W) trainIds, all host numpy arrays.

    Returns the matplotlib figure, or None without matplotlib, in which
    case each row's panels are written as PNGs next to ``save_path``.
    """
    num_batches = min(num_batches, len(inputs_list))
    triplets = []
    for idx in range(num_batches):
        img = rescale_for_display(np.asarray(inputs_list[idx][0]))
        gt = apply_color_map(np.asarray(targets_list[idx][0]))
        pred = apply_color_map(np.asarray(predictions[idx][0]))
        triplets.append((img, gt, pred))

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        if save_path:
            _save_raw(triplets, save_path)
        return None

    fig, axes = plt.subplots(nrows=num_batches, ncols=3,
                             figsize=(18, num_batches * 6), squeeze=False)
    titles = ("Input Image", "Ground Truth", "Prediction")
    for row, (img, gt, pred) in enumerate(triplets):
        for col, (panel, title) in enumerate(zip((img, gt, pred), titles)):
            ax = axes[row][col]
            ax.imshow(panel)
            ax.set_title(title)
            ax.axis("off")
    fig.tight_layout()
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path)
    return fig


def _save_raw(triplets, save_path: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("drawing validation images needs matplotlib or "
                          "PIL (Pillow); neither is installed") from e

    base, _ = os.path.splitext(save_path)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    for row, (img, gt, pred) in enumerate(triplets):
        Image.fromarray((img * 255).astype(np.uint8)).save(
            f"{base}_{row}_input.png")
        Image.fromarray(gt).save(f"{base}_{row}_gt.png")
        Image.fromarray(pred).save(f"{base}_{row}_pred.png")
