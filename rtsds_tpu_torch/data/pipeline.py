"""Host input pipeline: decode -> host resize -> batch -> threaded prefetch,
then device batches through the per-batch transform.

A thread pool decodes PNGs (PIL, imported where it is used) and resizes
each sample to the static training size on the host, so batches stack to
one shape; finished batches wait in a bounded queue while the previous step
runs on the device.  Normalization, augmentation, the RGB label remap and
the label clamp run on the device (:mod:`rtsds_tpu_torch.ops.preprocess`).

Raw GTA5 labels are colour-coded.  With ``decode_label_colors=True`` the
dataset returns them as (H, W, 3) uint8, nearest-resized, and the remap to
trainIds happens on the device.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from rtsds_tpu_torch.data.indexing import Sample


def _nearest_index(n_out: int, n_in: int) -> np.ndarray:
    """Source index ``floor(i * n_in / n_out)`` of each output index."""
    return np.minimum(np.arange(n_out) * n_in // n_out, n_in - 1)


def decode_image(path: str, size: tuple[int, int] | None = None
                 ) -> np.ndarray:
    """PNG -> (H, W, 3) uint8 RGB, resized on the host to ``size`` (H, W)
    with PIL's antialiased bilinear filter when it differs."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        if size is not None and (im.height, im.width) != tuple(size):
            im = im.resize((size[1], size[0]), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


def decode_label(path: str, size: tuple[int, int] | None = None,
                 rgb: bool = False) -> np.ndarray:
    """PNG -> (H, W) int32 trainIds, or (H, W, 3) uint8 colours with
    ``rgb``; resized nearest, so no id or colour is invented."""
    from PIL import Image

    with Image.open(path) as im:
        if rgb:
            im = im.convert("RGB")
        elif im.mode not in ("I", "I;16"):
            im = im.convert("L")
        arr = np.asarray(im)
    arr = arr.astype(np.uint8 if rgb else np.int32)
    if size is not None and arr.shape[:2] != tuple(size):
        h, w = arr.shape[:2]
        arr = arr[_nearest_index(size[0], h)][:, _nearest_index(size[1], w)]
    return arr


class SegmentationDataset:
    """Index + decode policy -> random-access (image, label) numpy pairs."""

    def __init__(self, samples: Sequence[Sample], image_size: tuple[int, int],
                 decode_label_colors: bool = False):
        self.samples = list(samples)
        self.image_size = tuple(image_size)
        self.decode_label_colors = decode_label_colors

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        s = self.samples[idx]
        image = decode_image(s.image, self.image_size)
        label = decode_label(s.label, self.image_size,
                             rgb=self.decode_label_colors)
        return image, label


class DataLoader:
    """Shuffling, batching, threaded-prefetch loader.

    Yields host numpy batches ``(images (N, H, W, 3) uint8, labels)``.  The
    shuffle of pass k is a function of ``(seed, k)`` alone, so
    :meth:`set_epoch` and :meth:`skip_batches` replay any position of a
    run.  ``infinite=True`` chains pass after pass, each with its own
    shuffle, for the domain-adaptation loop's endless streams.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 2, infinite: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.infinite = infinite
        self.seed = seed
        self._epoch = 0
        self._skip = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        """The next pass uses the shuffle of pass ``epoch``."""
        self._epoch = int(epoch)

    def skip_batches(self, k: int):
        """Drop the next ``k`` batches by index, before any decode."""
        self._skip = int(k)

    def _order(self, n: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(n)
        return np.random.default_rng((self.seed, self._epoch)).permutation(n)

    def _batch_indices(self) -> Iterator[np.ndarray]:
        n = len(self.dataset)
        stop = n - (n % self.batch_size) if self.drop_last else n
        if self.infinite and stop == 0:
            raise ValueError(f"an infinite loader needs at least one batch: "
                             f"{n} samples, batch size {self.batch_size}")
        while True:
            order = self._order(n)
            self._epoch += 1
            for i in range(0, stop, self.batch_size):
                if self._skip > 0:
                    self._skip -= 1
                    continue
                yield order[i:i + self.batch_size]
            if not self.infinite:
                return

    def _load_batch(self, pool: ThreadPoolExecutor, idxs: np.ndarray):
        pairs = list(pool.map(self.dataset.__getitem__, idxs))
        return (np.stack([p[0] for p in pairs]),
                np.stack([p[1] for p in pairs]))

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                try:
                    for idxs in self._batch_indices():
                        if stop.is_set():
                            return
                        q.put(self._load_batch(pool, idxs))
                except BaseException as e:  # re-raised in the consumer
                    q.put(e)
                finally:
                    q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while thread.is_alive():  # drain so the producer can exit
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass


def batch_generator(seed: int, epoch: int, index: int) -> torch.Generator:
    """The CPU generator of one batch's augmentation draws: a function of
    (seed, epoch, batch index) alone, so a resumed run draws what the
    uninterrupted run would have."""
    state = np.random.SeedSequence([seed, epoch, index]).generate_state(2)
    return torch.Generator().manual_seed(
        int(state[0]) << 32 | int(state[1]))


def device_batches(loader, transform: Callable, device: torch.device,
                   seed: int | None = None, epoch: int = 0,
                   start_index: int = 0
                   ) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """Host batches -> device tensors -> ``transform``.  With ``seed`` batch
    ``i`` gets :func:`batch_generator` ``(seed, epoch, start_index + i)``
    for augmentation.  Over an infinite loader this is an endless stream
    whose augmentation is a function of the seed and the global batch
    index; a resumed stream passes the count of batches already drawn as
    ``start_index``."""
    for i, (images, labels) in enumerate(loader, start_index):
        images = torch.from_numpy(images).to(device, non_blocking=True)
        labels = torch.from_numpy(labels).to(device, non_blocking=True)
        if seed is None:
            yield transform(images, labels)
        else:
            yield transform(images, labels, batch_generator(seed, epoch, i))
