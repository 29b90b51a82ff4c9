"""The port's host data pipeline against the JAX package's: batch order,
``set_epoch``, ``skip_batches``, endless loaders and a resumed augmented
stream, and PNG decoding with
``decode_label_colors`` (RGB labels kept for the device remap here,
remapped on the host there).  Exact."""

import numpy as np
import pytest
import torch
from PIL import Image

from rtsds_tpu.data.indexing import build_cityscapes_index as jax_cs_index
from rtsds_tpu.data.indexing import build_gta5_index as jax_gta5_index
from rtsds_tpu.data.pipeline import DataLoader as JaxDataLoader
from rtsds_tpu.data.pipeline import SegmentationDataset as JaxDataset
from rtsds_tpu_torch.data.indexing import (
    build_cityscapes_index, build_gta5_index)
from rtsds_tpu_torch.data.pipeline import (
    DataLoader, SegmentationDataset, batch_generator, device_batches)
from rtsds_tpu_torch.data.synthetic import ColorCodedLabels, SyntheticSegDataset
from rtsds_tpu_torch.ops.augment import AugmentConfig
from rtsds_tpu_torch.ops.preprocess import make_transform
from rtsds_tpu_torch.ops.remap import rgb_to_train_ids
from rtsds_tpu_torch.utils.colors import class_colors_for_remap


class _Indexed:
    """Sample i is an image filled with i and a label filled with i."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.full((2, 3, 3), i, np.uint8),
                np.full((2, 3), i, np.int32))


def _ids(loader, n_batches=None):
    out = []
    for images, labels in loader:
        assert (images[:, 0, 0, 0] == labels[:, 0, 0]).all()
        out.append(labels[:, 0, 0].tolist())
        if n_batches is not None and len(out) == n_batches:
            break
    return out


@pytest.mark.parametrize("kwargs", [
    {"batch_size": 3, "shuffle": True, "seed": 7},
    {"batch_size": 3, "shuffle": False},
    {"batch_size": 4, "shuffle": True, "seed": 1, "drop_last": False},
])
def test_loader_order_matches_jax(kwargs):
    ours = DataLoader(_Indexed(10), num_workers=2, **kwargs)
    theirs = JaxDataLoader(_Indexed(10), num_workers=2, **kwargs)
    assert len(ours) == len(theirs)
    for epoch in range(2):  # consecutive passes reshuffle alike
        assert _ids(ours) == _ids(theirs), epoch


def test_set_epoch_and_skip_batches_match_jax():
    ours = DataLoader(_Indexed(11), 2, seed=3, num_workers=2)
    theirs = JaxDataLoader(_Indexed(11), 2, seed=3, num_workers=2)
    for loader in (ours, theirs):
        loader.set_epoch(4)
        loader.skip_batches(3)
    got, want = _ids(ours), _ids(theirs)
    assert got == want and len(got) == 2
    assert _ids(ours) == _ids(theirs)  # the next pass: epoch 5, no skip
    fresh = DataLoader(_Indexed(11), 2, seed=3, num_workers=2)
    fresh.set_epoch(4)
    assert got == _ids(fresh)[3:5]


@pytest.mark.parametrize("drop_last", [True, False])
def test_infinite_loader_matches_jax(drop_last):
    """Pass after pass, each with its own shuffle, as the JAX loader's
    ``infinite=True`` draws them; a resumed loader continues the stream."""
    kwargs = {"batch_size": 3, "seed": 5, "num_workers": 2,
              "drop_last": drop_last, "infinite": True}
    ours = _ids(DataLoader(_Indexed(10), **kwargs), 11)
    assert ours == _ids(JaxDataLoader(_Indexed(10), **kwargs), 11)
    per_pass = 3 if drop_last else 4
    assert ours[:per_pass] != ours[per_pass:2 * per_pass]
    resumed = DataLoader(_Indexed(10), **kwargs)
    resumed.set_epoch(7 // per_pass)
    resumed.skip_batches(7 % per_pass)
    assert _ids(resumed, 4) == ours[7:11]
    with pytest.raises(ValueError, match="at least one batch"):
        next(iter(DataLoader(_Indexed(2), 3, num_workers=1, infinite=True)))


def test_resumed_stream_draws_the_same_batches_and_augmentation():
    """An endless augmented stream resumed at batch k (the loader fast-
    forwarded, ``start_index=k``) yields what the uninterrupted stream
    yielded from batch k on."""
    ds = SyntheticSegDataset(6, (16, 24), seed=4)
    transform = make_transform((16, 24), 19, augment_cfg=AugmentConfig(
        apply_p=1.0, blur_kernel=(3, 5)))

    def stream(skip):
        loader = DataLoader(ds, 2, seed=9, num_workers=1, infinite=True)
        loader.set_epoch(skip // len(loader))
        loader.skip_batches(skip % len(loader))
        batches = device_batches(loader, transform, torch.device("cpu"),
                                 seed=1, start_index=skip)
        try:
            return [next(batches) for _ in range(7 - skip)]
        finally:
            batches.close()

    full, resumed = stream(0), stream(4)
    for (a_img, a_lbl), (b_img, b_lbl) in zip(full[4:], resumed):
        assert torch.equal(a_img, b_img) and torch.equal(a_lbl, b_lbl)
    # the stream is a function of the global index, not of the pass
    assert not torch.equal(full[0][0], full[3][0])


def test_loader_reraises_a_failed_load():
    class Broken(_Indexed):
        def __getitem__(self, i):
            raise OSError(f"cannot read sample {i}")

    with pytest.raises(OSError, match="cannot read"):
        list(DataLoader(Broken(4), 2, num_workers=2))


def _write_gta5(root, n, size, label_size):
    rng = np.random.default_rng(0)
    table = class_colors_for_remap()
    (root / "images").mkdir()
    (root / "labels").mkdir()
    for i in range(n):
        image = rng.integers(0, 256, (*size, 3), dtype=np.uint8)
        ids = rng.integers(0, 19, label_size)
        rgb = table[ids]
        rgb[rng.random(label_size) < 0.1] = (1, 2, 3)  # no class key
        Image.fromarray(image).save(root / "images" / f"{i:05d}.png")
        Image.fromarray(rgb.astype(np.uint8)).save(
            root / "labels" / f"{i:05d}.png")
    return str(root / "images"), str(root / "labels")


@pytest.mark.parametrize("label_size", [(24, 40), (37, 61)])
def test_gta5_rgb_labels_match_jax_after_the_remap(tmp_path, label_size):
    size = (24, 40)
    images_dir, labels_dir = _write_gta5(tmp_path, 3, size, label_size)
    samples = build_gta5_index(images_dir, labels_dir)
    assert samples == [type(samples[0])(*s.__dict__.values())
                       for s in jax_gta5_index(images_dir, labels_dir)]
    ours = SegmentationDataset(samples, size, decode_label_colors=True)
    theirs = JaxDataset(jax_gta5_index(images_dir, labels_dir), size,
                        decode_label_colors=True)
    for i in range(len(ours)):
        image, rgb = ours[i]
        want_image, want_ids = theirs[i]
        assert rgb.dtype == np.uint8 and rgb.shape == (*size, 3)
        np.testing.assert_array_equal(image, want_image)
        ids = rgb_to_train_ids(torch.from_numpy(rgb)).numpy()
        np.testing.assert_array_equal(ids, want_ids)
        assert (ids == 255).any()


def test_trainid_labels_and_cityscapes_index_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    img_dir, lbl_dir = tmp_path / "img" / "aachen", tmp_path / "gt" / "aachen"
    img_dir.mkdir(parents=True)
    lbl_dir.mkdir(parents=True)
    for i in range(2):
        stem = f"aachen_{i:06d}_000019"
        Image.fromarray(rng.integers(0, 256, (20, 36, 3), dtype=np.uint8)
                        ).save(img_dir / f"{stem}_leftImg8bit.png")
        Image.fromarray(rng.integers(0, 19, (20, 36)).astype(np.uint8)).save(
            lbl_dir / f"{stem}_gtFine_labelTrainIds.png")
        Image.fromarray(rng.integers(0, 256, (20, 36, 3), dtype=np.uint8)
                        ).save(lbl_dir / f"{stem}_gtFine_color.png")
    args = (str(tmp_path / "gt"), str(tmp_path / "img"))
    samples = build_cityscapes_index(*args)
    assert [s.label for s in samples] == [s.label
                                          for s in jax_cs_index(*args)]
    assert all(s.color_label.endswith("color.png") for s in samples)
    for size in ((20, 36), (15, 27)):
        ours = SegmentationDataset(samples, size)[1]
        theirs = JaxDataset(jax_cs_index(*args), size)[1]
        assert ours[1].dtype == np.int32 and ours[1].shape == size
        np.testing.assert_array_equal(ours[1], theirs[1])
        if size == (20, 36):  # no resize: the decoded pixels themselves
            np.testing.assert_array_equal(ours[0], theirs[0])


def test_device_batches_remap_colour_coded_labels():
    plain = SyntheticSegDataset(4, (16, 32), seed=2)
    ds = ColorCodedLabels(plain, class_colors_for_remap(), unmatched=0.1)
    loader = DataLoader(ds, 2, shuffle=False, num_workers=1)
    transform = make_transform((16, 32), 19, decode_label_colors=True)
    batches = list(device_batches(loader, transform, torch.device("cpu")))
    assert len(batches) == 2
    for b, (_, labels) in enumerate(batches):
        want = np.stack([plain[2 * b + i][1] for i in range(2)])
        got = labels.numpy()
        keep = got != 19  # the unmatched pixels clamp to the ignored id
        np.testing.assert_array_equal(got[keep], want[keep])
        assert (~keep).mean() > 0.05
    a = batch_generator(1, 2, 3).initial_seed()
    assert a == batch_generator(1, 2, 3).initial_seed()
    assert a != batch_generator(1, 2, 4).initial_seed()
