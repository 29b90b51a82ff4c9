"""Supervised training CLI of the port, flag-compatible with ``main.py``.

    python -m rtsds_tpu_torch.cli --config <yaml> --dataset gta5 [--augmented]

trains BiSeNet on GTA5 (or Cityscapes) and validates on Cityscapes every
``training.segmentation.do_validation`` epochs, saving the best model
(``callbacks.model_checkpoint``).  ``--resume`` continues from the latest
checkpoint; ``--validate_only`` restores the best (else the latest) one
and reports its mIoU; ``--synthetic`` runs on generated data.  Raw GTA5
labels (``data.gta5_modified.decode_label_colors: true``) are remapped to
trainIds on the device.

The config's ``device`` key picks the device: ``cpu`` is the CPU, anything
else the GPU, which raises when there is none.  Features of the JAX CLI
that are not ported yet exit with a message saying so.
"""

from __future__ import annotations

import argparse
from functools import partial

import torch

from rtsds_tpu_torch.config import load_config, parse_int_list
from rtsds_tpu_torch.device import resolve_device


def argument_parser(argv=None):
    parser = argparse.ArgumentParser(
        description="Semantic segmentation training (PyTorch/CUDA)")
    parser.add_argument("--config", type=str, default=None,
                        help="Path to the config file (YAML).")
    parser.add_argument("--dataset", type=str, default="cityscapes",
                        choices=["cityscapes", "gta5"],
                        help="Training set: cityscapes or gta5.")
    parser.add_argument("--augmented", action="store_true",
                        help="Apply augmentation (GTA5 dataset only).")
    parser.add_argument("--model", type=str, default="bisenet",
                        help="Segmentation model: bisenet.")
    parser.add_argument("--seed", type=int, default=42,
                        help="Seed of the init, shuffles and augmentation.")
    parser.add_argument("--synthetic", action="store_true",
                        help="Run on synthetic data instead of the datasets.")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from the latest checkpoint.")
    parser.add_argument("--validate_only", action="store_true",
                        help="Restore the best (else latest) checkpoint and "
                             "validate once; no training.")
    for flag in ("--domain_adaptation", "--multihost", "--wandb", "--debug"):
        parser.add_argument(flag, action="store_true",
                            help="Not ported yet.")
    return parser.parse_args(argv)


def _not_ported(what: str) -> SystemExit:
    return SystemExit(f"{what} is not ported yet to rtsds_tpu_torch; use "
                      f"the JAX package (python main.py) for it")


def _enabled(node) -> bool:
    return bool(node and node.get("enabled", False))


def check_ported(args, config) -> None:
    """Exit on every flag or config switch the port does not run yet, and
    say what is skipped."""
    for flag in ("domain_adaptation", "multihost", "wandb", "debug"):
        if getattr(args, flag):
            raise _not_ported(f"--{flag}")
    if args.model == "deeplab":
        raise _not_ported("DeepLabV2 training (--model deeplab)")
    if args.model != "bisenet":
        raise SystemExit(
            "Invalid model name. Please select deeplab or bisenet")
    criterion = config.model["bisenet"]["criterion"].get("name")
    if criterion != "CrossEntropy":
        raise SystemExit(f"model.bisenet.criterion.name {criterion!r}: the "
                         f"supervised step trains with CrossEntropy")
    tcfg = config.training["segmentation"]
    if int(tcfg.get("accumulate_steps", 1)) > 1:
        raise _not_ported("training.segmentation.accumulate_steps > 1")
    for key in ("ema", "distillation"):
        if _enabled(tcfg.get(key)):
            raise _not_ported(f"training.segmentation.{key}")
    vcfg = config.get("validation") or {}
    for key in ("ensemble", "sliding"):
        if _enabled(vcfg.get(key)):
            raise _not_ported(f"the validation.{key} protocol")
    mesh = dict(config.get("mesh") or {})
    if any(int(mesh.get(axis, 1) or 1) > 1
           for axis in ("spatial", "model", "pipe")):
        raise _not_ported(f"mesh {mesh}")
    if config.callbacks.get("history"):
        raise _not_ported("callbacks.history")
    if config.callbacks.get("images_plots"):
        print("callbacks.images_plots is not ported yet to rtsds_tpu_torch: "
              "no validation images are written")
    if config.get("compilation_cache"):
        print("compilation_cache is an XLA setting; rtsds_tpu_torch ignores "
              "it")


def device_from_config(config) -> torch.device:
    """``device: cpu`` -> the CPU; anything else -> the GPU (or raise)."""
    if str(config.get("device", "cuda")).lower() == "cpu":
        return torch.device("cpu")
    return resolve_device(None)


def datasets_loader(config, is_augmented: bool, synthetic: bool = False,
                    seed: int = 42) -> dict:
    """Host loaders of Cityscapes train/val and GTA5, and their device
    transforms (``make_transform``) and sizes."""
    from rtsds_tpu_torch.data.indexing import (
        build_cityscapes_index, build_gta5_index)
    from rtsds_tpu_torch.data.pipeline import DataLoader, SegmentationDataset
    from rtsds_tpu_torch.data.synthetic import (
        ColorCodedLabels, SyntheticSegDataset)
    from rtsds_tpu_torch.ops.augment import AugmentConfig
    from rtsds_tpu_torch.ops.preprocess import make_transform
    from rtsds_tpu_torch.utils.colors import class_colors_for_remap

    cs = config.data["cityscapes"]
    gta5 = config.data["gta5_modified"]
    cs_size = tuple(parse_int_list(cs["image_size"]))
    gta5_size = tuple(parse_int_list(gta5["image_size"]))
    decode_colors = bool(gta5.get("decode_label_colors", False))

    if synthetic:
        fx = bool(config.data.get("synthetic", {}).get("fixed_tints", False))
        cs_train_ds = SyntheticSegDataset(16, cs_size, cs["num_classes"],
                                          seed, fixed_tints=fx)
        cs_val_ds = SyntheticSegDataset(8, cs_size, cs["num_classes"],
                                        seed + 1, fixed_tints=fx)
        gta5_ds = SyntheticSegDataset(16, gta5_size, gta5["num_classes"],
                                      seed + 2, fixed_tints=fx)
        if decode_colors:
            gta5_ds = ColorCodedLabels(gta5_ds, class_colors_for_remap(),
                                       unmatched=0.01, seed=seed)
    else:
        cs_train_ds = SegmentationDataset(
            build_cityscapes_index(cs["segmentation_train_dir"],
                                   cs["images_train_dir"]), cs_size)
        cs_val_ds = SegmentationDataset(
            build_cityscapes_index(cs["segmentation_val_dir"],
                                   cs["images_val_dir"]), cs_size)
        gta5_ds = SegmentationDataset(
            build_gta5_index(gta5["images_dir"], gta5["segmentation_dir"]),
            gta5_size, decode_label_colors=decode_colors)

    aug_cfg = AugmentConfig.from_config(config) if is_augmented else None
    correct = bool(config.data.get("correct_preprocessing", False))
    mk = partial(DataLoader, num_workers=cs["num_workers"], seed=seed)
    return {
        "cs_train": mk(cs_train_ds, cs["batch_size"], shuffle=True),
        "cs_val": mk(cs_val_ds, cs["batch_size"], shuffle=False,
                     drop_last=False),
        "gta5_train": mk(gta5_ds, gta5["batch_size"], shuffle=True),
        "cs_transform": make_transform(cs_size, cs["num_classes"],
                                       antialias=True,
                                       correct_preprocessing=correct),
        "gta5_transform": make_transform(gta5_size, gta5["num_classes"],
                                         antialias=False,
                                         augment_cfg=aug_cfg,
                                         correct_preprocessing=correct,
                                         decode_label_colors=decode_colors),
        "cs_size": cs_size,
        "gta5_size": gta5_size,
    }


def build_callbacks(config):
    """(callbacks, checkpoint) from ``config.callbacks``; a section set to
    null is off."""
    from rtsds_tpu_torch.callbacks.checkpoint import (
        EarlyStopping, ModelCheckpoint)

    cb_cfg = config.callbacks
    callbacks = []
    checkpoint = None
    if cb_cfg.get("model_checkpoint"):
        mc = cb_cfg["model_checkpoint"]
        checkpoint = ModelCheckpoint(
            save_dir=mc["save_dir"], save_name=mc["save_name"],
            save_best=bool(mc.get("save_best", True)),
            monitor=mc.get("monitor", "validation_mIoU"),
            mode=mc.get("mode", "max"),
            save_freq=int(mc.get("save_freq", 1)))
    if cb_cfg.get("early_stopping"):
        es = cb_cfg["early_stopping"]
        callbacks.append(EarlyStopping(
            monitor=es.get("monitor", "validation_mIoU"),
            mode=es.get("mode", "max"),
            patience=int(es.get("patience", 5))))
    return callbacks, checkpoint


def run_validation_only(state, checkpoint, val_batches, num_classes: int,
                        class_names, device) -> float:
    """Restore the best (else latest) checkpoint and validate once."""
    from rtsds_tpu_torch.eval.validate import make_eval_step, validate

    if checkpoint is None:
        raise SystemExit("--validate_only needs a callbacks.model_checkpoint "
                         "config section to locate the checkpoint")
    mgr = checkpoint.manager
    step = mgr.best_step()
    if step is None:
        step = mgr.latest_step()
    if step is None:
        raise SystemExit(f"--validate_only: no checkpoint found under "
                         f"{checkpoint.save_dir}")
    if not mgr.restore({"model": state}, step=step):
        raise SystemExit(f"--validate_only: checkpoint at epoch {step} under "
                         f"{checkpoint.save_dir} does not match this run's "
                         f"model")
    eval_step = make_eval_step(state.model, num_classes,
                               compute_dtype=state.compute_dtype)
    miou, _ = validate(state.model, val_batches(0), num_classes,
                       class_names=class_names, detailed_report=True,
                       eval_step=eval_step, device=device)
    print(f"validate_only: checkpoint epoch {step} -> "
          f"validation_mIoU = {miou:.6f}")
    return miou


def main(argv=None):
    """Returns the training history (a list of per-validation dicts), or
    the mIoU with ``--validate_only``."""
    from rtsds_tpu_torch.data.pipeline import device_batches
    from rtsds_tpu_torch.train.factory import build_supervised
    from rtsds_tpu_torch.train.loop import supervised_fit
    from rtsds_tpu_torch.train.supervised import make_train_step

    args = argument_parser(argv)
    config = load_config(args.config)
    check_ported(args, config)
    device = device_from_config(config)
    data = datasets_loader(config, is_augmented=args.augmented,
                           synthetic=args.synthetic, seed=args.seed)
    callbacks, checkpoint = build_callbacks(config)
    class_names = list(config.meta["class_names"])

    if args.dataset == "gta5":
        print(" ------> Training on GTA5, validating on Cityscapes ------ ")
        train_loader = data["gta5_train"]
        train_transform = data["gta5_transform"]
        augment = args.augmented
    else:
        train_loader = data["cs_train"]
        train_transform = data["cs_transform"]
        augment = False

    tcfg = config.training["segmentation"]
    num_classes = int(tcfg["num_classes"])
    state = build_supervised(config, args.model, len(train_loader), device,
                             seed=args.seed)
    ignore_index = config.model["bisenet"]["criterion"].get("ignore_index")
    train_step = make_train_step(ignore_index=ignore_index)

    def train_batches(epoch):
        return device_batches(train_loader, train_transform, device,
                              seed=args.seed if augment else None,
                              epoch=epoch)

    def val_batches(_epoch):
        return device_batches(data["cs_val"], data["cs_transform"], device)

    if args.validate_only:
        return run_validation_only(state, checkpoint, val_batches,
                                   num_classes, class_names, device)

    start_epoch = 0
    if args.resume and checkpoint is not None:
        _, start_epoch = checkpoint.resume({"model": state})
        # the resumed epochs see the shuffles the uninterrupted run drew
        train_loader.set_epoch(start_epoch)

    _, history = supervised_fit(
        state, train_step, train_batches, val_batches,
        epochs=int(tcfg["epochs"]), num_classes=num_classes,
        class_names=class_names, callbacks=callbacks,
        do_validation=int(tcfg["do_validation"]), checkpoint=checkpoint,
        start_epoch=start_epoch, device=device)
    return history


if __name__ == "__main__":
    main()
