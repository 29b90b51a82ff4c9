"""Training CLI of the port, flag-compatible with ``main.py``.

    python -m rtsds_tpu_torch.cli --config <yaml> --dataset gta5 [--augmented]
    python -m rtsds_tpu_torch.cli --config <yaml> --domain_adaptation \
        [--augmented]

The first trains BiSeNet on GTA5 (or Cityscapes) and validates on
Cityscapes every ``training.segmentation.do_validation`` epochs, saving the
best model (``callbacks.model_checkpoint``).  The second runs adversarial
GTA5 -> Cityscapes domain adaptation (``training.domain_adaptation``:
``variant`` v1 or v2, ``model.adversarial_model.discriminator.grl`` for
the gradient-reversal step): ``iterations`` generator/discriminator steps
per epoch on endless source and target streams, the generator validated on
Cityscapes, checkpoints of both networks under ``<save_name>_da``.
``--resume`` continues from the latest checkpoint; ``--validate_only``
restores the best (else the latest) one and reports its mIoU;
``--synthetic`` runs on generated data.  Raw GTA5 labels
(``data.gta5_modified.decode_label_colors: true``) are remapped to
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
    parser.add_argument("--domain_adaptation", action="store_true",
                        help="Adversarial GTA5 -> Cityscapes domain "
                             "adaptation instead of supervised training.")
    for flag in ("--multihost", "--wandb", "--debug"):
        parser.add_argument(flag, action="store_true",
                            help="Not ported yet.")
    return parser.parse_args(argv)


def _not_ported(what: str) -> SystemExit:
    return SystemExit(f"{what} is not ported yet to rtsds_tpu_torch; use "
                      f"the JAX package (python main.py) for it")


def _enabled(node) -> bool:
    return bool(node and node.get("enabled", False))


def _check_supervised(args, config) -> None:
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


def _check_domain_adaptation(config) -> None:
    tcfg = config.training["domain_adaptation"]
    adv = config.model["adversarial_model"]
    self_training = _enabled(tcfg.get("self_training"))
    grl = _enabled(adv["discriminator"].get("grl"))
    if grl and self_training:
        raise SystemExit("discriminator.grl does not compose with "
                         "self_training (one joint backward vs the "
                         "teacher-student step); disable one")
    if grl and str(tcfg.get("variant", "v1")) != "v1":
        raise SystemExit("discriminator.grl composes with the v1 "
                         "adversarial step only; set variant: v1")
    for key in ("self_training", "ema", "entropy_min", "fda"):
        if _enabled(tcfg.get(key)):
            raise _not_ported(f"training.domain_adaptation.{key}")
    if adv["generator"]["name"] == "deeplab":
        raise _not_ported("a DeepLabV2 generator "
                          "(model.adversarial_model.generator.name)")
    for net, want in (("generator", "CrossEntropy"),
                      ("discriminator", "BCEWithLogits")):
        name = adv[net]["criterion"].get("name")
        if name != want:
            raise SystemExit(f"model.adversarial_model.{net}.criterion.name "
                             f"{name!r}: the adversarial step trains the "
                             f"{net} with {want}")


def check_ported(args, config) -> None:
    """Exit on every flag or config switch the port does not run yet, and
    say what is skipped."""
    for flag in ("multihost", "wandb", "debug"):
        if getattr(args, flag):
            raise _not_ported(f"--{flag}")
    if args.domain_adaptation:
        _check_domain_adaptation(config)
    else:
        _check_supervised(args, config)
    vcfg = config.get("validation") or {}
    for key in ("ensemble", "sliding"):
        if _enabled(vcfg.get(key)):
            raise _not_ported(f"the validation.{key} protocol")
    mesh = dict(config.get("mesh") or {})
    if any(int(mesh.get(axis, 1) or 1) > 1
           for axis in ("data", "spatial", "model", "pipe")):
        raise _not_ported(f"mesh {mesh} (the port runs on one device)")
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
                    seed: int = 42, infinite: bool = False) -> dict:
    """Host loaders of Cityscapes train/val and GTA5, and their device
    transforms (``make_transform``) and sizes.  ``infinite`` makes the two
    training loaders endless, for domain adaptation."""
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
        "cs_train": mk(cs_train_ds, cs["batch_size"], shuffle=True,
                       infinite=infinite),
        "cs_val": mk(cs_val_ds, cs["batch_size"], shuffle=False,
                     drop_last=False),
        "gta5_train": mk(gta5_ds, gta5["batch_size"], shuffle=True,
                         infinite=infinite),
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


def build_callbacks(config, mode_suffix: str = ""):
    """(callbacks, checkpoint) from ``config.callbacks``; a section set to
    null is off.  Checkpoints go to ``<save_name><mode_suffix>``, so
    supervised and domain-adaptation runs of one config keep apart."""
    from rtsds_tpu_torch.callbacks.checkpoint import (
        EarlyStopping, ModelCheckpoint)

    cb_cfg = config.callbacks
    callbacks = []
    checkpoint = None
    if cb_cfg.get("model_checkpoint"):
        mc = cb_cfg["model_checkpoint"]
        checkpoint = ModelCheckpoint(
            save_dir=mc["save_dir"], save_name=mc["save_name"] + mode_suffix,
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


def run_validation_only(states: dict, which: str, checkpoint, val_batches,
                        num_classes: int, class_names, device) -> float:
    """Restore the best (else latest) checkpoint into ``states`` and
    validate ``states[which]`` once."""
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
    if not mgr.restore(states, step=step):
        raise SystemExit(f"--validate_only: checkpoint at epoch {step} under "
                         f"{checkpoint.save_dir} does not match this run's "
                         f"model")
    state = states[which]
    eval_step = make_eval_step(state.model, num_classes,
                               compute_dtype=state.compute_dtype)
    miou, _ = validate(state.model, val_batches(0), num_classes,
                       class_names=class_names, detailed_report=True,
                       eval_step=eval_step, device=device)
    print(f"validate_only: checkpoint epoch {step} -> "
          f"validation_mIoU = {miou:.6f}")
    return miou


def run_domain_adaptation(args, config, data, callbacks, checkpoint,
                          class_names, device):
    """The ``--domain_adaptation`` branch: returns the history, or the mIoU
    with ``--validate_only``."""
    from rtsds_tpu_torch.data.pipeline import device_batches
    from rtsds_tpu_torch.train.adversarial import make_adversarial_step
    from rtsds_tpu_torch.train.factory import build_adversarial
    from rtsds_tpu_torch.train.loop import adversarial_fit

    tcfg = config.training["domain_adaptation"]
    num_classes = int(tcfg["num_classes"])
    iterations = int(tcfg["iterations"])
    gen_state, dis_state = build_adversarial(config, device, seed=args.seed)
    states = {"generator": gen_state, "discriminator": dis_state}

    def val_batches(_epoch):
        return device_batches(data["cs_val"], data["cs_transform"], device)

    if args.validate_only:
        return run_validation_only(states, "generator", checkpoint,
                                   val_batches, num_classes, class_names,
                                   device)

    start_epoch = 0
    if args.resume and checkpoint is not None:
        _, start_epoch = checkpoint.resume(states)
    # fast-forward both streams past the batches the finished epochs drew,
    # so the resumed run draws the shuffles and augmentation the
    # uninterrupted run would have
    consumed = start_epoch * iterations
    for loader in (data["gta5_train"], data["cs_train"]):
        per_pass = max(len(loader), 1)
        loader.set_epoch(consumed // per_pass)
        loader.skip_batches(consumed % per_pass)
    source_iter = device_batches(
        data["gta5_train"], data["gta5_transform"], device,
        seed=args.seed if args.augmented else None, start_index=consumed)
    target_iter = device_batches(data["cs_train"], data["cs_transform"],
                                 device)

    grl_cfg = config.model["adversarial_model"]["discriminator"].get("grl")
    da_step = make_adversarial_step(
        lambda_=float(tcfg["lambda"]), iterations=iterations,
        epochs=int(tcfg["epochs"]),
        ignore_index=config.model["bisenet"]["criterion"].get("ignore_index"),
        variant=str(tcfg.get("variant", "v1")),
        grl_alpha=(float(grl_cfg.get("alpha", 0.1)) if _enabled(grl_cfg)
                   else 0.0))
    try:
        _, _, history = adversarial_fit(
            gen_state, dis_state, da_step, source_iter, target_iter,
            val_batches, iterations=iterations, epochs=int(tcfg["epochs"]),
            num_classes=num_classes, class_names=class_names,
            callbacks=callbacks, do_validation=int(tcfg["do_validation"]),
            checkpoint=checkpoint, when_print=int(tcfg.get("when_print", -1)),
            start_epoch=start_epoch, device=device)
    finally:
        # stops the loaders' prefetch threads
        source_iter.close()
        target_iter.close()
    return history


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
                           synthetic=args.synthetic, seed=args.seed,
                           infinite=args.domain_adaptation)
    callbacks, checkpoint = build_callbacks(
        config, mode_suffix="_da" if args.domain_adaptation else "")
    class_names = list(config.meta["class_names"])

    if args.domain_adaptation:
        return run_domain_adaptation(args, config, data, callbacks,
                                     checkpoint, class_names, device)

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
        return run_validation_only({"model": state}, "model", checkpoint,
                                   val_batches, num_classes, class_names,
                                   device)

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
