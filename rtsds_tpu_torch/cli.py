"""Training CLI of the port, flag-compatible with ``main.py``.

    python -m rtsds_tpu_torch.cli --config <yaml> --dataset gta5 [--augmented]
    python -m rtsds_tpu_torch.cli --config <yaml> --domain_adaptation \
        [--augmented]

The first trains BiSeNet (or DeepLabV2, ``--model deeplab``) on GTA5 (or
Cityscapes) and validates on Cityscapes every
``training.segmentation.do_validation`` epochs, saving the best model
(``callbacks.model_checkpoint``); ``training.segmentation`` may add
``accumulate_steps`` (gradient accumulation), ``ema`` (an exponential
moving average of the weights, validated on and checkpointed) or
``distillation`` (a frozen teacher's soft classes; ``teacher.quantize:
int8`` runs the teacher through the W8A8 int8 path).  The second runs
adversarial GTA5 -> Cityscapes domain adaptation
(``training.domain_adaptation``: ``variant`` v1 or v2,
``model.adversarial_model.discriminator.grl`` for the gradient-reversal
step, and ``ema``, ``entropy_min`` (MinEnt), ``fda`` and
``self_training``, the mean-teacher pseudo-label step with CBST
calibration and ClassMix): ``iterations`` generator/discriminator steps
per epoch on endless source and target streams, the generator
(``model.adversarial_model.generator.name``: bisenet or deeplab) validated
on Cityscapes, checkpoints of both networks under ``<save_name>_da``.
Validation takes the ``validation.ensemble`` or ``validation.sliding``
protocol when one is enabled.
``--resume`` continues from the latest checkpoint; ``--validate_only``
restores the best (else the latest) one and reports its mIoU;
``--synthetic`` runs on generated data.  Raw GTA5 labels
(``data.gta5_modified.decode_label_colors: true``) are remapped to
trainIds on the device.

The config's ``device`` key picks the device: ``cpu`` is the CPU, anything
else the GPU, which raises when there is none.  Features of the JAX CLI
that are not ported yet (a mesh of more than one device, ``--multihost``,
``--wandb``, ``--debug``, ``callbacks.history``) exit with a message
saying so.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
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
                        help="Segmentation model: bisenet or deeplab.")
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
    if args.model not in ("bisenet", "deeplab"):
        raise SystemExit(
            "Invalid model name. Please select deeplab or bisenet")
    criterion = config.model[args.model]["criterion"].get("name")
    if criterion != "CrossEntropy":
        raise SystemExit(f"model.{args.model}.criterion.name {criterion!r}: "
                         f"the supervised step trains with CrossEntropy")
    dist_cfg = config.training["segmentation"].get("distillation")
    if _enabled(dist_cfg):
        t_cfg = dist_cfg.get("teacher") or {}
        quantize = t_cfg.get("quantize") or None
        if quantize not in (None, "int8"):
            raise SystemExit(f"distillation.teacher.quantize {quantize!r} is "
                             f"not supported (null or int8)")
        n_calib = int(t_cfg.get("calib_batches", 2))
        if quantize and n_calib < 1:
            raise SystemExit("distillation.teacher.calib_batches "
                             f"{n_calib} must be >= 1")


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
    if _enabled(vcfg.get("ensemble")) and _enabled(vcfg.get("sliding")):
        raise SystemExit("validation.ensemble and validation.sliding are "
                         "mutually exclusive; enable at most one")
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


def build_eval_step(config, state, image_size: tuple[int, int],
                    num_classes: int):
    """The validation step of ``state``'s model at ``image_size``: the
    ``validation.ensemble`` or ``validation.sliding`` protocol when one is
    enabled, else the plain forward."""
    from rtsds_tpu_torch.config import parse_float_list
    from rtsds_tpu_torch.eval.ensemble import make_ensemble_eval_step
    from rtsds_tpu_torch.eval.sliding import make_sliding_eval_step
    from rtsds_tpu_torch.eval.validate import make_eval_step

    vcfg = config.get("validation") or {}
    ens, sld = vcfg.get("ensemble"), vcfg.get("sliding")
    kwargs = {"compute_dtype": state.compute_dtype}
    if _enabled(ens):
        return make_ensemble_eval_step(
            state.model, image_size, num_classes,
            scales=parse_float_list(ens.get("scales", "0.75, 1.0, 1.25")),
            flip=bool(ens.get("flip", True)), **kwargs)
    if _enabled(sld):
        stride = sld.get("stride") or None
        chunk = int(sld.get("window_chunk", 0) or 0)
        return make_sliding_eval_step(
            state.model, image_size, num_classes,
            window=tuple(parse_int_list(sld.get("window", "512, 1024"))),
            stride=tuple(parse_int_list(stride)) if stride else None,
            window_chunk=chunk if chunk > 0 else None, **kwargs)
    return make_eval_step(state.model, num_classes, **kwargs)


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


def _ema_decay_from(tcfg) -> float | None:
    """``training.*.ema`` -> its decay, or None when it is off."""
    ema_cfg = tcfg.get("ema")
    return float(ema_cfg.get("decay", 0.999)) if _enabled(ema_cfg) else None


def run_validation_only(states: dict, which: str, checkpoint, val_batches,
                        num_classes: int, class_names, device,
                        eval_step, use_ema: bool = False) -> float:
    """Restore the best (else latest) checkpoint into ``states`` and
    validate ``states[which]`` once with ``eval_step``; with ``use_ema``,
    on the checkpoint's ``ema`` item where it holds one."""
    from rtsds_tpu_torch.eval.validate import validate
    from rtsds_tpu_torch.train.ema import setup_ema
    from rtsds_tpu_torch.train.loop import on_ema

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
    model = states[which].model
    if use_ema:
        states = {**states, "ema": setup_ema(model)}
    restored = mgr.restore(states, step=step, optional=("ema",))
    if not restored:
        raise SystemExit(f"--validate_only: checkpoint at epoch {step} under "
                         f"{checkpoint.save_dir} does not match this run's "
                         f"model")
    if "ema" in restored:
        eval_step = on_ema(eval_step, model, states["ema"])
    miou, _ = validate(model, val_batches(0), num_classes,
                       class_names=class_names, detailed_report=True,
                       eval_step=eval_step, device=device)
    print(f"validate_only: checkpoint epoch {step} -> "
          f"validation_mIoU = {miou:.6f}")
    return miou


def _resume(checkpoint, states: dict, ema_template=None):
    """``--resume`` into ``states`` (and the EMA template, when the run keeps
    an EMA): returns ``(start_epoch, resumed EMA dict or None)``.  A
    checkpoint without an ``ema`` item restores the rest, and the EMA
    restarts from the restored parameters, as in the JAX package."""
    if ema_template is None:
        _, start_epoch = checkpoint.resume(states)
        return start_epoch, None
    restored, start_epoch = checkpoint.resume(
        {**states, "ema": ema_template}, optional=("ema",))
    if start_epoch and "ema" in restored:
        return start_epoch, ema_template.params
    return start_epoch, None


def _self_training_threshold(st_cfg, num_classes: int):
    """``self_training.threshold``: a number, or a comma list of one per
    class."""
    from rtsds_tpu_torch.config import parse_float_list

    thr = st_cfg.get("threshold", 0.9)
    if isinstance(thr, str) and "," in thr:
        thr = parse_float_list(thr)
        if len(thr) != num_classes:
            raise SystemExit(f"self_training.threshold lists one value per "
                             f"class ({num_classes}), got {len(thr)}")
        return thr
    return float(thr)


def _calibrated_threshold(cal_cfg, gen_state, teacher_ema, data, device,
                          num_classes: int):
    """CBST thresholds of the teacher (the resumed EMA, else the generator
    as it starts) over the first ``calibration.batches`` target batches, of
    a pass of its own over the target set, so that the training stream's
    position is untouched."""
    from rtsds_tpu_torch.data.pipeline import DataLoader, device_batches
    from rtsds_tpu_torch.train.ema import ema_weights
    from rtsds_tpu_torch.train.self_training import (
        calibrate_class_thresholds)

    portion = float(cal_cfg.get("portion", 0.5))
    stream = data["cs_train"]
    loader = DataLoader(stream.dataset, stream.batch_size,
                        shuffle=stream.shuffle,
                        num_workers=stream.num_workers, seed=stream.seed)
    batches = device_batches(loader, data["cs_transform"], device)
    model = gen_state.model
    with contextlib.closing(batches), (
            ema_weights(model, teacher_ema) if teacher_ema is not None
            else contextlib.nullcontext()):
        thr = calibrate_class_thresholds(
            model, itertools.islice(batches, int(cal_cfg.get("batches", 8))),
            num_classes, portion=portion,
            compute_dtype=gen_state.compute_dtype)
    print(f"self-training calibration (portion={portion}): thresholds "
          f"{[round(float(t), 3) for t in thr]}")
    return thr


def run_domain_adaptation(args, config, data, callbacks, checkpoint,
                          class_names, device):
    """The ``--domain_adaptation`` branch: returns the history, or the mIoU
    with ``--validate_only``."""
    from rtsds_tpu_torch.data.pipeline import device_batches
    from rtsds_tpu_torch.train.adversarial import make_adversarial_step
    from rtsds_tpu_torch.train.ema import setup_ema
    from rtsds_tpu_torch.train.factory import build_adversarial
    from rtsds_tpu_torch.train.loop import adversarial_fit
    from rtsds_tpu_torch.train.self_training import make_self_training_step

    tcfg = config.training["domain_adaptation"]
    num_classes = int(tcfg["num_classes"])
    iterations = int(tcfg["iterations"])
    variant = str(tcfg.get("variant", "v1"))
    ema_decay = _ema_decay_from(tcfg)
    st_cfg = tcfg.get("self_training")
    self_training = _enabled(st_cfg)
    if self_training:
        # the mean-teacher pseudo-label step is built after the resume, so
        # that calibration sees the restored teacher
        if variant != "v1":
            raise SystemExit("self_training composes with the v1 "
                             "adversarial step only; set variant: v1")
        if ema_decay is None:
            raise SystemExit("self_training needs the mean-teacher: enable "
                             "training.domain_adaptation.ema (enabled: true)")
        cal_cfg = st_cfg.get("calibration")
        threshold = (None if _enabled(cal_cfg)
                     else _self_training_threshold(st_cfg, num_classes))
    ent_cfg = tcfg.get("entropy_min")
    lambda_ent = float(ent_cfg.get("lambda", 0.005)) if _enabled(ent_cfg) \
        else 0.0
    fda_cfg = tcfg.get("fda")
    fda_beta = float(fda_cfg.get("beta", 0.01)) if _enabled(fda_cfg) else 0.0

    gen_state, dis_state = build_adversarial(config, device, seed=args.seed)
    states = {"generator": gen_state, "discriminator": dis_state}
    eval_step = build_eval_step(config, gen_state, data["cs_size"],
                                num_classes)

    def val_batches(_epoch):
        return device_batches(data["cs_val"], data["cs_transform"], device)

    if args.validate_only:
        return run_validation_only(states, "generator", checkpoint,
                                   val_batches, num_classes, class_names,
                                   device, eval_step,
                                   use_ema=ema_decay is not None)

    adv = config.model["adversarial_model"]
    grl_cfg = adv["discriminator"].get("grl")
    # the generator's own model section, bisenet or deeplab
    ignore_index = config.model[adv["generator"]["name"]]["criterion"].get(
        "ignore_index")

    start_epoch, resumed_ema = 0, None
    if args.resume and checkpoint is not None:
        start_epoch, resumed_ema = _resume(
            checkpoint, states,
            setup_ema(gen_state.model) if ema_decay is not None else None)

    if self_training:
        if threshold is None:
            threshold = _calibrated_threshold(
                cal_cfg, gen_state, resumed_ema, data, device, num_classes)
        da_step = make_self_training_step(
            lambda_=float(tcfg["lambda"]), iterations=iterations,
            ignore_index=19 if ignore_index is None else ignore_index,
            threshold=threshold,
            lambda_pl=float(st_cfg.get("lambda_pl", 1.0)),
            ema_decay=ema_decay, lambda_ent=lambda_ent, fda_beta=fda_beta,
            classmix=_enabled(st_cfg.get("classmix")),
            classmix_seed=int(args.seed))
    else:
        da_step = make_adversarial_step(
            lambda_=float(tcfg["lambda"]), iterations=iterations,
            epochs=int(tcfg["epochs"]), ignore_index=ignore_index,
            variant=variant, lambda_ent=lambda_ent, fda_beta=fda_beta,
            grl_alpha=(float(grl_cfg.get("alpha", 0.1)) if _enabled(grl_cfg)
                       else 0.0))

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
    try:
        _, _, history = adversarial_fit(
            gen_state, dis_state, da_step, source_iter, target_iter,
            val_batches, iterations=iterations, epochs=int(tcfg["epochs"]),
            num_classes=num_classes, class_names=class_names,
            callbacks=callbacks, do_validation=int(tcfg["do_validation"]),
            checkpoint=checkpoint, when_print=int(tcfg.get("when_print", -1)),
            start_epoch=start_epoch, device=device, eval_step=eval_step,
            ema_decay=ema_decay, ema_params=resumed_ema,
            ema_in_step=self_training)
    finally:
        # stops the loaders' prefetch threads
        source_iter.close()
        target_iter.close()
    return history


def supervised_train_step(args, config, tcfg, train_loader, device,
                          calib_batches=None):
    """The supervised step of ``training.segmentation``: distillation from a
    frozen teacher (``teacher.quantize: int8`` quantizes it, calibrated on
    ``teacher.calib_batches`` batches of ``calib_batches()``, the first
    epoch's training batches), gradient accumulation over
    ``accumulate_steps`` micro-batches, or the plain step."""
    from rtsds_tpu_torch.models.pretrained import load_segmentor_state
    from rtsds_tpu_torch.train.accumulate import (
        make_accumulating_train_step, split_microbatches)
    from rtsds_tpu_torch.train.distill import (
        load_teacher, make_distill_step, quantize_teacher)
    from rtsds_tpu_torch.train.factory import make_segmentor
    from rtsds_tpu_torch.train.supervised import make_train_step

    ignore_index = config.model[args.model]["criterion"].get("ignore_index")
    accumulate_steps = int(tcfg.get("accumulate_steps", 1))
    dist_cfg = tcfg.get("distillation")
    if _enabled(dist_cfg):
        if accumulate_steps > 1:
            raise SystemExit("distillation does not compose with "
                             "accumulate_steps > 1; pick one")
        t_cfg = dist_cfg.get("teacher") or {}
        t_dir = t_cfg.get("checkpoint_dir", "") or ""
        if not t_dir:
            raise SystemExit("distillation needs training.segmentation."
                             "distillation.teacher.checkpoint_dir (a "
                             "trained ModelCheckpoint directory)")
        teacher_name = str(t_cfg.get("model", "deeplab"))
        teacher, _ = make_segmentor(config, teacher_name, seed=args.seed)
        load_segmentor_state(teacher, load_teacher(
            t_dir, use_ema=bool(t_cfg.get("use_ema", True))))
        if t_cfg.get("quantize") and not args.validate_only:
            # W8A8 the frozen teacher, calibrated on batches as the step
            # sees them (augmented when augmentation is on); skipped under
            # --validate_only, where the step never runs
            calib = []
            for images, _ in calib_batches():
                calib.append(images.permute(0, 3, 1, 2))
                if len(calib) >= int(t_cfg.get("calib_batches", 2)):
                    break
            # the calibration started a shuffle pass; rewind, so epoch 0
            # draws the permutation of an unquantized run
            train_loader.set_epoch(0)
            teacher = quantize_teacher(teacher_name, teacher.state_dict(),
                                       calib, device=device)
        return make_distill_step(
            teacher.to(device), ignore_index=ignore_index,
            temperature=float(dist_cfg.get("temperature", 2.0)),
            alpha=float(dist_cfg.get("alpha", 0.5)))
    if accumulate_steps > 1:
        if train_loader.batch_size % accumulate_steps:
            raise SystemExit(
                f"batch_size {train_loader.batch_size} does not divide into "
                f"accumulate_steps={accumulate_steps} micro-batches")
        acc_step = make_accumulating_train_step(ignore_index=ignore_index)

        def train_step(state, images, labels):
            return acc_step(state,
                            split_microbatches(images, accumulate_steps),
                            split_microbatches(labels, accumulate_steps))
        return train_step
    return make_train_step(ignore_index=ignore_index)


def main(argv=None):
    """Returns the training history (a list of per-validation dicts), or
    the mIoU with ``--validate_only``."""
    from rtsds_tpu_torch.data.pipeline import device_batches
    from rtsds_tpu_torch.train.ema import setup_ema
    from rtsds_tpu_torch.train.factory import build_supervised
    from rtsds_tpu_torch.train.loop import supervised_fit

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
    ema_decay = _ema_decay_from(tcfg)

    def train_batches(epoch):
        return device_batches(train_loader, train_transform, device,
                              seed=args.seed if augment else None,
                              epoch=epoch)

    train_step = supervised_train_step(args, config, tcfg, train_loader,
                                       device, lambda: train_batches(0))
    eval_step = build_eval_step(config, state, data["cs_size"], num_classes)

    def val_batches(_epoch):
        return device_batches(data["cs_val"], data["cs_transform"], device)

    if args.validate_only:
        return run_validation_only({"model": state}, "model", checkpoint,
                                   val_batches, num_classes, class_names,
                                   device, eval_step,
                                   use_ema=ema_decay is not None)

    start_epoch, resumed_ema = 0, None
    if args.resume and checkpoint is not None:
        start_epoch, resumed_ema = _resume(
            checkpoint, {"model": state},
            setup_ema(state.model) if ema_decay is not None else None)
        # the resumed epochs see the shuffles the uninterrupted run drew
        train_loader.set_epoch(start_epoch)

    _, history = supervised_fit(
        state, train_step, train_batches, val_batches,
        epochs=int(tcfg["epochs"]), num_classes=num_classes,
        class_names=class_names, callbacks=callbacks,
        do_validation=int(tcfg["do_validation"]), checkpoint=checkpoint,
        start_epoch=start_epoch, device=device, eval_step=eval_step,
        ema_decay=ema_decay, ema_params=resumed_ema)
    return history


if __name__ == "__main__":
    main()
