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
else the GPU, which raises when there is none.  Callbacks come from
``callbacks``: ``model_checkpoint``, ``early_stopping``, ``history`` (a
JSONL event log), ``images_plots`` (validation figures) and, with
``--wandb``, ``logging.wandb`` (its API key may come from ``.env``).
SIGTERM saves an emergency checkpoint of the interrupted epoch's start and
exits; ``--resume`` replays that epoch.  ``--debug`` stops at the first
non-finite value (``utils/debug.py``).

``--multihost`` runs one process per GPU, data-parallel: launch it with
torchrun, or with ``RTSDS_COORDINATOR_ADDRESS`` (``host:port``),
``RTSDS_NUM_PROCESSES`` and ``RTSDS_PROCESS_ID`` set for each process
(``device: cpu`` runs the group under gloo on the CPU).  Config batch
sizes are then GLOBAL: each rank loads its slice of every global batch,
BatchNorm, the losses and the gradients are the global batch's
(``parallel/distributed.py``), every rank reports the same metrics and
mIoU, and rank 0 alone writes checkpoints, logs and prints.  Self-training
(CBST calibration on each rank's shards of the same global batches),
distillation (the int8 teacher calibrated over the ranks) and every DA
extra run on several ranks too.

``mesh: {model: M}`` or ``{data: D, model: M}`` (with ``--multihost``,
``D * M`` ranks, rank ``r`` at data index ``r // M`` and model index ``r %
M``) shards the large parameters and their moments over each model group
of ranks (FSDP, ``parallel/fsdp.py``); its ranks load the same frames,
and every training extra runs on it (the EMA keeps its chunks as the
parameters do).  ``mesh: {spatial: S}`` bands each frame's rows over S of
a process's devices (``parallel/spatial.py``): the transform (K2) runs on
the whole batch on the first device, then the rows are split, and
validation runs K1 per band.  The spatial axis composes with the others
under ``--multihost`` (``{data: D, spatial: S}``, ``{spatial: S, model:
M}``, ``{data: D, spatial: S, model: M}``): each process bands over S
GPUs of its own (local rank ``r`` holds ``cuda:r*S`` to ``cuda:r*S+S-1``;
on a box with one GPU every band is ``cuda:0``; too few GPUs raise; on
the CPU, ``RTSDS_CPU_DEVICES`` counts the devices), BatchNorm sums the
bands' statistics and then the data group's, and validation sums K1's
band matrices, then the data group's.  Every training extra (EMA,
accumulation, distillation with a float or an int8 teacher, remat,
MinEnt, FDA, the reversal step, DA v2, self-training with CBST and
ClassMix) and both validation protocols (sliding, ensemble) run on the
spatial axis, alone or composed, as on one device: the ops they add run
per band, or over the bands where they read across rows
(``parallel/spatial.py``); FDA restyles frames gathered on the first
band's device; K1 counts each band's pixels.  ``mesh: {pipe: N}``
pipelines DeepLab's layer3 over N of this process's GPUs
(``train/pipelined.py``), with the JAX CLI's own refusals of the pipe.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import os
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
    parser.add_argument("--wandb", action="store_true",
                        help="Log to the W&B platform.")
    parser.add_argument("--debug", action="store_true",
                        help="Stop at the first non-finite value: anomaly "
                             "mode and a check of every module's output.")
    parser.add_argument("--multihost", action="store_true",
                        help="Join the job's process group (torchrun's or "
                             "the RTSDS_* variables) and train "
                             "data-parallel, one process per GPU; config "
                             "batch sizes are then GLOBAL.")
    return parser.parse_args(argv)


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


def _check_mesh(args, config) -> None:
    """The mesh axes the port runs: ``data`` and ``model`` over
    ``--multihost``'s processes, ``spatial`` over each process's devices
    (alone or composed with both, every training extra and validation
    protocol on each), and ``pipe`` (alone, one process)."""
    mesh = dict(config.get("mesh") or {})
    model = int(mesh.get("model", 1) or 1)
    if model > 1 and not args.multihost:
        raise SystemExit(
            f"mesh {mesh}: the model axis spans processes, one per GPU: "
            f"launch one process per GPU with torchrun (or --multihost "
            f"and the RTSDS_* variables)")
    pipe = int(mesh.get("pipe", 1) or 1)
    if pipe != 1 and args.multihost:
        raise SystemExit(
            "mesh: {pipe: N} is single-process only: the schedule "
            "replicates inputs, which is incompatible with per-process "
            "sharded loading (--multihost)")


def check_ported(args, config) -> None:
    """Exit on every flag or config switch the port does not run yet, and
    say what is skipped."""
    if args.domain_adaptation:
        _check_domain_adaptation(config)
    else:
        _check_supervised(args, config)
    vcfg = config.get("validation") or {}
    if _enabled(vcfg.get("ensemble")) and _enabled(vcfg.get("sliding")):
        raise SystemExit("validation.ensemble and validation.sliding are "
                         "mutually exclusive; enable at most one")
    _check_mesh(args, config)
    if config.get("compilation_cache"):
        print("compilation_cache is an XLA setting; rtsds_tpu_torch ignores "
              "it")


def _device_type(config) -> str:
    return "cpu" if str(config.get("device", "cuda")).lower() == "cpu" \
        else "cuda"


def _spatial_size(config) -> int:
    return int(dict(config.get("mesh") or {}).get("spatial", 1) or 1)


def device_from_config(config) -> torch.device:
    """``device: cpu`` -> the CPU; anything else -> the GPU (or raise).  One
    process trains on one GPU, or bands over S of them under a ``spatial:
    S`` mesh (``parallel/mesh.py:band_devices``: on a box with one GPU the
    bands share it; too few GPUs raise); this returns the first band's.
    With more GPUs on the box it warns that they idle (``--multihost`` runs
    one process per GPU, or per S of them)."""
    from rtsds_tpu_torch.parallel.mesh import band_devices

    if _device_type(config) == "cpu":
        return torch.device("cpu")
    device = resolve_device(None)
    spatial = _spatial_size(config)
    if spatial > 1:
        device = band_devices("cuda", spatial, local_rank=0)[0]
    n = torch.cuda.device_count()
    if n > spatial:
        import warnings

        used, per = (("one GPU", "GPU") if spatial == 1
                     else (f"{spatial} GPUs", f"{spatial} GPUs"))
        warnings.warn(
            f"one process trains on {used}: {n - spatial} of {n} GPUs "
            f"idle; launch one process per {per} with torchrun (or "
            f"--multihost and the RTSDS_* variables) to train on all of "
            f"them", stacklevel=2)
    return device


def datasets_loader(config, is_augmented: bool, synthetic: bool = False,
                    seed: int = 42, infinite: bool = False,
                    train_micro_batches: tuple[str, int] = ("", 1)) -> dict:
    """Host loaders of Cityscapes train/val and GTA5, and their device
    transforms (``make_transform``) and sizes.  ``infinite`` makes the two
    training loaders endless, for domain adaptation.  In a job of several
    processes the batch sizes are global and each loader is this rank's
    :class:`~rtsds_tpu_torch.data.multihost.MultiHostDataLoader` of its
    place on the data axis;
    ``train_micro_batches`` ``(name, K)`` lays the ``cs_train`` or
    ``gta5_train`` loader's shares out for a K-step accumulation."""
    from rtsds_tpu_torch.data.multihost import MultiHostDataLoader
    from rtsds_tpu_torch.parallel.distributed import world_size
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
    # the data axis's ranks load their shards; a model group's ranks load
    # the same frames
    multi = world_size() > 1
    mk = partial(MultiHostDataLoader if multi else DataLoader,
                 num_workers=cs["num_workers"], seed=seed)
    name, k = train_micro_batches
    micro = {name: k} if multi else {}

    def split(key):
        return {"micro_batches": micro[key]} if key in micro else {}
    return {
        "cs_train": mk(cs_train_ds, cs["batch_size"], shuffle=True,
                       infinite=infinite, **split("cs_train")),
        "cs_val": mk(cs_val_ds, cs["batch_size"], shuffle=False,
                     drop_last=False),
        "gta5_train": mk(gta5_ds, gta5["batch_size"], shuffle=True,
                         infinite=infinite, **split("gta5_train")),
        "cs_transform": make_transform(cs_size, cs["num_classes"],
                                       antialias=True,
                                       correct_preprocessing=correct),
        "gta5_transform": make_transform(gta5_size, gta5["num_classes"],
                                         antialias=False,
                                         augment_cfg=aug_cfg,
                                         correct_preprocessing=correct,
                                         decode_label_colors=decode_colors,
                                         micro_batches=micro.get(
                                             "gta5_train", 1)),
        "cs_size": cs_size,
        "gta5_size": gta5_size,
    }


def build_eval_step(config, state, image_size: tuple[int, int],
                    num_classes: int, return_preds: bool = False):
    """The validation step of ``state``'s model at ``image_size``: the
    ``validation.ensemble`` or ``validation.sliding`` protocol when one is
    enabled, else the plain forward.  ``return_preds`` must be on when an
    image-plot callback listens, or it is never handed a sample."""
    from rtsds_tpu_torch.config import parse_float_list
    from rtsds_tpu_torch.eval.ensemble import make_ensemble_eval_step
    from rtsds_tpu_torch.eval.sliding import make_sliding_eval_step
    from rtsds_tpu_torch.eval.validate import make_eval_step

    vcfg = config.get("validation") or {}
    ens, sld = vcfg.get("ensemble"), vcfg.get("sliding")
    kwargs = {"compute_dtype": state.compute_dtype,
              "return_preds": return_preds}
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


def build_callbacks(config, mode_suffix: str = "", use_wandb: bool = False,
                    main_rank: bool = True):
    """(callbacks, checkpoint) from ``config.callbacks``; a section set to
    null is off.  Checkpoints go to ``<save_name><mode_suffix>``, so
    supervised and domain-adaptation runs of one config keep apart.
    ``use_wandb`` (``--wandb``) adds the W&B logger of
    ``callbacks.logging.wandb``, and exits when that section is null.
    Off the ``main_rank`` of a data-parallel job only the callbacks that
    decide (the checkpoint, which writes on rank 0 alone, and early
    stopping) are made: the loggers write from rank 0."""
    from rtsds_tpu_torch.callbacks.checkpoint import (
        EarlyStopping, ModelCheckpoint)
    from rtsds_tpu_torch.callbacks.history import HistoryCallback
    from rtsds_tpu_torch.callbacks.plots import ImagePlotsCallback

    cb_cfg = config.callbacks
    callbacks = []
    if use_wandb:
        from rtsds_tpu_torch.callbacks.logging import WandBCallback
        from rtsds_tpu_torch.utils.dotenv import load_dotenv

        logging_cfg = cb_cfg.get("logging")
        wb = logging_cfg.get("wandb") if logging_cfg else None
        if not wb:
            raise SystemExit(
                "--wandb passed but callbacks.logging.wandb is disabled "
                "(null) or missing in the config")
    if use_wandb and main_rank:
        load_dotenv()  # WANDB_API_KEY may live in ./.env
        callbacks.append(WandBCallback(project_name=wb["project_name"],
                                       run_name=wb["run_name"],
                                       config=config.to_dict(),
                                       note=wb["note"]))
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
    if not main_rank:
        return callbacks, checkpoint
    if cb_cfg.get("history"):
        callbacks.append(HistoryCallback(
            path=cb_cfg["history"].get("path", "history.jsonl")))
    if cb_cfg.get("images_plots"):
        ip = cb_cfg["images_plots"]
        callbacks.append(ImagePlotsCallback(
            save_dir=ip.get("save_dir", "images"),
            number_of_samples=int(ip.get("number_of_samples", 4))))
    return callbacks, checkpoint


def _plots(callbacks) -> bool:
    return any(hasattr(cb, "add_sample") for cb in callbacks)


def _preempted(e, checkpoint) -> None:
    if checkpoint is not None:
        print(f"Preempted ({e}); exiting -- restart with --resume "
              f"to continue from the last checkpoint.")
    else:
        print(f"Preempted ({e}); no checkpoint callback configured, "
              f"progress NOT saved.")


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


def _calibration_pass(stream):
    """A finite pass of its own over ``stream``'s data, in the order its
    first epoch draws (the same seed), so that the training stream's
    position is untouched.  Under ``--multihost`` it is the rank's
    :class:`~rtsds_tpu_torch.data.multihost.MultiHostDataLoader` again: the
    rank reads its shard of each global batch, never the whole batch, so
    that a statistic summed over the ranks counts every frame once."""
    from rtsds_tpu_torch.data.multihost import MultiHostDataLoader
    from rtsds_tpu_torch.data.pipeline import DataLoader

    if isinstance(stream, MultiHostDataLoader):
        return MultiHostDataLoader(
            stream.dataset, stream.global_batch_size, shuffle=stream.shuffle,
            num_workers=stream.num_workers, seed=stream.seed,
            process_index=stream.process_index,
            process_count=stream.process_count)
    return DataLoader(stream.dataset, stream.batch_size,
                      shuffle=stream.shuffle,
                      num_workers=stream.num_workers, seed=stream.seed)


def _calibrated_threshold(cal_cfg, gen_state, teacher_ema, data, device,
                          num_classes: int, mesh):
    """CBST thresholds of the teacher (the resumed EMA, else the generator
    as it starts) over the first ``calibration.batches`` target batches, of
    a pass of its own over the target set (:func:`_calibration_pass`); with
    several ranks each reads its shards and the histogram is summed over
    them; under the spatial axis the batches are banded and so is the
    histogram's count."""
    from rtsds_tpu_torch.data.pipeline import device_batches
    from rtsds_tpu_torch.train.ema import ema_weights
    from rtsds_tpu_torch.train.self_training import (
        calibrate_class_thresholds)

    portion = float(cal_cfg.get("portion", 0.5))
    loader = _calibration_pass(data["cs_train"])
    batches = _banded(device_batches(loader, data["cs_transform"], device),
                      mesh)
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
                          class_names, device, mesh):
    """The ``--domain_adaptation`` branch: returns the history, or the mIoU
    with ``--validate_only``."""
    from rtsds_tpu_torch.data.pipeline import device_batches
    from rtsds_tpu_torch.parallel.mesh import place_state
    from rtsds_tpu_torch.train.adversarial import make_adversarial_step
    from rtsds_tpu_torch.train.ema import setup_ema
    from rtsds_tpu_torch.train.factory import build_adversarial
    from rtsds_tpu_torch.train.loop import adversarial_fit
    from rtsds_tpu_torch.train.self_training import make_self_training_step
    from rtsds_tpu_torch.utils.debug import name_modules
    from rtsds_tpu_torch.utils.preemption import Preempted

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
    for state in (gen_state, dis_state):
        place_state(state, mesh)
    if args.debug:
        name_modules(gen_state.model, "generator.")
        name_modules(dis_state.model, "discriminator.")
    states = {"generator": gen_state, "discriminator": dis_state}
    eval_step = build_eval_step(config, gen_state, data["cs_size"],
                                num_classes, return_preds=_plots(callbacks))

    def val_batches(_epoch):
        return _banded(device_batches(data["cs_val"], data["cs_transform"],
                                      device), mesh)

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
        for state in (gen_state, dis_state):
            place_state(state, mesh)

    if self_training:
        if threshold is None:
            threshold = _calibrated_threshold(
                cal_cfg, gen_state, resumed_ema, data, device, num_classes,
                mesh)
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
    # under the spatial axis source and target frames are banded apart
    source_iter = _banded(device_batches(
        data["gta5_train"], data["gta5_transform"], device,
        seed=args.seed if args.augmented else None, start_index=consumed),
        mesh)
    target_iter = _banded(device_batches(data["cs_train"],
                                         data["cs_transform"], device), mesh)
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
    except Preempted as e:
        _preempted(e, checkpoint)
        return None
    finally:
        # stops the loaders' prefetch threads
        source_iter.close()
        target_iter.close()
    return history


def _pipelined_train_step(args, config, tcfg, state, mesh, ignore_index):
    """``mesh: {pipe: N}``: DeepLab's layer3 GPipe-pipelined
    (``train/pipelined.py``), with the JAX CLI's refusals."""
    from rtsds_tpu_torch.train.pipelined import make_pipelined_train_step

    if args.model != "deeplab":
        raise SystemExit(
            "mesh: {pipe: N} pipelines DeepLab's homogeneous layer3 "
            "bottlenecks; --model deeplab required")
    if _enabled(tcfg.get("distillation")):
        raise SystemExit("mesh.pipe does not compose with distillation; "
                         "pick one")
    if int(tcfg.get("accumulate_steps", 1)) > 1:
        raise SystemExit(
            "mesh.pipe already microbatches (GPipe == gradient "
            "accumulation); set training.segmentation.pipe_microbatches "
            "instead of accumulate_steps")
    if bool(config.model["deeplab"].get("bn_eval", False)):
        raise SystemExit(
            "mesh.pipe does not support model.deeplab.bn_eval yet: the "
            "pipelined schedule threads per-microbatch batch-stats BN; "
            "running it with frozen stats would silently diverge from the "
            "same config on a non-pipe mesh. Disable bn_eval or drop the "
            "pipe axis.")
    n_micro_cfg = tcfg.get("pipe_microbatches")
    n_micro = (mesh.shape["pipe"] if n_micro_cfg is None
               else int(n_micro_cfg))
    if n_micro < 1:
        raise SystemExit(
            f"training.segmentation.pipe_microbatches {n_micro_cfg} must be "
            f">= 1 (or null for the pipe size)")
    bs = int(config.data["gta5_modified" if args.dataset == "gta5"
                         else "cityscapes"]["batch_size"])
    if bs % n_micro:
        raise SystemExit(f"batch_size {bs} does not split into {n_micro} "
                         f"pipeline microbatches")
    try:
        return make_pipelined_train_step(state.model, mesh,
                                         ignore_index=ignore_index,
                                         num_microbatches=n_micro)
    except ValueError as e:
        raise SystemExit(str(e))


def supervised_train_step(args, config, tcfg, train_loader, device,
                          calib_batches=None, state=None, mesh=None):
    """The supervised step of ``training.segmentation``: DeepLab's layer3
    pipelined over a ``pipe`` ``mesh`` (``state`` holds the model it
    places), distillation from a frozen teacher (``teacher.quantize: int8``
    quantizes it, calibrated on ``teacher.calib_batches`` batches of
    ``calib_batches()``, the first epoch's training batches), gradient
    accumulation over ``accumulate_steps`` micro-batches, or the plain
    step."""
    from rtsds_tpu_torch.models.pretrained import load_segmentor_state
    from rtsds_tpu_torch.parallel.spatial import gathered
    from rtsds_tpu_torch.train.accumulate import (
        make_accumulating_train_step, split_microbatches)
    from rtsds_tpu_torch.train.distill import (
        load_teacher, make_distill_step, quantize_teacher)
    from rtsds_tpu_torch.train.factory import make_segmentor
    from rtsds_tpu_torch.train.supervised import make_train_step

    ignore_index = config.model[args.model]["criterion"].get("ignore_index")
    if mesh is not None and "pipe" in mesh.axis_names:
        return _pipelined_train_step(args, config, tcfg, state, mesh,
                                     ignore_index)
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
            # --validate_only, where the step never runs; under the spatial
            # axis the bands gathered on the first band's device: the
            # frames one device sees, so the same scales
            calib = []
            for images, _ in calib_batches():
                calib.append(gathered(images).permute(0, 3, 1, 2))
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
    """Returns the training history (a list of per-validation dicts), the
    mIoU with ``--validate_only``, or None when SIGTERM stopped the run.

    SIGTERM becomes :class:`~rtsds_tpu_torch.utils.preemption.Preempted`
    for the run (an emergency checkpoint, then a clean exit), and
    ``--debug`` the debug mode; both are undone when the run ends, so a
    library caller keeps its own signal handlers and settings."""
    from rtsds_tpu_torch.parallel.mesh import planned_process_count
    from rtsds_tpu_torch.utils.debug import disable_debug, enable_debug
    from rtsds_tpu_torch.utils.preemption import (
        install_preemption_handler, restore_handlers)

    args = argument_parser(argv)
    # with several ranks a signal only marks the run, and every rank stops
    # at the step whose metrics report it (utils/preemption.py)
    previous = install_preemption_handler(
        deferred=args.multihost and planned_process_count() > 1)
    if args.debug:
        enable_debug()
    try:
        return _main(args)
    finally:
        if args.debug:
            disable_debug()
        restore_handlers(previous)


def job_mesh(config, device_type: str):
    """The config's mesh by the JAX CLI's rules: config batch sizes are
    global, and the data axis must divide the smaller of the two."""
    from rtsds_tpu_torch.parallel.mesh import make_mesh_from_config

    return make_mesh_from_config(
        dict(config.get("mesh") or {}), device_type=device_type,
        batch_size=min(int(config.data["cityscapes"]["batch_size"]),
                       int(config.data["gta5_modified"]["batch_size"])))


def _main(args):
    config = load_config(args.config)
    check_ported(args, config)
    if not args.multihost:
        device = device_from_config(config)
        return _run(args, config, device, job_mesh(config, device.type))
    import torch.distributed as dist

    from rtsds_tpu_torch.parallel.distributed import (
        axis_groups, data_parallel, is_main_rank)
    from rtsds_tpu_torch.parallel.mesh import initialize_multihost

    spatial = _spatial_size(config)
    device = initialize_multihost(device_type=_device_type(config),
                                  spatial=spatial)
    try:
        mesh = job_mesh(config, device.type)
        world = dist.get_world_size()
        if mesh.axis_size("model") > 1 or spatial > 1:
            if mesh.size != world * spatial:
                raise SystemExit(
                    f"mesh {dict(config.mesh)}: every rank must hold a "
                    f"place in the (data, model) grid, with {spatial} "
                    f"band(s) each: {mesh.size // spatial} of {world} "
                    f"ranks would train")
        groups = (axis_groups(mesh.axis_size("model"))
                  if mesh.axis_size("model") > 1 else (None, None))
        with data_parallel(*groups), contextlib.ExitStack() as stack:
            if not is_main_rank():  # rank 0 alone prints
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            if spatial > 1:
                # the bands' backward on one thread: the banded BN's
                # all-reduces then come in one order on every rank, which
                # per-device autograd threads would not guarantee
                stack.enter_context(
                    torch.autograd.set_multithreading_enabled(False))
            return _run(args, config, device, mesh)
    finally:
        dist.destroy_process_group()


def _banded(batches, mesh):
    """``batches`` split into bands of rows over the devices of this
    process's spatial axis (``parallel/spatial.py:split_batch``), else as
    they are."""
    if mesh.axis_size("spatial") <= 1:
        return batches
    from rtsds_tpu_torch.parallel.spatial import BandedBatches

    return BandedBatches(batches, mesh.axis_devices("spatial"))


def _run(args, config, device, mesh):
    from rtsds_tpu_torch.data.pipeline import device_batches
    from rtsds_tpu_torch.parallel.distributed import is_main_rank
    from rtsds_tpu_torch.parallel.mesh import place_state
    from rtsds_tpu_torch.train.ema import setup_ema
    from rtsds_tpu_torch.train.factory import build_supervised
    from rtsds_tpu_torch.train.loop import supervised_fit
    from rtsds_tpu_torch.utils.debug import name_modules
    from rtsds_tpu_torch.utils.preemption import Preempted

    if mesh.axis_size("spatial") > 1:
        # the state and the transforms on the first band's device
        device = mesh.axis_devices("spatial")[0]
    if args.domain_adaptation and "pipe" in mesh.axis_names:
        raise SystemExit(
            "mesh: {pipe: N} supports supervised DeepLab training only (the "
            "G/D steps have no pipelined variant); use a data mesh for "
            "domain adaptation")
    # under the data axis each rank's training batch holds its share of
    # every micro-batch of the accumulating step (data/multihost.py)
    train_name = "gta5_train" if args.dataset == "gta5" else "cs_train"
    micro_batches = (train_name, 1 if args.domain_adaptation else int(
        config.training["segmentation"].get("accumulate_steps", 1)))
    try:
        data = datasets_loader(config, is_augmented=args.augmented,
                               synthetic=args.synthetic, seed=args.seed,
                               infinite=args.domain_adaptation,
                               train_micro_batches=micro_batches)
    except ValueError as e:  # a global batch that does not divide
        raise SystemExit(str(e))
    callbacks, checkpoint = build_callbacks(
        config, mode_suffix="_da" if args.domain_adaptation else "",
        use_wandb=args.wandb, main_rank=is_main_rank())
    class_names = list(config.meta["class_names"])

    if args.domain_adaptation:
        return run_domain_adaptation(args, config, data, callbacks,
                                     checkpoint, class_names, device, mesh)

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
    state = place_state(build_supervised(config, args.model,
                                         len(train_loader), device,
                                         seed=args.seed), mesh)
    if args.debug:
        name_modules(state.model)
    ema_decay = _ema_decay_from(tcfg)

    def train_batches(epoch):
        return _banded(device_batches(train_loader, train_transform, device,
                                      seed=args.seed if augment else None,
                                      epoch=epoch), mesh)

    train_step = supervised_train_step(args, config, tcfg, train_loader,
                                       device, lambda: train_batches(0),
                                       state=state, mesh=mesh)
    eval_step = build_eval_step(config, state, data["cs_size"], num_classes,
                                return_preds=_plots(callbacks))

    def val_batches(_epoch):
        return _banded(device_batches(data["cs_val"], data["cs_transform"],
                                      device), mesh)

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
        place_state(state, mesh)
        # the resumed epochs see the shuffles the uninterrupted run drew
        train_loader.set_epoch(start_epoch)

    try:
        _, history = supervised_fit(
            state, train_step, train_batches, val_batches,
            epochs=int(tcfg["epochs"]), num_classes=num_classes,
            class_names=class_names, callbacks=callbacks,
            do_validation=int(tcfg["do_validation"]), checkpoint=checkpoint,
            start_epoch=start_epoch, device=device, eval_step=eval_step,
            ema_decay=ema_decay, ema_params=resumed_ema)
    except Preempted as e:
        _preempted(e, checkpoint)
        return None
    return history


if __name__ == "__main__":
    main()
