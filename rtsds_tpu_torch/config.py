"""Config: YAML -> read-only, attribute-accessible config tree.

The port's own copy of the JAX package's config loader and schema, so that
one YAML file drives both.  Every mapping becomes a :class:`ConfigNode`
with attribute access, item access, ``.get`` and ``.keys``; comma strings
like ``"512, 1024"`` parse with :func:`parse_int_list`; user YAML is
deep-merged over :func:`default_config`, and unknown keys print a warning.

``device`` selects where the trainer runs: ``cpu`` means the CPU, anything
else the GPU (which raises when there is none).
"""

from __future__ import annotations

import copy
from typing import Any, Iterator, Mapping

import yaml


def parse_int_list(value: Any) -> list[int]:
    """Parse ``"512, 1024"`` / ``[512, 1024]`` / ``512`` into a list of ints.

    The reference stores image sizes as comma strings in YAML and splits them
    by hand (``main.py:65-66``, ``main.py:28-29``); we accept those plus
    native lists.
    """
    if isinstance(value, (list, tuple)):
        return [int(v) for v in value]
    if isinstance(value, str):
        return [int(v.strip()) for v in value.split(",") if v.strip()]
    return [int(value)]


def parse_float_list(value: Any) -> list[float]:
    """Same as :func:`parse_int_list` but for floats (e.g. blur sigma)."""
    if isinstance(value, (list, tuple)):
        return [float(v) for v in value]
    if isinstance(value, str):
        return [float(v.strip()) for v in value.split(",") if v.strip()]
    return [float(value)]


class ConfigNode(Mapping):
    """Read-only mapping with attribute access; nests recursively."""

    __slots__ = ("_data",)

    def __init__(self, data: dict):
        object.__setattr__(self, "_data", dict(data))

    # -- mapping protocol ---------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return _wrap(self._data[key])

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._data:
            return _wrap(self._data[key])
        return default

    def keys(self):
        return self._data.keys()

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return _wrap(self._data[name])
        except KeyError as e:
            raise AttributeError(f"config has no key {name!r}") from e

    def __setattr__(self, name: str, value: Any) -> None:
        raise AttributeError("ConfigNode is read-only")

    def __contains__(self, key) -> bool:
        return key in self._data

    def __repr__(self) -> str:
        return f"ConfigNode({self._data!r})"

    def to_dict(self) -> dict:
        """A deep copy as plain dicts (W&B's run config)."""
        return copy.deepcopy(self._data)


def _wrap(value: Any) -> Any:
    if isinstance(value, dict):
        return ConfigNode(value)
    return value


def _deep_merge(base: dict, override: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


_DEFAULTS: dict = {
    # mirrors the reference config.yaml schema (config.yaml:2-152)
    "data": {
        "cityscapes": {
            "images_train_dir": "data/Cityscapes/Cityspaces/images/train",
            "images_val_dir": "data/Cityscapes/Cityspaces/images/val",
            "segmentation_train_dir": "data/Cityscapes/Cityspaces/gtFine/train",
            "segmentation_val_dir": "data/Cityscapes/Cityspaces/gtFine/val",
            "image_size": "512, 1024",
            "num_classes": 19,
            "batch_size": 4,
            "num_workers": 4,
        },
        "gta5_modified": {
            "images_dir": "data/GTA5_Modified/images",
            "segmentation_dir": "data/GTA5_Modified/labels",
            "image_size": "720, 1280",
            "num_classes": 19,
            "batch_size": 4,
            "num_workers": 4,
            # raw (non-"Modified") GTA5 labels are RGB-coded; True decodes
            # them to trainIds at load time (the reference's
            # ``in_getting_decoder``, gta5.py:51,66-70)
            "decode_label_colors": False,
        },
        # ours: opt out of the reference's normalize-without-/255 quirk
        # (main.py:71 normalizes 0-255 floats with ImageNet mean/std).
        # False reproduces the reference bit-for-bit; True is the standard
        # /255-first preprocessing.  Serving must match training: pass the
        # same flag to serve.Predictor(correct_preprocessing=...).
        "correct_preprocessing": False,
        # ours: --synthetic data knobs.  fixed_tints shares ONE
        # class->color mapping across train/val so short synthetic runs
        # are genuinely learnable (used by trained-model accuracy gates);
        # default False keeps per-image mappings.
        "synthetic": {"fixed_tints": False},
    },
    "meta": {
        "class_names": [
            "road", "sidewalk", "building", "wall", "fence", "pole",
            "traffic light", "traffic sign", "vegetation", "terrain", "sky",
            "person", "rider", "car", "truck", "bus", "train", "motorcycle",
            "bicycle",
        ],
    },
    "model": {
        "deeplab": {
            "backbone": "resnet101",
            "num_classes": 19,
            "pretrain": False,
            "pretrain_model_path": "",
            "power_lr_factor": 0.9,
            # fully-frozen BN during training (ours, opt-in): normalize
            # with running stats, never update them -- the common DeepLab
            # DA recipe; default False = the reference's batch-stats mode
            "bn_eval": False,
            # rematerialize backbone blocks in the backward pass: ~1
            # extra forward of FLOPs for a large activation-memory cut
            # (fits bigger batches/resolutions); measured NOT faster when
            # memory is not the constraint (PERF.md)
            "remat": False,
            # head_lr_mult: discriminative LR -- scale the ASPP classifier
            # head's LR by this factor (the reference's 10x intent,
            # deeplabv2.py:171-173); 0 = uniform LR
            "optimizer": {"name": "Adam", "lr": 0.0001, "grad_clip": 0.0,
                          "head_lr_mult": 0.0},
            "criterion": {"name": "CrossEntropy", "ignore_index": 19},
        },
        "bisenet": {
            "backbone": "resnet18",
            "num_classes": 19,
            "pretrained": False,
            "pretrain_model_path": "",
            "power_lr_factor": 0.9,
            # rematerialize backbone blocks in the backward pass (see
            # model.deeplab.remat)
            "remat": False,
            # head_lr_mult: scale every non-backbone module's LR (the
            # reference's `mul_lr` intent, build_bisenet.py:121-128)
            "optimizer": {"name": "Adam", "lr": 0.0001, "grad_clip": 0.0,
                          "head_lr_mult": 0.0},
            "criterion": {"name": "CrossEntropy", "ignore_index": 19},
        },
        "adversarial_model": {
            "generator": {
                "name": "bisenet",
                "power_lr_factor": 0.9,
                "optimizer": {"name": "Adam", "lr": 0.0001, "grad_clip": 0.0,
                              "head_lr_mult": 0.0},
                "criterion": {"name": "CrossEntropy", "ignore_index": 19},
            },
            "discriminator": {
                "name": "tiny",
                "power_lr_factor": 0.05,
                "input_channels": 19,
                "optimizer": {
                    "name": "Adam",
                    "lr": 0.0001,
                    "weight_decay": 0.0001,
                    "grad_clip": 0.0,
                },
                "criterion": {"name": "BCEWithLogits"},
                # ours: DANN-style gradient-reversal training (the
                # reference's GradientReversalFunction, model.py:9-17,
                # config-reachable for real): ONE fused backward computes
                # both updates -- the domain loss reaches the generator
                # through a -alpha-scaled reversal at the discriminator
                # input while the discriminator itself minimizes normally.
                # Composes with v1 only (replaces its two-backward G/D
                # dance).
                "grl": {"enabled": False, "alpha": 0.1},
            },
        },
    },
    "training": {
        "segmentation": {
            "num_classes": 19,
            "lambda": 0.1,
            "lr_decay_iter": 1,
            # ours: linear LR warmup over the first N steps (0 = off)
            "warmup_iters": 0,
            "epochs": 50,
            "do_validation": 1,
            "when_print": -1,
            # ours: >1 splits each loaded batch into K micro-batches,
            # accumulates gradients in one lax.scan jit program and applies
            # ONE optimizer update (train/accumulate.py); batch_size must
            # divide by it
            "accumulate_steps": 1,
            # ours: microbatch count for `mesh: {pipe: N}` pipelined
            # DeepLab training (train/pipelined.py); null = the pipe size.
            # GPipe == gradient accumulation, so this replaces
            # accumulate_steps when pipelining
            "pipe_microbatches": None,
            # ours: exponential moving average of params (train/ema.py);
            # validation runs on the EMA weights when enabled; the EMA tree
            # is checkpointed as an 'ema' item and restored on resume
            "ema": {"enabled": False, "decay": 0.999},
            # ours: frozen-teacher knowledge distillation (train/distill.py)
            "distillation": {
                "enabled": False,
                "temperature": 2.0,
                "alpha": 0.5,
                # teacher.quantize: int8 runs the frozen teacher through
                # the W8A8 serving path (train/distill.py:quantize_teacher)
                # calibrated on the first calib_batches training batches
                "teacher": {"model": "deeplab", "checkpoint_dir": "",
                            "use_ema": True, "quantize": None,
                            "calib_batches": 2},
            },
        },
        "domain_adaptation": {
            "num_classes": 19,
            "iterations": 100,
            "lambda": 0.1,
            "lr_decay_iter": 1,
            # ours: linear LR warmup (both G and D schedules; 0 = off)
            "warmup_iters": 0,
            "epochs": 50,
            "do_validation": 1,
            "when_print": -1,
            # ours: select the reference's v1 or v2 loop semantics
            # (train.py:130 vs train.py:322)
            "variant": "v1",
            # ours: mean-teacher EMA of the GENERATOR params; validation
            # runs on the EMA weights when enabled
            "ema": {"enabled": False, "decay": 0.999},
            # ours: pseudo-label self-training on the EMA mean-teacher
            # (train/self_training.py; requires ema.enabled)
            "self_training": {
                "enabled": False,
                "threshold": 0.9,  # scalar or per-class comma list
                "lambda_pl": 1.0,
                # CBST quantile calibration of per-class thresholds
                "calibration": {"enabled": False, "portion": 0.5,
                                "batches": 8},
                # DACS ClassMix: mixed-batch pseudo-label CE
                "classmix": {"enabled": False},
            },
            # ours: MinEnt target-entropy minimization (ADVENT)
            "entropy_min": {"enabled": False, "lambda": 0.005},
            # ours: FDA low-frequency amplitude restyling (ops/fda.py)
            "fda": {"enabled": False, "beta": 0.01},
        },
    },
    # ours: validation-time inference protocol (eval/ensemble.py,
    # eval/sliding.py); mutually exclusive. Applies to the supervised and
    # DA validation passes and to --validate_only.
    "validation": {
        "ensemble": {"enabled": False, "scales": "0.75, 1.0, 1.25",
                     "flip": True},
        "sliding": {"enabled": False, "window": "512, 1024",
                    "stride": "",  # "" = 3/4 window (25% overlap)
                    # max windows stacked per forward; 0 = all windows
                    # in ONE batched forward (the fast default). Lower
                    # it if eval_batch x windows exceeds HBM.
                    "window_chunk": 0},
    },
    "augmentation": {
        "p": 0.5,
        "GaussianBlur": {"kernel_size": "5, 9", "sigma": "0.1, 5"},
        "RandomHorizontalFlip": {"p": 0.5},
    },
    "callbacks": {
        "model_checkpoint": {
            "save_dir": "checkpoints",
            "save_name": "model",
            "save_best": True,
            "monitor": "validation_mIoU",
            "mode": "max",
            "save_freq": 1,
        },
        "early_stopping": {
            "monitor": "validation_mIoU",
            "mode": "max",
            "patience": 5,
        },
        "logging": {
            "wandb": {
                "project_name": "domain_adaptation",
                "run_name": "v1",
                "note": "Domain Adaptation",
            },
        },
        "images_plots": {"save_dir": "images", "number_of_samples": 4},
        # ours: per-batch/epoch/validation JSONL recorder
        # (callbacks/history.py); None = disabled
        "history": None,
    },
    # `cpu` runs on the CPU; anything else on the GPU.  The JAX package
    # reads "tpu" here; the port treats that as the GPU as well.
    "device": "cuda",
    # on-disk XLA compilation cache (utils/compile_cache.py); "" = off.
    # Kills the minutes-long first-compile on every restart/resume.
    "compilation_cache": "",
    # data: -1 = all remaining devices; optional `spatial: S` shards image
    # height (huge inputs), `model: M` FSDP-shards params/optimizer state,
    # `pipe: P` GPipe-pipelines DeepLab's layer3 (exclusive with the rest)
    "mesh": {"data": -1, "spatial": 1, "model": 1, "pipe": 1},
    "precision": {
        # params stay float32; compute dtype for the conv/matmul path
        "compute_dtype": "float32",
        "inference_dtype": "bfloat16",
    },
}


def default_config() -> ConfigNode:
    return ConfigNode(copy.deepcopy(_DEFAULTS))


# Paths whose SUB-keys are user-defined (don't lint inside them).
_FREEFORM = frozenset({
    "callbacks.logging.wandb",   # forwarded to wandb.init
    "callbacks.history",         # None-defaulted section
    "meta",                      # class_names + any user annotations
})

# Keys that are legitimate but deliberately absent from the defaults:
# the reference's own config.yaml spells the DeepLab pretrain keys
# differently from the code that reads them (config.yaml:36-37 vs
# main.py:206 -- a reference bug we tolerate on input).
_KNOWN_EXTRAS = frozenset({
    "model.deeplab.pretrained",
    "model.deeplab.pretrained_path",
    # declared in the reference's config.yaml:35 but read by no code
    # there (the architecture hard-codes dilation 2/4); accepted silently
    # so the shipped reference config lints clean
    "model.deeplab.output_stride",
    # presence-enabled augmentations (the reference convention:
    # ColorJitter is commented out in its config); listing them in the
    # defaults would switch them on for everyone
    "augmentation.ColorJitter",
    "augmentation.RandomZoom",
})


def lint_config(user: dict, defaults: dict | None = None,
                _prefix: str = "") -> list[str]:
    """Dotted paths of user config keys the schema doesn't know.

    A misspelled key (``enable:`` for ``enabled:``) would otherwise be
    silently ignored -- the feature just never turns on.  The defaults
    tree (the full documented schema, reference keys + ours) is the
    source of truth; sections in :data:`_FREEFORM` accept arbitrary
    sub-keys.  Returns warnings with a did-you-mean hint; never raises.
    """
    import difflib

    defaults = _DEFAULTS if defaults is None else defaults
    problems: list[str] = []
    for key, value in user.items():
        path = f"{_prefix}{key}"
        if path in _KNOWN_EXTRAS:
            continue
        if key not in defaults:
            hint = difflib.get_close_matches(
                str(key), [str(k) for k in defaults], n=1)
            problems.append(
                path + (f" (did you mean {hint[0]!r}?)" if hint else ""))
            continue
        if path in _FREEFORM:
            continue
        dflt = defaults[key]
        if isinstance(value, dict) and isinstance(dflt, dict):
            problems.extend(lint_config(value, dflt, _prefix=path + "."))
    return problems


def load_config(path: str | None = None, overrides: dict | None = None,
                lint: bool = True) -> ConfigNode:
    """Load a reference-schema YAML config, merged over our defaults.

    Unknown keys pass through untouched so user configs written for the
    reference's ``config.yaml`` work unmodified -- but each one prints a
    ``config warning:`` line (see :func:`lint_config`), because an
    unknown key is usually a typo'd feature switch doing nothing.
    """
    data = copy.deepcopy(_DEFAULTS)
    if path is not None:
        try:
            with open(path) as f:
                user = yaml.safe_load(f) or {}
        except FileNotFoundError:
            raise FileNotFoundError(
                "Config file not found. Please provide the correct path to "
                f"the config file. (got: {path})")
        if lint:
            for problem in lint_config(user):
                print(f"config warning: unknown key {problem}")
        data = _deep_merge(data, user)
    if overrides:
        data = _deep_merge(data, overrides)
    return ConfigNode(data)
