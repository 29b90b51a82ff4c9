"""Train state from config: model, optimizer, schedule, compute dtype.

``build_supervised`` is the supervised path for BiSeNet: the poly learning
rate over ``max_iter = epochs * steps_per_epoch`` steps, gated by
``lr_decay_iter``, with an optional linear warmup, and the optimizer of
``model.bisenet.optimizer``.  ``build_adversarial`` is the domain
adaptation path: a BiSeNet generator and a domain discriminator, each with
its own optimizer and schedule.
"""

from __future__ import annotations

import torch
from torch import nn

from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.discriminator import (
    DomainDiscriminator, TinyDomainDiscriminator)
from rtsds_tpu_torch.ops.losses import make_criterion
from rtsds_tpu_torch.train.optim import optimizer_from_config
from rtsds_tpu_torch.train.state import TrainState
from rtsds_tpu_torch.utils.schedules import (
    poly_epoch_schedule, poly_lr_schedule, with_warmup)

COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet to "
                               f"rtsds_tpu_torch; use rtsds_tpu for it")


def compute_dtype_from_config(config) -> torch.dtype | None:
    name = str(config.get("precision", {}).get("compute_dtype", "float32"))
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"precision.compute_dtype {name!r}: expected one of "
                         f"{sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def load_backbone_pretrained(model: BiSeNet, path: str) -> None:
    """An ImageNet ResNet state dict in torchvision's names (a ``.pth``
    file) into ``model.context_path``; its ``fc`` classifier is dropped."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    state = {k: v for k, v in state.items() if not k.startswith("fc.")}
    model.context_path.load_state_dict(state, strict=True)


def make_bisenet(cfg, seed: int = 0) -> BiSeNet:
    """model.bisenet section -> a BiSeNet initialised from ``seed``."""
    if bool(cfg.get("remat", False)):
        raise not_ported("model.bisenet.remat")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = BiSeNet(num_classes=int(cfg["num_classes"]),
                        context_path=str(cfg["backbone"]))
    path = cfg.get("pretrain_model_path", "") or ""
    if cfg.get("pretrained", False) and path:
        load_backbone_pretrained(model, path)
    return model


def build_supervised(config, model_name: str, steps_per_epoch: int,
                     device: torch.device | str, seed: int = 0) -> TrainState:
    """The supervised train state, its model on ``device``."""
    if model_name == "deeplab":
        raise not_ported("DeepLabV2 training (--model deeplab)")
    if model_name != "bisenet":
        raise ValueError(
            "Invalid model name. Please select deeplab or bisenet")
    tcfg = config.training.get("segmentation")
    cfg = config.model.get("bisenet")
    max_iter = int(tcfg["epochs"]) * int(steps_per_epoch)
    schedule = with_warmup(
        poly_lr_schedule(float(cfg["optimizer"]["lr"]), max_iter,
                         float(cfg.get("power_lr_factor", 0.9)),
                         int(tcfg["lr_decay_iter"])),
        int(tcfg.get("warmup_iters", 0)))
    model = make_bisenet(cfg, seed).to(device)
    optimizer = optimizer_from_config(cfg["optimizer"], model, schedule)
    return TrainState(model, optimizer, compute_dtype_from_config(config))


def make_discriminator(cfg, seed: int = 0) -> nn.Module:
    """model.adversarial_model.discriminator section -> a discriminator
    initialised from ``seed``: ``tiny``, or ``fc``/``full``/``domain``."""
    in_ch = int(cfg.get("input_channels", 19))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if cfg["name"] == "tiny":
            return TinyDomainDiscriminator(num_classes=in_ch)
        if cfg["name"] in ("fc", "full", "domain"):
            return DomainDiscriminator(num_classes=in_ch)
    raise ValueError(f"unknown discriminator {cfg['name']!r}")


def build_adversarial(config, device: torch.device | str, seed: int = 0
                      ) -> tuple[TrainState, TrainState]:
    """The (generator, discriminator) train states of domain adaptation,
    their models on ``device``.

    The generator's rate is poly over ``epochs * iterations`` steps, gated
    by ``lr_decay_iter``.  The discriminator's decays once per epoch under
    v1 and like the generator's under v2.  Both take ``warmup_iters``.  G
    is initialised from ``seed``, D from ``seed + 1``.
    """
    adv_cfg = config.model.get("adversarial_model")
    tcfg = config.training.get("domain_adaptation")
    epochs = int(tcfg["epochs"])
    iterations = int(tcfg["iterations"])
    lr_decay_iter = int(tcfg["lr_decay_iter"])
    warmup = int(tcfg.get("warmup_iters", 0))
    dtype = compute_dtype_from_config(config)

    gen_cfg = adv_cfg.get("generator")
    dis_cfg = adv_cfg.get("discriminator")
    # an unknown loss name raises, as building the criteria does in the
    # JAX package
    make_criterion(gen_cfg["criterion"])
    make_criterion(dis_cfg["criterion"])
    if gen_cfg["name"] == "deeplab":
        raise not_ported("a DeepLabV2 generator")
    if gen_cfg["name"] != "bisenet":
        raise ValueError("Invalid generator name. Please select deeplab or "
                         "bisenet")
    gen_sched = with_warmup(
        poly_lr_schedule(float(gen_cfg["optimizer"]["lr"]),
                         epochs * iterations,
                         float(gen_cfg["power_lr_factor"]), lr_decay_iter),
        warmup)
    generator = make_bisenet(config.model["bisenet"], seed).to(device)
    gen_state = TrainState(
        generator,
        optimizer_from_config(gen_cfg["optimizer"], generator, gen_sched),
        dtype)

    dis_lr = float(dis_cfg["optimizer"]["lr"])
    dis_power = float(dis_cfg["power_lr_factor"])
    if str(tcfg.get("variant", "v1")) == "v2":
        dis_decay = poly_lr_schedule(dis_lr, epochs * iterations, dis_power,
                                     lr_decay_iter)
    else:
        dis_decay = poly_epoch_schedule(dis_lr, epochs, dis_power, iterations)
    discriminator = make_discriminator(dis_cfg, seed + 1).to(device)
    dis_state = TrainState(
        discriminator,
        optimizer_from_config(dis_cfg["optimizer"], discriminator,
                              with_warmup(dis_decay, warmup)),
        dtype)
    return gen_state, dis_state
