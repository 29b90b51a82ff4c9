"""Adversarial domain-adaptation step rate on one GPU.

One step is the whole iteration: the generator's source and target
forwards, the discriminator's forwards, both backward passes and both
optimizer updates (v2: two more generator forwards).  A BiSeNet-R18 or
DeepLabV2-R101 generator (its batch-norm affines frozen, as its trainer
keeps them) and the Tiny discriminator, both with Adam, on random inputs
made on the card from a seed.  Steps run back to back through the two
train states, which each step updates in place; after warmup, CUDA events bracket each repeat of
``steps`` steps, and the last step's loss is read.  Under v1 the bench
also times the generator phase and the discriminator phase apart, with an
event between them.

    python -m rtsds_tpu_torch.bench.da_bench [--variant v1|v2] [--grl-alpha A] \
        [--generator bisenet|deeplab] [--lambda-ent L] [--fda-beta B] \
        [--self-training [--classmix]]

prints one JSON line for batch 8, a 720x1280 source and a 512x1024 target
in bf16.  ``--lambda-ent`` adds MinEnt and ``--fda-beta`` FDA to the step;
``--self-training`` benches the mean-teacher pseudo-label step (v1, a
threshold of 0.9, the EMA updated in the step), ``--classmix`` with
ClassMix.  Without a GPU it raises; ``device="cpu"`` runs it on the CPU
(the tests), timed by the host clock.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from rtsds_tpu_torch.bench.latency import Clock, device_name
from rtsds_tpu_torch.device import resolve_device
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2, frozen_bn_parameters
from rtsds_tpu_torch.models.discriminator import TinyDomainDiscriminator
from rtsds_tpu_torch.ops.fda import fda_source_to_target
from rtsds_tpu_torch.train.adversarial import (
    make_adversarial_step, v1_discriminator_update, v1_generator_update)
from rtsds_tpu_torch.train.ema import ema_init
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.self_training import make_self_training_step
from rtsds_tpu_torch.train.state import TrainState
from rtsds_tpu_torch.utils.schedules import poly_lr_schedule

LAMBDA = 0.1
ITERATIONS = 100
EPOCHS = 50
WARMUP_STEPS = 2


def da_step_benchmark(batch_size: int = 8, src_hw=(720, 1280),
                      tgt_hw=(512, 1024), steps: int = 5, repeats: int = 3,
                      dtype: torch.dtype = torch.bfloat16,
                      variant: str = "v1", grl_alpha: float = 0.0,
                      seed: int = 0, generator: str = "bisenet",
                      lambda_ent: float = 0.0, fda_beta: float = 0.0,
                      self_training: bool = False,
                      classmix: bool = False, device=None) -> dict:
    """``ms_per_step`` is the median over ``repeats`` of the mean step time
    of ``steps`` chained steps; ``split_ms`` (the plain v1 step) the
    median generator and discriminator phase times over the same number of
    steps; ``fda_ms`` (``fda_beta > 0``) the median time of the FDA of one
    source batch; ``max_memory_gb`` the peak of the allocated device memory
    during the run, ``memory_at_start_gb`` what was allocated before
    it (both None on the CPU)."""
    if self_training and (variant != "v1" or grl_alpha):
        raise ValueError("the self-training step composes with v1 only")
    if classmix and not self_training:
        raise ValueError("classmix is a self-training option")
    device = resolve_device(device)
    cuda = device.type == "cuda"
    clock = Clock(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated() if cuda else None
    compute = None if dtype == torch.float32 else dtype
    gen_name = generator
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if gen_name == "deeplab":
            generator = DeepLabV2(num_classes=19)
            frozen = frozen_bn_parameters(generator)
        elif gen_name == "bisenet":
            generator = BiSeNet(num_classes=19, context_path="resnet18")
            frozen = []
        else:
            raise ValueError(f"unknown generator {gen_name!r}")
        discriminator = TinyDomainDiscriminator(num_classes=19)
    generator.to(device)
    discriminator.to(device)
    gen = TrainState(generator, make_optimizer(
        "Adam", generator.parameters(), poly_lr_schedule(1e-4, 5000, 0.9),
        frozen=frozen), compute)
    dis = TrainState(discriminator, make_optimizer(
        "Adam", discriminator.parameters(), 1e-4, weight_decay=1e-4),
        compute)

    rng = torch.Generator(device=device).manual_seed(seed)
    src = torch.randn((batch_size, *src_hw, 3), generator=rng, device=device)
    labels = torch.zeros((batch_size, *src_hw), dtype=torch.int32,
                         device=device)
    tgt = torch.randn((batch_size, *tgt_hw, 3), generator=rng, device=device)
    if self_training:
        ema = ema_init(generator)
        st_step = make_self_training_step(
            LAMBDA, ITERATIONS, lambda_ent=lambda_ent, fda_beta=fda_beta,
            classmix=classmix, classmix_seed=seed)

        def step(gen, dis, src, labels, tgt):
            return st_step(gen, dis, ema, src, labels, tgt)
    else:
        step = make_adversarial_step(LAMBDA, ITERATIONS, EPOCHS,
                                     variant=variant, grl_alpha=grl_alpha,
                                     lambda_ent=lambda_ent,
                                     fda_beta=fda_beta)

    for _ in range(WARMUP_STEPS):
        metrics = step(gen, dis, src, labels, tgt)
    float(metrics["loss_gen_source"])
    times = []
    for _ in range(repeats):
        start = clock.mark()
        for _ in range(steps):
            metrics = step(gen, dis, src, labels, tgt)
        times.append(clock.ms(start, clock.mark()) / steps)
    last_loss = float(metrics["loss_gen_source"])

    split = None
    plain_v1 = not (grl_alpha or lambda_ent or fda_beta or self_training)
    if variant == "v1" and plain_v1:
        phases = {"generator": [], "discriminator": []}
        for _ in range(steps):
            start = clock.mark()
            src_main, tgt_main, *_ = v1_generator_update(
                gen, dis, src, labels, tgt, LAMBDA, ITERATIONS)
            mid = clock.mark()
            v1_discriminator_update(dis, src_main, tgt_main, ITERATIONS)
            end = clock.mark()
            phases["generator"].append(clock.ms(start, mid))
            phases["discriminator"].append(clock.ms(mid, end))
        split = {k: statistics.median(v) for k, v in phases.items()}

    fda_ms = None
    if fda_beta:
        fda_times = []
        for _ in range(steps):
            start = clock.mark()
            fda_source_to_target(src, tgt, fda_beta)
            fda_times.append(clock.ms(start, clock.mark()))
        fda_ms = statistics.median(fda_times)

    ms = statistics.median(times)
    return {"ms_per_step": ms, "ms_per_step_all": times,
            "steps_per_sec": 1000.0 / ms, "split_ms": split,
            "fda_ms": fda_ms, "lambda_ent": lambda_ent, "fda_beta": fda_beta,
            "self_training": self_training, "classmix": classmix,
            "batch_size": batch_size, "src_hw": list(src_hw),
            "tgt_hw": list(tgt_hw), "dtype": str(dtype).replace("torch.", ""),
            "generator": gen_name, "variant": variant,
            "grl_alpha": grl_alpha, "steps": steps,
            "repeats": repeats, "last_loss_gen_source": last_loss,
            "max_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                              if cuda else None),
            "memory_at_start_gb": at_start / 1e9 if cuda else None,
            "device": device_name(device)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variant", choices=["v1", "v2"], default="v1")
    parser.add_argument("--grl-alpha", type=float, default=0.0,
                        help="> 0: the gradient-reversal step (v1 only)")
    parser.add_argument("--generator", choices=["bisenet", "deeplab"],
                        default="bisenet")
    parser.add_argument("--lambda-ent", type=float, default=0.0,
                        help="> 0: MinEnt on the target logits")
    parser.add_argument("--fda-beta", type=float, default=0.0,
                        help="> 0: FDA of the source by the target")
    parser.add_argument("--self-training", action="store_true",
                        help="the mean-teacher pseudo-label step (v1)")
    parser.add_argument("--classmix", action="store_true",
                        help="ClassMix in the self-training step")
    args = parser.parse_args(argv)
    print(json.dumps(da_step_benchmark(
        variant=args.variant, grl_alpha=args.grl_alpha,
        generator=args.generator, lambda_ent=args.lambda_ent,
        fda_beta=args.fda_beta, self_training=args.self_training,
        classmix=args.classmix)))


if __name__ == "__main__":
    main()
