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
        [--generator bisenet|deeplab]

prints one JSON line for batch 8, a 720x1280 source and a 512x1024 target
in bf16.  Without a GPU it raises.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from rtsds_tpu_torch.device import resolve_device
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2, frozen_bn_parameters
from rtsds_tpu_torch.models.discriminator import TinyDomainDiscriminator
from rtsds_tpu_torch.train.adversarial import (
    make_adversarial_step, v1_discriminator_update, v1_generator_update)
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.state import TrainState
from rtsds_tpu_torch.utils.schedules import poly_lr_schedule

LAMBDA = 0.1
ITERATIONS = 100
EPOCHS = 50
WARMUP_STEPS = 2


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def da_step_benchmark(batch_size: int = 8, src_hw=(720, 1280),
                      tgt_hw=(512, 1024), steps: int = 5, repeats: int = 3,
                      dtype: torch.dtype = torch.bfloat16,
                      variant: str = "v1", grl_alpha: float = 0.0,
                      seed: int = 0, generator: str = "bisenet") -> dict:
    """``ms_per_step`` is the median over ``repeats`` of the mean step time
    of ``steps`` chained steps; ``split_ms`` (v1 without reversal) the
    median generator and discriminator phase times over the same number of
    steps; ``max_memory_gb`` the peak of the allocated device memory during
    the run, ``memory_at_start_gb`` what was allocated before it."""
    device = resolve_device(None)
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
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
    step = make_adversarial_step(LAMBDA, ITERATIONS, EPOCHS, variant=variant,
                                 grl_alpha=grl_alpha)

    for _ in range(WARMUP_STEPS):
        metrics = step(gen, dis, src, labels, tgt)
    float(metrics["loss_gen_source"])
    times = []
    for _ in range(repeats):
        start, end = _events()
        start.record()
        for _ in range(steps):
            metrics = step(gen, dis, src, labels, tgt)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / steps)
    last_loss = float(metrics["loss_gen_source"])

    split = None
    if variant == "v1" and not grl_alpha:
        phases = {"generator": [], "discriminator": []}
        for _ in range(steps):
            (start, mid), (_, end) = _events(), _events()
            start.record()
            src_main, tgt_main, _, _ = v1_generator_update(
                gen, dis, src, labels, tgt, LAMBDA, ITERATIONS)
            mid.record()
            v1_discriminator_update(dis, src_main, tgt_main, ITERATIONS)
            end.record()
            end.synchronize()
            phases["generator"].append(start.elapsed_time(mid))
            phases["discriminator"].append(mid.elapsed_time(end))
        split = {k: statistics.median(v) for k, v in phases.items()}

    ms = statistics.median(times)
    return {"ms_per_step": ms, "ms_per_step_all": times,
            "steps_per_sec": 1000.0 / ms, "split_ms": split,
            "batch_size": batch_size, "src_hw": list(src_hw),
            "tgt_hw": list(tgt_hw), "dtype": str(dtype).replace("torch.", ""),
            "generator": gen_name, "variant": variant,
            "grl_alpha": grl_alpha, "steps": steps,
            "repeats": repeats, "last_loss_gen_source": last_loss,
            "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "memory_at_start_gb": at_start / 1e9,
            "device": torch.cuda.get_device_name(device)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variant", choices=["v1", "v2"], default="v1")
    parser.add_argument("--grl-alpha", type=float, default=0.0,
                        help="> 0: the gradient-reversal step (v1 only)")
    parser.add_argument("--generator", choices=["bisenet", "deeplab"],
                        default="bisenet")
    args = parser.parse_args(argv)
    print(json.dumps(da_step_benchmark(variant=args.variant,
                                       grl_alpha=args.grl_alpha,
                                       generator=args.generator)))


if __name__ == "__main__":
    main()
