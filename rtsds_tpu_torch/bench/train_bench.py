"""Supervised train-step rate on one GPU, for BiSeNet or DeepLabV2.

One step is ``train/supervised.py``'s: the train-mode forward, the cross
entropy of the model's heads, the backward and one Adam update (poly
rate; DeepLabV2's batch-norm affines frozen, as its trainer keeps them).
Inputs are random normal frames made on the card from a seed, labels all
class 0.  Steps run back to back through the train state, which each step
updates in place; after warmup, CUDA events bracket each repeat of
``steps`` steps, and the last step's loss is read.

    python -m rtsds_tpu_torch.bench.train_bench [--model deeplab] \
        [--bn_eval] [--remat] [--batch 8] [--size "720, 1280"]

prints one JSON line (bf16).  Without a GPU it raises.  Distillation and
QAT steps are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from rtsds_tpu_torch.config import parse_int_list
from rtsds_tpu_torch.device import resolve_device
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2, frozen_bn_parameters
from rtsds_tpu_torch.train.factory import not_ported
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.state import TrainState
from rtsds_tpu_torch.train.supervised import make_train_step
from rtsds_tpu_torch.utils.schedules import poly_lr_schedule

WARMUP_STEPS = 2


def supervised_step_benchmark(model_name: str = "bisenet",
                              batch_size: int = 8, image_size=(720, 1280),
                              num_classes: int = 19, steps: int = 5,
                              repeats: int = 3,
                              dtype: torch.dtype = torch.bfloat16,
                              backbone: str = "resnet18",
                              bn_eval: bool = False, remat: bool = False,
                              seed: int = 0) -> dict:
    """``ms_per_step`` is the median over ``repeats`` of the mean step time
    of ``steps`` chained steps; ``max_memory_gb`` the peak of the allocated
    device memory during the run, ``memory_at_start_gb`` what was
    allocated before it."""
    if bn_eval and model_name != "deeplab":
        raise ValueError(f"bn_eval is a deeplab knob (model.deeplab.bn_eval); "
                         f"it does not apply to {model_name!r}")
    device = resolve_device(None)
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if model_name == "deeplab":
            model = DeepLabV2(num_classes=num_classes, bn_eval=bn_eval,
                              remat=remat)
            frozen = frozen_bn_parameters(model)
        elif model_name == "bisenet":
            model = BiSeNet(num_classes=num_classes, context_path=backbone,
                            remat=remat)
            frozen = []
        else:
            raise ValueError(f"unknown model {model_name!r}")
    model.to(device)
    state = TrainState(model, make_optimizer(
        "Adam", model.parameters(), poly_lr_schedule(1e-4, 5000, 0.9),
        frozen=frozen), None if dtype == torch.float32 else dtype)

    rng = torch.Generator(device=device).manual_seed(seed)
    images = torch.randn((batch_size, *image_size, 3), generator=rng,
                         device=device)
    labels = torch.zeros((batch_size, *image_size), dtype=torch.int32,
                         device=device)
    step = make_train_step(ignore_index=num_classes)

    for _ in range(WARMUP_STEPS):
        metrics = step(state, images, labels)
    float(metrics["train_loss"])
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            metrics = step(state, images, labels)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / steps)
    last_loss = float(metrics["train_loss"])

    ms = statistics.median(times)
    return {"model": model_name,
            "backbone": "resnet101" if model_name == "deeplab" else backbone,
            "ms_per_step": ms, "ms_per_step_all": times,
            "steps_per_sec": 1000.0 / ms,
            "samples_per_sec": batch_size * 1000.0 / ms,
            "batch_size": batch_size, "image_size": list(image_size),
            "dtype": str(dtype).replace("torch.", ""), "bn_eval": bn_eval,
            "remat": remat, "steps": steps, "repeats": repeats,
            "last_train_loss": last_loss,
            "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "memory_at_start_gb": at_start / 1e9,
            "device": torch.cuda.get_device_name(device)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=["bisenet", "deeplab"],
                        default="bisenet")
    parser.add_argument("--backbone", default="resnet18",
                        help="BiSeNet's context path")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--size", default="720, 1280", help='"H, W"')
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--bn_eval", action="store_true",
                        help="DeepLabV2 with every BN on its running stats")
    parser.add_argument("--remat", action="store_true",
                        help="recompute each residual block in the backward")
    parser.add_argument("--distill", default=None,
                        help="not ported yet: the distillation step")
    parser.add_argument("--qat", action="store_true",
                        help="not ported yet: the QAT step")
    args = parser.parse_args(argv)
    for flag, what in (("distill", "the distillation step bench"),
                       ("qat", "the QAT step bench")):
        if getattr(args, flag):
            raise SystemExit(str(not_ported(what)))
    stats = supervised_step_benchmark(
        args.model, batch_size=args.batch,
        image_size=tuple(parse_int_list(args.size)), steps=args.steps,
        backbone=args.backbone, bn_eval=args.bn_eval, remat=args.remat)
    print(json.dumps({"metric": f"{args.model}_supervised_train_step",
                      "value": stats["ms_per_step"], "unit": "ms/step",
                      **stats}))


if __name__ == "__main__":
    main()
