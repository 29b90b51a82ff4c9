"""Supervised train-step rate on one GPU, for BiSeNet or DeepLabV2.

One step is ``train/supervised.py``'s: the train-mode forward, the cross
entropy of the model's heads, the backward and one Adam update (poly
rate; DeepLabV2's batch-norm affines frozen, as its trainer keeps them).
Inputs are random normal frames made on the card from a seed, labels all
class 0.  Steps run back to back through the train state, which each step
updates in place; after warmup, CUDA events bracket each repeat of
``steps`` steps, and the last step's loss is read.

    python -m rtsds_tpu_torch.bench.train_bench [--model deeplab] \
        [--bn_eval] [--remat] [--batch 8] [--size "720, 1280"] \
        [--distill deeplab|bisenet]

prints one JSON line (bf16).  ``--distill MODEL`` benches the distillation
step (``train/distill.py``) with a teacher of that model made from the seed
+ 1, whose eval forward the step runs; the line adds the teacher forward's
own time; ``--distill_quant int8`` makes that teacher the W8A8 int8 model
(calibrated on the bench input).  ``--qat`` benches the QAT fine-tune step
(``train/qat.py``: the fake-quant forward over the BN-folded tree, float32
by design).  Without a GPU it raises.
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
from rtsds_tpu_torch.train.distill import make_distill_step, quantize_teacher
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.qat import create_qat_state, prepare_qat
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
                              seed: int = 0, distill: str | None = None,
                              distill_quant: str | None = None,
                              qat: bool = False) -> dict:
    """``ms_per_step`` is the median over ``repeats`` of the mean step time
    of ``steps`` chained steps; ``max_memory_gb`` the peak of the allocated
    device memory during the run, ``memory_at_start_gb`` what was
    allocated before it; with ``distill``, ``teacher_forward_ms`` the
    median time of the teacher's eval forward alone (``distill_quant=
    "int8"``: the int8 teacher's).  ``qat`` times the QAT step, float32
    whatever ``dtype``."""
    if bn_eval and model_name != "deeplab":
        raise ValueError(f"bn_eval is a deeplab knob (model.deeplab.bn_eval); "
                         f"it does not apply to {model_name!r}")
    if distill_quant not in (None, "int8"):
        # a mistyped name must not bench the full-precision teacher under
        # an int8 label
        raise ValueError(f"distill_quant {distill_quant!r} is not supported "
                         f"(int8)")
    if qat and (distill or bn_eval):
        raise ValueError("qat composes with neither distill nor bn_eval "
                         "(BN is frozen-folded already)")
    device = resolve_device(None)
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()

    def make(name, model_seed, remat=False, bn_eval=False):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(model_seed)
            if name == "deeplab":
                model = DeepLabV2(num_classes=num_classes, bn_eval=bn_eval,
                                  remat=remat)
                return model, frozen_bn_parameters(model)
            if name == "bisenet":
                return BiSeNet(num_classes=num_classes, context_path=backbone,
                               remat=remat), []
        raise ValueError(f"unknown model {name!r}")

    model, frozen = make(model_name, seed, remat=remat, bn_eval=bn_eval)
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
    if qat:
        prep = prepare_qat(model_name, model.state_dict(),
                           [images.permute(0, 3, 1, 2)], device=device)
        del model, state
        state = create_qat_state(prep, poly_lr_schedule(1e-4, 5000, 0.9))
        dtype = torch.float32
    teacher_ms = None
    if distill:
        teacher = make(distill, seed + 1)[0].to(device)
        if distill_quant:
            teacher = quantize_teacher(distill, teacher.state_dict(),
                                       [images.permute(0, 3, 1, 2)],
                                       device=device)
        step = make_distill_step(teacher, ignore_index=num_classes)
        x = images.permute(0, 3, 1, 2)
        teacher_times = []
        for i in range(WARMUP_STEPS + repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            with torch.no_grad(), state.autocast():
                teacher(x)
            end.record()
            end.synchronize()
            if i >= WARMUP_STEPS:
                teacher_times.append(start.elapsed_time(end))
        teacher_ms = statistics.median(teacher_times)

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
            "remat": remat, "distill": distill,
            "distill_quant": distill_quant, "qat": qat,
            "teacher_forward_ms": teacher_ms, "steps": steps,
            "repeats": repeats,
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
    parser.add_argument("--distill", choices=["bisenet", "deeplab"],
                        default=None,
                        help="bench the distillation step with a teacher "
                             "of this model")
    parser.add_argument("--distill_quant", choices=["int8"], default=None,
                        help="with --distill: the W8A8 int8 teacher")
    parser.add_argument("--qat", action="store_true",
                        help="bench the QAT fine-tune step (float32)")
    args = parser.parse_args(argv)
    stats = supervised_step_benchmark(
        args.model, batch_size=args.batch,
        image_size=tuple(parse_int_list(args.size)), steps=args.steps,
        backbone=args.backbone, bn_eval=args.bn_eval, remat=args.remat,
        distill=args.distill, distill_quant=args.distill_quant, qat=args.qat)
    kind = ("qat" if args.qat else "distill_int8" if args.distill_quant
            else "distill" if args.distill else "supervised")
    print(json.dumps({"metric": f"{args.model}_{kind}_train_step",
                      "value": stats["ms_per_step"], "unit": "ms/step",
                      **stats}))


if __name__ == "__main__":
    main()
