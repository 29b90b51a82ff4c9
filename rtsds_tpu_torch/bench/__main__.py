"""The port's one-line bench: ``python -m rtsds_tpu_torch.bench``.

Counterpart of the root ``bench.py`` (which drives the JAX package).
Prints ONE JSON line: the headline record, BiSeNet-R18 serving at
1024x2048 (forward + argmax, inputs on the card, bf16) in images per
second, or DeepLabV2-R101 at 512x1024 under ``BENCH_MODEL=deeplab``; its
p50 and p99 per batch, the FLOPs of one image's forward and the ``mfu``
against the card's dense bf16 peak (``null`` for a card without a peak in
:data:`rtsds_tpu_torch.bench.flops.BF16_DENSE_PEAK_FLOPS`); the card's
name and power limit as ``nvidia-smi`` gives them; a nested
``da_training`` record (the fused DA v1 step, b8, 720x1280 source,
512x1024 target, bf16, ``bench/da_bench.py``); and a nested ``models``
section: DeepLabV2-R101 serving at b8 512x1024 and the DA v2 step rate.
It keeps no TPU ratio (``vs_baseline*``): those are the TPU's targets.

Env knobs (``bench.py``'s): BENCH_MODEL (bisenet), BENCH_BATCH (64 for
BiSeNet, 8 for DeepLab), BENCH_ITERS (100) and BENCH_REPEATS (1), whose
product is the number of per-call samples (p99 needs 100), BENCH_DA (0
skips the DA records), BENCH_DA_BATCH (8), BENCH_DA_STEPS (5),
BENCH_MODELS (0 skips the ``models`` section).  Without a GPU it raises.
"""

from __future__ import annotations

import json
import os
import subprocess

import torch

from rtsds_tpu_torch.bench.da_bench import da_step_benchmark
from rtsds_tpu_torch.bench.latency import (
    bisenet_inference_benchmark, deeplab_inference_benchmark)
from rtsds_tpu_torch.device import resolve_device


def card_name_and_power_limit(device: torch.device) -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, or
    ``"cpu"`` on the CPU."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def one_line_record(model: str = "bisenet", batch: int | None = None,
                    iters: int = 100, repeats: int = 1, da: bool = True,
                    da_batch: int = 8, da_steps: int = 5,
                    models: bool = True, device=None,
                    image_size=None, deeplab_size=(512, 1024),
                    src_hw=(720, 1280), tgt_hw=(512, 1024)) -> dict:
    """The bench's JSON record.  The sizes are the records' own; the tests
    pass small ones with ``device="cpu"``."""
    device = resolve_device(device)
    if model == "deeplab":
        batch = batch or 8
        size = tuple(image_size or deeplab_size)
        stats = deeplab_inference_benchmark(
            image_size=size, batch_size=batch, iterations=iters,
            repeats=repeats, device=device)
    elif model == "bisenet":
        batch = batch or 64
        size = tuple(image_size or (1024, 2048))
        stats = bisenet_inference_benchmark(
            image_size=size, batch_size=batch, iterations=iters,
            repeats=repeats, device=device)
    else:
        raise ValueError(f"BENCH_MODEL {model!r}: bisenet or deeplab")
    result = {
        "metric": f"{model}_{size[0]}x{size[1]}_inference_fps",
        "value": stats["fps"],
        "unit": "images/sec",
        "p50_ms": stats["p50_ms"],  # per batch call
        "p50_ms_per_image": stats["p50_ms"] / batch,
        "p99_ms": stats["p99_ms"],
        "samples": stats["samples"],
        "batch_size": batch,
        "dtype": stats["dtype"],
        "flops_per_image": stats["flops_per_image"],
        "mfu": stats["mfu"],
        "device": card_name_and_power_limit(device),
    }
    if da:
        v1 = da_step_benchmark(batch_size=da_batch, steps=da_steps,
                               src_hw=src_hw, tgt_hw=tgt_hw, device=device)
        result["da_training"] = {
            "metric": "da_train_steps_per_sec",
            "value": v1["steps_per_sec"],
            "unit": "steps/sec",
            "ms_per_step": v1["ms_per_step"],
            "batch_size": da_batch,
            "src_hw": v1["src_hw"],
            "tgt_hw": v1["tgt_hw"],
            "dtype": v1["dtype"],
            "max_memory_gb": v1["max_memory_gb"],
        }
    if models:
        section = {}
        if model != "deeplab":
            dl = deeplab_inference_benchmark(
                image_size=deeplab_size, batch_size=8,
                iterations=iters, repeats=repeats, device=device)
            section["deeplab_512x1024_serving"] = {
                "fps": dl["fps"], "p50_ms": dl["p50_ms"],
                "p99_ms": dl["p99_ms"], "batch_size": 8,
                "image_size": dl["image_size"], "dtype": dl["dtype"],
                "flops_per_image": dl["flops_per_image"], "mfu": dl["mfu"]}
        if da:
            v2 = da_step_benchmark(batch_size=da_batch, steps=3, repeats=2,
                                   variant="v2", src_hw=src_hw,
                                   tgt_hw=tgt_hw, device=device)
            section["da_v2_steps_per_sec"] = {
                "value": v2["steps_per_sec"],
                "ms_per_step": v2["ms_per_step"],
                "batch_size": v2["batch_size"]}
        if section:
            result["models"] = section
    return result


def main() -> int:
    env = os.environ
    batch = env.get("BENCH_BATCH")
    print(json.dumps(one_line_record(
        model=env.get("BENCH_MODEL", "bisenet"),
        batch=int(batch) if batch else None,
        iters=int(env.get("BENCH_ITERS", "100")),
        repeats=int(env.get("BENCH_REPEATS", "1")),
        da=env.get("BENCH_DA", "1") != "0",
        da_batch=int(env.get("BENCH_DA_BATCH", "8")),
        da_steps=int(env.get("BENCH_DA_STEPS", "5")),
        models=env.get("BENCH_MODELS", "1") != "0")))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
