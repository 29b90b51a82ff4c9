"""Multi-scale + flip ensemble serving on the card, bf16.

Counterpart of ``rtsds_tpu/bench/ensemble_bench.py``: the whole blended
predict (``eval/ensemble.py``: each scale's frame and its flip in one
forward, the softmax mean at full size, the argmax) at 1024x2048 over
scales 0.75/1.0/1.25, timed per call with the inputs on the card.

Run: ``python -m rtsds_tpu_torch.bench.ensemble_bench``; prints one JSON
line.  Env: ENS_IMAGE ("1024,2048"), ENS_SCALES ("0.75,1.0,1.25"),
ENS_BATCH (1), ENS_ITERS (20), ENS_REPEATS (1), ENS_MODEL (bisenet),
ENS_INT8 (0; the int8 path is not ported yet and exits).  Without a GPU
it raises.
"""

from __future__ import annotations

import json
import os

import torch

from rtsds_tpu_torch.bench.latency import (
    latency_benchmark, make_model, random_input)
from rtsds_tpu_torch.device import resolve_device
from rtsds_tpu_torch.eval.ensemble import make_ensemble_predict
from rtsds_tpu_torch.train.factory import not_ported


def bench_ensemble(image_size=(1024, 2048), scales=(0.75, 1.0, 1.25),
                   batch=1, iterations=20, repeats=1, model_name="bisenet",
                   include_int8=False, device=None, seed: int = 0) -> dict:
    """Time the full ensemble predict in bf16.  ``include_int8`` is refused
    until the int8 path is ported."""
    if include_int8:
        raise not_ported("int8 ensemble serving")
    device = resolve_device(device)
    model = make_model(model_name, device, seed=seed)

    def forward(x):
        return model(x.to(torch.bfloat16))

    predict = torch.inference_mode()(make_ensemble_predict(
        forward, image_size, scales=scales))
    x = random_input((batch, 3, *image_size), device, seed)
    stats = latency_benchmark(predict, (x,), iterations=iterations,
                              repeats=repeats, images_per_call=batch,
                              device=device)
    return {"bench": f"{model_name}_ensemble_serving",
            "image_size": list(image_size), "scales": list(scales),
            "batch": batch, "samples": stats["samples"],
            "bf16_ms": stats["mean_ms"], "bf16_p50_ms": stats["p50_ms"],
            "bf16_fps": stats["fps"], "device": stats["device"]}


def main():
    if os.environ.get("ENS_INT8", "0") != "0":
        raise SystemExit(str(not_ported("int8 ensemble serving")))
    size = tuple(int(v) for v in
                 os.environ.get("ENS_IMAGE", "1024,2048").split(","))
    scales = tuple(float(v) for v in
                   os.environ.get("ENS_SCALES", "0.75,1.0,1.25").split(","))
    print(json.dumps(bench_ensemble(
        image_size=size, scales=scales,
        batch=int(os.environ.get("ENS_BATCH", "1")),
        iterations=int(os.environ.get("ENS_ITERS", "20")),
        repeats=int(os.environ.get("ENS_REPEATS", "1")),
        model_name=os.environ.get("ENS_MODEL", "bisenet"))))


if __name__ == "__main__":
    main()
