"""Multi-scale + flip ensemble serving on the card, bf16.

Counterpart of ``rtsds_tpu/bench/ensemble_bench.py``: the whole blended
predict (``eval/ensemble.py``: each scale's frame and its flip in one
forward, the softmax mean at full size, the argmax) at 1024x2048 over
scales 0.75/1.0/1.25, timed per call with the inputs on the card.

Run: ``python -m rtsds_tpu_torch.bench.ensemble_bench``; prints one JSON
line.  Env: ENS_IMAGE ("1024,2048"), ENS_SCALES ("0.75,1.0,1.25"),
ENS_BATCH (1), ENS_ITERS (20), ENS_REPEATS (1), ENS_MODEL (bisenet),
ENS_INT8 (0; 1 also times the W8A8 int8 model, calibrated on the bench
input, through the same predict).  Without a GPU it raises.
"""

from __future__ import annotations

import json
import os

import torch

from rtsds_tpu_torch.bench.latency import (
    int8_timing, latency_benchmark, make_model, random_input)
from rtsds_tpu_torch.device import resolve_device
from rtsds_tpu_torch.eval.ensemble import make_ensemble_predict


def bench_ensemble(image_size=(1024, 2048), scales=(0.75, 1.0, 1.25),
                   batch=1, iterations=20, repeats=1, model_name="bisenet",
                   include_int8=False, device=None, seed: int = 0) -> dict:
    """Time the full ensemble predict in bf16.  ``include_int8`` also times
    the W8A8 model of the same weights (default policy, calibrated on the
    bench input) through the same predict."""
    device = resolve_device(device)
    model = make_model(model_name, device, seed=seed)
    x = random_input((batch, 3, *image_size), device, seed)

    def timed(net):
        def forward(x):
            return net(x.to(torch.bfloat16))

        predict = torch.inference_mode()(make_ensemble_predict(
            forward, image_size, scales=scales))
        return latency_benchmark(predict, (x,), iterations=iterations,
                                 repeats=repeats, images_per_call=batch,
                                 device=device)

    stats = timed(model)
    out = {"bench": f"{model_name}_ensemble_serving",
           "image_size": list(image_size), "scales": list(scales),
           "batch": batch, "samples": stats["samples"],
           "bf16_ms": stats["mean_ms"], "bf16_p50_ms": stats["p50_ms"],
           "bf16_fps": stats["fps"], "device": stats["device"]}
    if include_int8:
        out.update(int8_timing(timed, model_name, model, x, stats, device))
    return out


def main():
    size = tuple(int(v) for v in
                 os.environ.get("ENS_IMAGE", "1024,2048").split(","))
    scales = tuple(float(v) for v in
                   os.environ.get("ENS_SCALES", "0.75,1.0,1.25").split(","))
    print(json.dumps(bench_ensemble(
        image_size=size, scales=scales,
        batch=int(os.environ.get("ENS_BATCH", "1")),
        iterations=int(os.environ.get("ENS_ITERS", "20")),
        repeats=int(os.environ.get("ENS_REPEATS", "1")),
        model_name=os.environ.get("ENS_MODEL", "bisenet"),
        include_int8=os.environ.get("ENS_INT8", "0") != "0")))


if __name__ == "__main__":
    main()
