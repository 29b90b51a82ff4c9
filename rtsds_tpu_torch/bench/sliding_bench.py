"""Sliding-window panorama serving on the card, bf16.

Counterpart of ``rtsds_tpu/bench/sliding_bench.py``: the whole sliding
predict (``eval/sliding.py``: the windows stacked into batched forwards,
the softmax blend, the argmax) over a 2048x4096 panorama in 1024x2048
windows with 25% overlap, timed per call with the inputs on the card
(:func:`rtsds_tpu_torch.bench.latency.latency_benchmark`).

Run: ``python -m rtsds_tpu_torch.bench.sliding_bench``; prints one JSON
line.  Env: SL_IMAGE ("2048,4096"), SL_WINDOW ("1024,2048"), SL_BATCH (1),
SL_ITERS (20), SL_REPEATS (1), SL_MODEL (bisenet), SL_CHUNK (0 = all
windows in one batched forward; 1 = one window per forward), SL_INT8 (0;
1 also times the W8A8 int8 model, calibrated on the bench input, through
the same predict).  Without a GPU it raises.
"""

from __future__ import annotations

import json
import os

import torch

from rtsds_tpu_torch.bench.latency import (
    int8_timing, latency_benchmark, make_model, random_input)
from rtsds_tpu_torch.device import resolve_device
from rtsds_tpu_torch.eval.sliding import _positions, make_sliding_predict


def bench_sliding(image_size=(2048, 4096), window=(1024, 2048), batch=1,
                  iterations=20, repeats=1, model_name="bisenet",
                  include_int8=False, window_chunk=None, device=None,
                  seed: int = 0) -> dict:
    """Time the full sliding predict in bf16; ``window_chunk=1`` runs the
    windows one forward at a time.  ``include_int8`` also times the W8A8
    model of the same weights (default policy, calibrated on the bench
    input) through the same predict."""
    device = resolve_device(device)
    model = make_model(model_name, device, seed=seed)
    x = random_input((batch, 3, *image_size), device, seed)

    def timed(net):
        def forward(x):
            return net(x.to(torch.bfloat16))

        predict = torch.inference_mode()(make_sliding_predict(
            forward, image_size, window=window, window_chunk=window_chunk))
        return latency_benchmark(predict, (x,), iterations=iterations,
                                 repeats=repeats, images_per_call=batch,
                                 device=device)

    stats = timed(model)
    stride = (window[0] * 3 // 4, window[1] * 3 // 4)
    n_windows = (len(_positions(image_size[0], window[0], stride[0]))
                 * len(_positions(image_size[1], window[1], stride[1])))
    out = {"bench": f"{model_name}_sliding_serving",
           "image_size": list(image_size), "window": list(window),
           "windows_per_frame": n_windows, "batch": batch,
           "window_chunk": window_chunk, "samples": stats["samples"],
           "bf16_ms": stats["mean_ms"], "bf16_p50_ms": stats["p50_ms"],
           "bf16_fps": stats["fps"], "device": stats["device"]}
    if include_int8:
        out.update(int8_timing(timed, model_name, model, x, stats, device))
    return out


def main():
    size = tuple(int(v) for v in
                 os.environ.get("SL_IMAGE", "2048,4096").split(","))
    window = tuple(int(v) for v in
                   os.environ.get("SL_WINDOW", "1024,2048").split(","))
    print(json.dumps(bench_sliding(
        image_size=size, window=window,
        batch=int(os.environ.get("SL_BATCH", "1")),
        iterations=int(os.environ.get("SL_ITERS", "20")),
        repeats=int(os.environ.get("SL_REPEATS", "1")),
        model_name=os.environ.get("SL_MODEL", "bisenet"),
        window_chunk=int(os.environ.get("SL_CHUNK", "0")) or None,
        include_int8=os.environ.get("SL_INT8", "0") != "0")))


if __name__ == "__main__":
    main()
