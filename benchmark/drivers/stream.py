"""Streamed serving: host frames through ``Predictor.predict_iter``.

Set-up makes the weights (bf16, the served type) and a pool of uint8
frames from the seed, as a decoder hands them (pageable host memory), and
builds the program's ``Predictor`` at the configuration's serving size.
The window hands the pool's batches, cycled, to ``predict_iter``, which
keeps one batch in flight, until ``--seconds`` are spent; the masks come
back as int32 on the host.

``frames_per_s``: frames whose masks reached the host within the window,
over its length.  ``frame_latency_p95_ms``: the nearest-rank 95th
percentile over every frame of the window of the time from its batch's
hand-off to ``predict_iter`` to the yield of its masks.

Correctness: a sample of the served frames, drawn from the seed, is run
once more through the float32 reference after the window.  For each pixel
the gap is how far the reference's logit of the served class lies below
its best, over the frame's spread of logits across the classes (the root
mean over its pixels of their variance across classes).  ``gap_max`` is
the widest, ``gap_mean`` the mean over the sample; ``bad_masks`` counts
masks that were missing, of the wrong shape or type, or held an id outside
the classes.  The control (``mode="control"``) serves the same sample
from the reference in float8.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from benchmark import harness, hostload, seeds, trace as tracing
from benchmark.reference import lowp, models
from benchmark.reference.layers import set_precision
from benchmark.reference.transform import normalize
from benchmark.stats import percentile

SAMPLE = 16
CONTROL = "fp8"


def dtype_of(cfg) -> torch.dtype:
    """The configuration's serving dtype."""
    return getattr(torch, cfg["dtype"])


def run(cell: harness.Cell) -> harness.Outcome:
    cfg, tr, device = cell.config, cell.traffic, torch.device(cell.device)
    hw, b, classes = tuple(cfg["serve_hw"]), int(tr["batch"]), \
        int(cfg["num_classes"])
    frames, _ = seeds.scenes(seeds.sub_seed(cell.seed, 2),
                             int(tr["pool_batches"]) * b, hw,
                             int(tr["block"]), device)
    pool = frames.cpu().numpy()
    del frames
    cell.mark("pools")
    weights = served_weights(cell, pool[:b], device)
    cell.mark("weights")
    host_weights = {k: v.cpu() for k, v in weights.items()}
    rng = np.random.default_rng(seeds.sub_seed(cell.seed, 3))
    if cell.mode == "control":
        picks = rng.choice(len(pool), min(SAMPLE, len(pool)), replace=False)
        outcome = harness.Outcome(0, 0, time.perf_counter(), {}, {}, {})
        sample = [(int(i), None) for i in picks]
    else:
        outcome, sample = serve(cell, weights, pool, rng)
    del weights
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    outcome.checks = compare(cell, pool, sample, outcome.counters,
                             host_weights)
    return outcome


def served_weights(cell, frames, device) -> dict:
    """The served weights: the seed's draw, with each batch norm's running
    mean 0 and running variance the mean square of its input on
    ``frames`` (one float32 pass of the reference in eval mode, each batch
    norm set as the pass reaches it), so that every layer's output has the
    scale a trained network's has, and the scale of the batch norm that
    ends each residual branch divided by the square root of the number of
    residual blocks, as trained ResNets' are small (De and Smith, 2020,
    "Batch normalization biases residual blocks towards the identity");
    in the served dtype.

    Without the statistics the activations grow with depth and saturate
    BiSeNet's attention gates; without the small branches ResNet-101's
    101 normalized layers amplify a rounding error tenfold.  Either way
    the served classes of some seeds hang on rounding even in float32."""
    from benchmark.reference.layers import Residual

    cfg = cell.config
    spec = models.network(cfg["reference"], int(cfg["num_classes"]))
    model = models.loaded(spec, seeds.make_weights(
        spec, seeds.sub_seed(cell.seed, 1), device), device).eval()
    blocks = [m for m in model.modules() if isinstance(m, Residual)]
    with torch.no_grad():
        for block in blocks:
            block.last_bn.weight.div_(len(blocks) ** 0.5)

    def second_moment(bn, args):
        x = args[0]
        bn.running_mean.zero_()
        bn.running_var.copy_(x.square().mean(dim=(0, 2, 3)))

    hooks = [m.register_forward_pre_hook(second_moment)
             for m in model.modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    try:
        with torch.no_grad(), lowp.strict_float32():
            model(normalize(torch.from_numpy(frames).to(device))
                  .permute(0, 3, 1, 2))
    finally:
        for h in hooks:
            h.remove()
    return {k: v.to(dtype_of(cfg)) if v.is_floating_point() else v
            for k, v in model.state_dict().items()}


def serve(cell, weights, pool, rng):
    from rtsds_tpu_torch.serve import Predictor

    cfg, tr, device = cell.config, cell.traffic, torch.device(cell.device)
    hw, b = tuple(cfg["serve_hw"]), int(tr["batch"])
    n_batches = len(pool) // b
    predictor = Predictor(
        state=weights, image_size=hw, batch_size=b,
        num_classes=int(cfg["num_classes"]), dtype=dtype_of(cfg),
        device=device, **cfg["program_serve"])
    cell.mark("program_build")
    span = torch.profiler.record_function if cell.trace \
        else (lambda name: contextlib.nullcontext())
    handed, order = [], []

    def frames(t_end):
        k = 0
        while True:
            with span("bench.next_frames"):
                if time.perf_counter() >= t_end:
                    return
                i = k % n_batches
                batch = pool[i * b:(i + 1) * b]
            handed.append(time.perf_counter())
            order.append(i)
            k += 1
            yield batch

    # warm-up: the pool once through the stream, every shape it uses
    for _ in predictor.predict_iter(pool[i * b:(i + 1) * b]
                                    for i in range(n_batches)):
        pass
    setup_peak = 0
    if device.type == "cuda":
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    cell.mark("warmup")

    yielded, sample, malformed = [], [], 0
    seen = 0
    with tracing.profiled(cell.trace) as prof:
        t0 = time.perf_counter()
        t_end = t0 + cell.seconds
        stream = predictor.predict_iter(frames(t_end))
        while True:
            with span("bench.predict_iter"):
                masks = next(stream, None)
            if masks is None:
                break
            with span("bench.masks_read"):
                yielded.append(time.perf_counter())
                k = len(yielded) - 1
                if masks.shape != (b, *hw) or masks.dtype != np.int32:
                    malformed += b
                    continue
                for j in range(b):  # reservoir sample over the frames
                    if len(sample) < SAMPLE:
                        sample.append((order[k] * b + j,
                                       masks[j].astype(np.uint8)))
                    else:
                        r = int(rng.integers(0, seen + 1))
                        if r < SAMPLE:
                            sample[r] = (order[k] * b + j,
                                         masks[j].astype(np.uint8))
                    seen += 1
    peak = setup_peak
    if device.type == "cuda":
        peak = max(setup_peak, torch.cuda.max_memory_allocated())
    done = sum(b for y in yielded if y <= t_end)
    lat = [yielded[k] - handed[k] for k in range(len(yielded))]
    metrics = {"frames_per_s": done / cell.seconds,
               "frame_latency_p95_ms":
                   1e3 * percentile([x for x in lat for _ in range(b)], 95)}
    missing = (len(handed) - len(yielded)) * b
    gaps = sorted(1e3 * (y - x) for x, y in zip(yielded, yielded[1:]))
    counters = {"frames": len(yielded) * b, "batches": len(yielded),
                "batch_gap_ms": {f"p{q}": round(percentile(gaps, q), 3)
                                 for q in (10, 50, 90)} if gaps else {},
                "batch": b, "latency_samples": len(lat) * b,
                "missing": missing,
                "malformed": malformed,
                **hostload.counters(cell.host_start, prof)}
    del predictor, stream
    outcome = harness.Outcome(
        attempted=len(handed) * b, failed=missing + malformed,
        window_start=t0, metrics=metrics, checks={}, counters=counters,
        memory_peak_bytes=peak, trace=prof.trace)
    return outcome, sample


@torch.no_grad()
def compare(cell, pool, sample, counters, weights) -> dict:
    """The gaps of the served classes under the float32 reference, which
    gets the served weights from the host."""
    cfg, device = cell.config, torch.device(cell.device)
    classes = int(cfg["num_classes"])
    ref = models.loaded(models.network(cfg["reference"], classes), weights,
                        device).eval()
    control = None
    if cell.mode == "control":
        control = set_precision(models.loaded(
            models.network(cfg["reference"], classes), weights,
            device).eval(), CONTROL)
    gap_max, gap_sum, pixels = 0.0, 0.0, 0
    bad = counters.get("missing", 0) + counters.get("malformed", 0)
    with lowp.strict_float32():
        for index, served in sample:
            x = normalize(torch.from_numpy(pool[index:index + 1]).to(device))
            x = x.permute(0, 3, 1, 2)
            logits = ref(x)[0]
            if control is not None:
                served = control(x)[0].argmax(dim=0)
            else:
                served = torch.from_numpy(served).to(device).long()
                if served.min() < 0 or served.max() >= classes:
                    bad += 1
                    continue
            spread = logits.var(dim=0, unbiased=False).mean().sqrt()
            gap = (logits.max(dim=0).values
                   - logits.gather(0, served[None])[0]) / spread
            gap_max = max(gap_max, float(gap.max()))
            gap_sum += float(gap.sum())
            pixels += gap.numel()
    return {"gap_max": gap_max, "gap_mean": gap_sum / max(pixels, 1),
            "bad_masks": float(bad)}
