#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rtsds_tpu_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printing one JSON line; any failure exits non-zero:

  1. device: the card, its power limit, and the build of the CUDA kernels
     from ``rtsds_tpu_torch/ops/cuda/csrc``;
  2. hist_check: the confusion-matrix kernel against its plain PyTorch
     version, exactly, on edge cases and at the eval batch's size;
  3. serving: BiSeNet-R18 at 1024x2048, batch 8, bf16, from a Flax-layout
     weight tree made with numpy from a seed and loaded through the weight
     bridge; masks checked, timed, and held against an f32 run;
  4. validation: ``validate`` over synthetic batches at the same size, each
     step's histogram held against the plain version;
  5. the ``kernels`` line: each kernel's launches on the main path (phases
     3-4), its time, its plain version's, a one-call library yardstick and
     the card's bound.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from rtsds_tpu_torch.data.synthetic import SyntheticSegDataset
from rtsds_tpu_torch.eval.validate import make_eval_step, validate
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.pretrained import (
    load_flax_variables, torch_scope)
from rtsds_tpu_torch.ops.cuda import _build
from rtsds_tpu_torch.ops.cuda.hist import fast_hist_cuda
from rtsds_tpu_torch.ops.preprocess import normalize
from rtsds_tpu_torch.serve import Predictor
from rtsds_tpu_torch.utils.colors import CLASS_NAMES
from rtsds_tpu_torch.utils.metrics import fast_hist

SIZE = (1024, 2048)
BATCH = 8
CLASSES = 19
SEED = 0
SERVE_FRAMES = 16
VAL_BATCHES = 3
# H100 SXM device-memory rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
# least share of pixels whose bf16 mask equals the f32 mask.  Random
# weights leave small top-1/top-2 logit margins, so bf16 rounding flips
# more pixels than it would with trained weights; a broken bf16 path
# agrees on about one pixel in CLASSES (PERF.md)
MIN_BF16_AGREEMENT = 0.85


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, inner: int = 1, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms: CUDA events around ``inner``
    back-to-back calls, ``reps`` times, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def random_flax_bisenet(seed: int, num_classes: int = CLASSES,
                        train: bool = False) -> dict:
    """A BiSeNet-R18 variable tree in the JAX package's Flax layout, made
    with numpy from ``seed``: He-scaled kernels and BN statistics near the
    identity.  ``train=False`` leaves out the two train-only heads, as a
    Flax init for eval does."""
    rng = np.random.default_rng(seed)
    params: dict = {}
    stats: dict = {}

    def node(tree, path):
        for p in path:
            tree = tree.setdefault(p, {})
        return tree

    def conv(path, k, cin, cout, bias=False):
        leaf = node(params, path)
        leaf["kernel"] = (rng.standard_normal((k, k, cin, cout))
                          * np.sqrt(2.0 / (k * k * cin))).astype(np.float32)
        if bias:
            leaf["bias"] = (0.01 * rng.standard_normal(cout)).astype(
                np.float32)

    def bn(path, c):
        node(params, path).update(
            scale=rng.uniform(0.8, 1.2, c).astype(np.float32),
            bias=(0.05 * rng.standard_normal(c)).astype(np.float32))
        node(stats, path).update(
            mean=(0.05 * rng.standard_normal(c)).astype(np.float32),
            var=rng.uniform(0.8, 1.2, c).astype(np.float32))

    def convblock(path, cin, cout):
        conv((*path, "conv1"), 3, cin, cout)
        bn((*path, "bn"), cout)

    for i, (cin, cout) in enumerate(((3, 64), (64, 128), (128, 256)), 1):
        convblock(("spatial_path", f"convblock{i}"), cin, cout)

    conv(("context_path", "conv1"), 7, 3, 64)
    bn(("context_path", "bn1"), 64)
    cin = 64
    for stage, width in enumerate((64, 128, 256, 512), 1):
        for b in range(2):
            scope = ("context_path", f"layer{stage}_{b}")
            stride = 2 if stage > 1 and b == 0 else 1
            conv((*scope, "conv1"), 3, cin, width)
            bn((*scope, "bn1"), width)
            conv((*scope, "conv2"), 3, width, width)
            bn((*scope, "bn2"), width)
            if b == 0 and (stride != 1 or cin != width):
                conv((*scope, "downsample_conv"), 1, cin, width)
                bn((*scope, "downsample_bn"), width)
            cin = width

    for name, c in (("arm1", 256), ("arm2", 512)):
        conv((name, "conv"), 1, c, c, bias=True)
        bn((name, "bn"), c)
    if train:
        conv(("supervision1",), 1, 256, num_classes, bias=True)
        conv(("supervision2",), 1, 512, num_classes, bias=True)
    convblock(("ffm", "convblock"), 256 + 256 + 512, num_classes)
    conv(("ffm", "conv1"), 1, num_classes, num_classes, bias=True)
    conv(("ffm", "conv2"), 1, num_classes, num_classes, bias=True)
    conv(("conv",), 1, num_classes, num_classes, bias=True)
    return {"params": params, "batch_stats": stats}


def calibrate_batch_stats(tree: dict, frames: np.ndarray,
                          device: str = "cpu") -> dict:
    """Replace the tree's BN statistics, in place, by those of ``frames``
    (one f32 train-mode forward, cumulative averages), as training would
    have set them.  Random statistics let the activations grow to ~1e9 and
    the argmax collapse onto two classes; calibrated ones keep the logits
    near unit scale and the predictions spread over classes."""
    model = load_flax_variables(BiSeNet(), tree).to(device)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.reset_running_stats()
            m.momentum = None
    with torch.no_grad():
        x = normalize(torch.from_numpy(frames).to(device))
        model.train()(x.permute(0, 3, 1, 2))
    state = {k: v.cpu() for k, v in model.state_dict().items()}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, (*path, k))
            else:
                key = ".".join([*map(torch_scope, path), "running_" + k])
                node[k] = state[key].numpy().copy()

    walk(tree["batch_stats"], ())
    return tree


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none found")
    smi = gpu_name_and_power_limit()
    t0 = time.perf_counter()
    fresh = not _build.library_path().exists()
    lib_path = _build.build()
    build_s = time.perf_counter() - t0
    _build.load()
    ptxas = [line.strip() for line in _build.build_log.splitlines()
             if "ptxas" in line]
    info = {"phase": "device", "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "build_s": build_s, "built_fresh": fresh,
            "library": str(lib_path.name), "ptxas": ptxas}
    emit(info)
    return info


def phase_hist_check() -> float:
    """Kernel == plain on every case; returns the largest |difference|."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    full = BATCH * SIZE[0] * SIZE[1]

    def ids(lo, hi, n, dtype=torch.int32):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int64).to(dtype)

    def with_void(labels):
        void = torch.rand(labels.shape, generator=gen, device=dev) < 0.05
        return torch.where(void, torch.full_like(labels, 255), labels)

    label_map = torch.from_numpy(
        SyntheticSegDataset(1, SIZE, CLASSES, seed=SEED)[0][1]).to(dev)
    coherent = label_map.expand(BATCH, *SIZE).contiguous()
    cases = {
        "full_invalid_labels": (with_void(ids(0, 25, full)),
                                ids(0, CLASSES, full), CLASSES),
        "ragged": (with_void(ids(0, 25, full - 12345)),
                   ids(0, CLASSES, full - 12345), CLASSES),
        "all_ignored": (torch.full((full,), 255, dtype=torch.int32,
                                   device=dev),
                        ids(0, CLASSES, full), CLASSES),
        "empty": (ids(0, CLASSES, 0), ids(0, CLASSES, 0), CLASSES),
        "n128_preds_out_of_range": (ids(-2, 140, 1_000_003),
                                    ids(-3, 135, 1_000_003), 128),
        "uint8_labels_int64_preds": (with_void(ids(0, 25, full, torch.uint8)),
                                     ids(0, CLASSES, full, torch.int64),
                                     CLASSES),
        "coherent_labels": (coherent, (coherent + 1) % CLASSES, CLASSES),
    }
    worst = 0
    report = {}
    for name, (labels, preds, n) in cases.items():
        got = fast_hist_cuda(labels, preds, n)
        torch.cuda.synchronize()
        want = fast_hist(labels, preds, n)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"hist kernel != plain on {name}: max "
                                 f"|diff| {err}")
        worst = max(worst, err)
        report[name] = {"pixels": labels.numel(), "classes": n,
                        "counted": int(want.sum())}
    emit({"phase": "hist_check", "exact": True, "cases": report})
    return float(worst)


def phase_serving(tree: dict, frames: np.ndarray) -> Predictor:
    predictor = Predictor(variables=tree, image_size=SIZE, batch_size=BATCH,
                          device="cuda").warmup()
    on_device = predictor._predict(frames[:BATCH])
    if not (on_device.is_cuda and on_device.dtype == torch.uint8
            and tuple(on_device.shape) == (BATCH, *SIZE)):
        raise AssertionError(f"device masks: {on_device.device} "
                             f"{on_device.dtype} {tuple(on_device.shape)}")
    masks = predictor.predict(frames)
    if masks.shape != (len(frames), *SIZE) or masks.dtype != np.int32:
        raise AssertionError(f"masks {masks.shape} {masks.dtype}")
    if masks.min() < 0 or masks.max() >= CLASSES:
        raise AssertionError(f"mask ids outside [0, {CLASSES})")

    batch = frames[:BATCH]
    p50 = cuda_ms(lambda: predictor.predict(batch), reps=20)
    # where a predict() call's time goes: staging, device work, fetch
    x = normalize(torch.from_numpy(batch).cuda()).permute(0, 3, 1, 2)
    x = x.to(torch.bfloat16)
    with torch.inference_mode():
        forward_ms = cuda_ms(lambda: predictor.model(x).argmax(dim=1))
    h2d_ms = cuda_ms(lambda: torch.from_numpy(batch).cuda())
    d2h_ms = cuda_ms(lambda: on_device.cpu())
    del x

    # the same weights in f32, with TF32 off in convs and matmuls
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        f32 = Predictor(variables=tree, image_size=SIZE, batch_size=BATCH,
                        dtype=torch.float32, device="cuda")
        masks32 = f32.predict(frames)
        # the CUDA f32 forward against the CPU one on a small input
        x = normalize(torch.from_numpy(frames[:1, :128, :256].copy()))
        x = x.permute(0, 3, 1, 2).contiguous()
        cpu_model = load_flax_variables(BiSeNet(output_f32=False), tree)
        with torch.inference_mode():
            want = cpu_model.eval()(x)
            got = f32.model(x.cuda()).cpu()
        cpu_err = float((got - want).abs().max())
        cpu_scale = float(want.abs().max())
        del f32
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags
    torch.cuda.empty_cache()
    agreement = float((masks == masks32).mean())
    emit({"phase": "serving", "model": "bisenet-resnet18",
          "image_size": list(SIZE), "batch": BATCH, "dtype": "bfloat16",
          "frames": len(frames), "p50_ms_per_batch": p50,
          "fps": BATCH * 1000.0 / p50, "forward_argmax_ms": forward_ms,
          "h2d_frames_ms": h2d_ms, "d2h_masks_ms": d2h_ms,
          "bf16_vs_f32_pixel_agreement": agreement,
          "f32_cuda_vs_cpu_max_abs_err": cpu_err,
          "f32_cpu_logit_max_abs": cpu_scale})
    if agreement < MIN_BF16_AGREEMENT:
        raise AssertionError(f"bf16 masks agree with f32 on {agreement:.4%} "
                             f"of pixels, below {MIN_BF16_AGREEMENT:.0%}")
    if not cpu_err <= 1e-3 * max(1.0, cpu_scale):
        raise AssertionError(f"f32 CUDA logits differ from the CPU's by "
                             f"{cpu_err}")
    return predictor


def phase_validation(predictor: Predictor):
    """Returns the last batch's (labels, preds) on the device."""
    ds = SyntheticSegDataset(VAL_BATCHES * BATCH, SIZE, CLASSES,
                             seed=SEED + 1, fixed_tints=True)
    batches = []
    for b in range(VAL_BATCHES):
        items = [ds[b * BATCH + i] for i in range(BATCH)]
        images = torch.from_numpy(np.stack([im for im, _ in items])).cuda()
        labels = torch.from_numpy(np.stack([lb for _, lb in items])).cuda()
        batches.append((normalize(images), labels))

    step = make_eval_step(predictor.model, CLASSES, return_preds=True)
    step_ms = []
    last = {}

    def checked_step(images, labels, hist):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        new_hist, preds = step(images, labels, hist)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        if not torch.equal(new_hist - hist, fast_hist(labels, preds,
                                                      CLASSES)):
            raise AssertionError("eval step histogram != plain fast_hist")
        last["labels"], last["preds"] = labels, preds
        return new_hist, preds

    miou, per_class = validate(predictor.model, iter(batches), CLASSES,
                               class_names=CLASS_NAMES,
                               eval_step=checked_step, device="cuda")
    if not 0.0 <= miou <= 1.0 or len(per_class) != CLASSES:
        raise AssertionError(f"mIoU {miou}, {len(per_class)} classes")
    emit({"phase": "validation", "batches": VAL_BATCHES, "batch": BATCH,
          "image_size": list(SIZE), "miou": miou,
          "eval_step_ms": statistics.median(step_ms),
          "eval_step_ms_all": step_ms})
    return last["labels"], last["preds"]


def kernel_timing(labels: torch.Tensor, preds: torch.Tensor,
                  launches: int, max_abs_err: float) -> dict:
    """The hist kernel's entry of the ``kernels`` line, timed on the eval
    step's own labels and int32 predictions."""
    n = CLASSES
    preds = preds.to(torch.int32)
    ms = cuda_ms(lambda: fast_hist_cuda(labels, preds, n), inner=10)
    plain_ms = cuda_ms(lambda: fast_hist(labels, preds, n), inner=10)
    l64, p64 = labels.reshape(-1).long(), preds.reshape(-1).long()
    idx = torch.where((l64 >= 0) & (l64 < n) & (p64 >= 0) & (p64 < n),
                      l64 * n + p64, n * n)
    library_ms = cuda_ms(lambda: torch.bincount(idx, minlength=n * n + 1),
                         inner=10)
    nbytes = labels.numel() * 4 + preds.numel() * 4 + n * n * 4
    return {"name": "fast_hist_cuda", "route": "cuda",
            "source": "rtsds_tpu_torch/ops/cuda/csrc/hist.cu",
            "replaces": "rtsds_tpu/ops/pallas/hist.py:48",
            "launches": launches, "max_abs_err": max_abs_err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": library_ms}


def main() -> int:
    device = phase_device()
    hist_err = phase_hist_check()

    ds = SyntheticSegDataset(SERVE_FRAMES + 2, SIZE, CLASSES, seed=SEED,
                             fixed_tints=True)
    frames = np.stack([ds[i][0] for i in range(SERVE_FRAMES)])
    calib = np.stack([ds[SERVE_FRAMES + i][0] for i in range(2)])
    tree = calibrate_batch_stats(random_flax_bisenet(SEED), calib, "cuda")

    fast_hist_cuda.launches = 0
    predictor = phase_serving(tree, frames)
    labels, preds = phase_validation(predictor)
    launches = fast_hist_cuda.launches
    if launches < 1:
        raise AssertionError("the main path never launched the hist kernel")

    kernels = [kernel_timing(labels, preds, launches, hist_err)]
    emit({"kernels": kernels})
    print(gpu_name_and_power_limit(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": device["name"],
                                 "count": device["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
