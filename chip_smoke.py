#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rtsds_tpu_torch``) on one GPU.

    python3 chip_smoke.py                 # from the repository root, one card
    python3 chip_smoke.py --kernels-only  # build and time K1 and K2 alone

Kernels are timed on the device alone with the L2 cold: each timed launch
follows a write of a 256 MB buffer, as K2 follows the transform's write of
the float32 image on the training path, and CUDA events bracket that
launch only, so the wrapper's host cost (timed on its own) drops out.

Phases, each printing one JSON line; any failure exits non-zero:

  1. device: the card, its power limit, and the build of the CUDA kernels
     from ``rtsds_tpu_torch/ops/cuda/csrc``;
  2. hist_check: the confusion-matrix kernel (K1) against its plain PyTorch
     version, exactly, on edge cases and at the eval batch's size;
  3. remap_check: the RGB -> trainId remap kernel (K2) against its plain
     version, exactly, at the training batch's size and on edge cases;
  4. serving: BiSeNet-R18 at 1024x2048, batch 8, bf16, from a Flax-layout
     weight tree made with numpy from a seed and loaded through the weight
     bridge; masks checked, timed, and held against an f32 run;
  5. validation: ``validate`` over synthetic batches at the same size, each
     step's histogram held against the plain version;
  6. training: the supervised trainer at full width (BiSeNet-R18, GTA5
     720x1280, batch 8, bf16, blur + flip) on colour-coded synthetic
     labels through the loader, ``make_transform`` (K2), ``make_train_step``
     and ``supervised_fit``, validated each epoch at 512x1024 (K1); every
     K2 output held against the plain remap, the checkpoint restored into
     a fresh model, one train step on the card held against the same step
     on the CPU (float64, and float32 with TF32 off), and the step timed;
  7. da_training: adversarial GTA5 -> Cityscapes domain adaptation at full
     width (BiSeNet-R18 generator, Tiny discriminator, source 720x1280 and
     target 512x1024, batch 8, bf16, Adam) through ``build_adversarial``,
     ``make_adversarial_step`` (v1), endless ``device_batches`` streams (K2
     in the source transform) and ``adversarial_fit``, validated each
     epoch at 512x1024 (K1); every loss finite, every K2 output held
     against the plain remap, the generator/discriminator checkpoint
     restored into fresh states, one step of each of v1, the
     gradient-reversal step and v2 on the card held against the same step
     on the CPU in float64, and the v1 and v2 steps timed
     (``rtsds_tpu_torch.bench.da_bench``) with v1's generator and
     discriminator phases apart and the peak device memory;
  8. train_profile: torch.profiler over a few train steps: the device's
     idle share and kernel time by group, and each hand-written kernel's
     device time per launch beside the timer's (run after the kernel
     timings, which the profiler's tracing could slow);
  9. the ``kernels`` line: each kernel's launches on the main paths (phases
     4-5, phase 6 and phase 7, each counted from zero), its device time
     (median, min, max), its wrapper's host cost, its plain version's
     time, a one-call library yardstick where one exists, and the card's
     bound.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from rtsds_tpu_torch.bench.da_bench import da_step_benchmark
from rtsds_tpu_torch.callbacks.base import Callback
from rtsds_tpu_torch.callbacks.checkpoint import ModelCheckpoint
from rtsds_tpu_torch.config import load_config
from rtsds_tpu_torch.data.pipeline import (
    DataLoader, batch_generator, device_batches)
from rtsds_tpu_torch.data.synthetic import (
    ColorCodedLabels, SyntheticSegDataset)
from rtsds_tpu_torch.eval.validate import make_eval_step, validate
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.pretrained import (
    load_flax_variables, torch_scope)
from rtsds_tpu_torch.ops import preprocess
from rtsds_tpu_torch.ops.augment import AugmentConfig
from rtsds_tpu_torch.ops.cuda import _build
from rtsds_tpu_torch.ops.cuda.hist import fast_hist_cuda
from rtsds_tpu_torch.ops.cuda.remap import rgb_to_train_ids_cuda
from rtsds_tpu_torch.ops.losses import segmentation_loss
from rtsds_tpu_torch.ops.preprocess import make_transform, normalize
from rtsds_tpu_torch.ops.remap import rgb_to_train_ids
from rtsds_tpu_torch.serve import Predictor
from rtsds_tpu_torch.train.adversarial import make_adversarial_step
from rtsds_tpu_torch.train.factory import (
    build_adversarial, build_supervised, make_bisenet, make_discriminator)
from rtsds_tpu_torch.train.loop import (
    DA_LOSS_KEYS, adversarial_fit, supervised_fit)
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.state import TrainState
from rtsds_tpu_torch.train.supervised import make_train_step
from rtsds_tpu_torch.utils.colors import CLASS_NAMES, class_colors_for_remap
from rtsds_tpu_torch.utils.metrics import fast_hist

SIZE = (1024, 2048)
BATCH = 8
CLASSES = 19
SEED = 0
SERVE_FRAMES = 16
VAL_BATCHES = 3
# the supervised trainer: GTA5 frames, validated on Cityscapes-sized ones
TRAIN_SIZE = (720, 1280)
TRAIN_BATCH = 8
TRAIN_STEPS = 4        # per epoch
TRAIN_EPOCHS = 2
TRAIN_VAL_SIZE = (512, 1024)
TRAIN_VAL_BATCHES = 2
UNMATCHED = 0.05       # share of label pixels whose colour is no class key
# domain adaptation: GTA5-sized source, Cityscapes-sized target, each batch
# 8; validated like the supervised trainer
DA_TGT_SIZE = (512, 1024)
DA_ITERATIONS = 4      # per epoch
DA_EPOCHS = 2
DA_BENCH_STEPS = 5     # per timed repeat
DA_BENCH_REPEATS = 3
# H100 SXM device-memory rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
# each kernel timing: this many launches, each after an L2 flush that
# writes FLUSH_BYTES, more than 5x the H100's 50 MB L2, and a device sleep
# of HOST_LEAD_CYCLES clock cycles that keeps the host's enqueue ahead of
# the device
TIMED_LAUNCHES = 100
FLUSH_BYTES = 256 << 20
HOST_LEAD_CYCLES = 200_000
KERNEL_TIMING = "device-only, L2 flushed"
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


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of one call of ``fn`` in ms, host enqueue included: CUDA
    events around each call, ``reps`` times, after ``warmup`` calls.  For
    the end-to-end metrics (a predict call, a train step)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def l2_flush():
    """A call that keeps the device busy with a sleep and then evicts the
    card's 50 MB L2 by writing a buffer of ``FLUSH_BYTES``.  The write
    leaves the L2 full of dirty lines, whose write-back to memory the next
    kernel pays beside its own bytes, as K2 does after the transform writes
    its float32 image.  The sleep before it lets the host enqueue the next
    call before the device is done."""
    buf = torch.ones(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")

    def flush():
        torch.cuda._sleep(HOST_LEAD_CYCLES)
        buf.fill_(1)
    return flush


def device_ms(fn, reps: int = TIMED_LAUNCHES, warmup: int = 3) -> dict:
    """Device time of one call of ``fn`` with the L2 cold, in ms: before
    each timed call the card flushes its L2 (:func:`l2_flush`), and CUDA
    events bracket that one call.  The flush keeps the device busy while
    the host enqueues the call, so the host's own cost per call
    (:func:`host_us`) drops out.  Median, min and max over ``reps``
    calls."""
    flush = l2_flush()
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    for start, end in events:
        flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return {"ms": statistics.median(times), "ms_min": times[0],
            "ms_max": times[-1]}


def host_us(fn, calls: int = 200) -> float:
    """Host time of one call of ``fn`` in microseconds (``time.perf_counter``
    over ``calls`` calls) while the device runs a long sleep enqueued
    before them, so that no call waits for the device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's ~2 GHz
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


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


def gta5_label_batch(gen: torch.Generator, shape: tuple,
                     unmatched: float = UNMATCHED) -> torch.Tensor:
    """(..., 3) uint8 GTA5 key colours on the card, ``unmatched`` of them
    replaced by random colours."""
    dev = torch.device("cuda")
    table = torch.from_numpy(class_colors_for_remap()).to(dev)
    ids = torch.randint(0, len(table), shape, generator=gen, device=dev)
    rgb = table[ids]
    noise = torch.randint(0, 256, (*shape, 3), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.uint8)
    off = torch.rand(shape, generator=gen, device=dev) < unmatched
    return torch.where(off[..., None], noise, rgb)


def phase_remap_check() -> float:
    """Kernel == plain on every case; returns the largest |difference|."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    batch = gta5_label_batch(gen, (TRAIN_BATCH, *TRAIN_SIZE))
    # 128 random keys with row 77 repeating row 5: the first one must win
    keys128 = torch.randint(0, 256, (128, 3), generator=gen, device=dev,
                            dtype=torch.int64).to(torch.uint8)
    keys128[77] = keys128[5]
    pick = torch.randint(0, 128, (1_000_003,), generator=gen, device=dev)
    dup = torch.where((torch.rand(pick.shape, generator=gen, device=dev)
                       < 0.1)[:, None],
                      torch.randint(0, 256, (len(pick), 3), generator=gen,
                                    device=dev).to(torch.uint8),
                      keys128[pick])
    flat = batch.reshape(-1, 3)
    # rows a uint8 pixel never matches ((0, 0, 256) packs like the valid
    # (0, 1, 0) further down), black and white as keys, 33 keys
    rng = np.random.default_rng(SEED)
    odd_rows = rng.integers(0, 256, (12, 3))
    odd_rows[[0, 3, 7, 8]] = [[256, 0, 0], [-1, 5, 5], [0, 0, 256], [0, 1, 0]]
    black_white = rng.integers(0, 256, (10, 3)).astype(np.uint8)
    black_white[4], black_white[6] = (0, 0, 0), (255, 255, 255)
    keys33 = rng.integers(0, 256, (33, 3)).astype(np.uint8)

    def edge_pixels(table) -> torch.Tensor:
        """Each valid key, each moved by +-1 on one channel, black, white
        and random colours, on the card."""
        keys = np.asarray(table, np.int64)
        keys = keys[((keys >= 0) & (keys <= 255)).all(axis=1)]
        near = [keys] + [(keys + step * np.eye(3, dtype=np.int64)[c]) % 256
                         for c in range(3) for step in (-1, 1)]
        px = np.concatenate([*near, [[0, 0, 0], [255, 255, 255]],
                             rng.integers(0, 256, (3 * 4096, 3))])
        return torch.from_numpy(rng.permutation(px).astype(np.uint8)).to(dev)

    gta5 = class_colors_for_remap()
    n4 = flat.shape[0] - 2  # from byte 4 on: 4- but not 16-byte aligned
    aligned4 = flat.reshape(-1)[4:4 + 3 * n4].view(n4, 3)
    cases = {
        "train_batch": (batch, None, 255),
        "ragged": (flat[:flat.shape[0] - 5], None, 255),
        "empty": (flat[:0], None, 255),
        "keys128_duplicate": (dup, keys128.cpu().numpy(), 255),
        "default_id_0": (batch, None, 0),
        "default_id_negative": (batch, None, -1),
        "non_contiguous": (batch[:, 100:600:2, 7:1000:3], None, 255),
        "misaligned": (flat[1:1_000_002], None, 255),
        "aligned_4_not_16": (aligned4, None, 255),
        "gta5_edge_colours": (edge_pixels(gta5), None, 7),
        "rows_never_matched": (edge_pixels(odd_rows), odd_rows, 255),
        "black_white_keys": (edge_pixels(black_white), black_white, 0),
        "keys33": (edge_pixels(keys33), keys33, 255),
        **{f"pixels_{n}": (flat[:n], None, 255)
           for n in (1, 15, 16, 17, 4095, 4096, 4097)},
    }
    report = {}
    for name, (rgb, table, default_id) in cases.items():
        before = rgb_to_train_ids_cuda.launches
        got = rgb_to_train_ids_cuda(rgb, table, default_id)
        torch.cuda.synchronize()
        want = rgb_to_train_ids(rgb, table, default_id)
        if got.dtype != torch.int32 or got.shape != want.shape:
            raise AssertionError(f"remap kernel on {name}: {got.dtype} "
                                 f"{tuple(got.shape)}")
        if not torch.equal(got, want):
            err = int((got.long() - want.long()).abs().max())
            raise AssertionError(f"remap kernel != plain on {name}: max "
                                 f"|diff| {err}")
        launched = rgb_to_train_ids_cuda.launches - before
        if launched != (1 if rgb.numel() else 0):
            raise AssertionError(f"remap on {name} launched {launched}x")
        report[name] = {"pixels": got.numel(), "keys": 19 if table is None
                        else len(table), "default_id": default_id,
                        "unmatched": int((want == default_id).sum())}
    # imported here: ``--kernels-only`` also runs in trees without it
    from rtsds_tpu_torch.ops.cuda.remap import remap_table
    hashed = {name: remap_table(table)
              for name, table in (("gta5", None), ("keys128", keys128.cpu()
                                                   .numpy()),
                                  ("keys33", keys33))}
    report["hash_tables"] = {name: {"slots": len(t.slots),
                                    "probes": t.probes}
                             for name, t in hashed.items()}
    if (hashed["gta5"].probes, len(hashed["gta5"].slots)) != (1, 32):
        raise AssertionError(f"the GTA5 table hashed into {hashed['gta5']}")
    emit({"phase": "remap_check", "exact": True, "cases": report})
    return 0.0


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


class _LossRecorder(Callback):
    def __init__(self):
        self.losses = []

    def on_batch_end(self, batch, logs=None):
        self.losses.append(logs["train_loss"])


def _checked_remap(counter: dict):
    """K2 as ``make_transform`` calls it, each output held against the
    plain remap of the same labels (the plain call launches no kernel)."""
    def remap(rgb, color_table=None, default_id=255):
        got = rgb_to_train_ids_cuda(rgb, color_table, default_id)
        if not torch.equal(got, rgb_to_train_ids(rgb, color_table,
                                                 default_id)):
            raise AssertionError("K2 output in the trainer != plain remap")
        counter["checked"] += 1
        return got
    return remap


def train_config():
    """The default config (Adam, poly LR, blur + flip) in bf16, for
    ``TRAIN_EPOCHS`` epochs."""
    return load_config(overrides={
        "precision": {"compute_dtype": "bfloat16"},
        "training": {"segmentation": {"epochs": TRAIN_EPOCHS,
                                      "do_validation": 1}}})


@contextlib.contextmanager
def relu_routing(masks: list, replay: bool = False):
    """``F.relu`` records, in call order, which inputs it passes; with
    ``replay`` it passes the inputs that ``masks`` recorded instead, so the
    step takes another run's ReLU routing.  Yields a dict whose ``flips``
    counts the inputs whose own sign disagreed with the replayed mask."""
    relu = F.relu
    recorded = iter(list(masks)) if replay else None
    seen = {"flips": 0}

    def routed(x, inplace=False):
        if recorded is None:
            masks.append((x.detach() > 0).cpu())
            return relu(x, inplace)
        mask = next(recorded).to(x.device)
        seen["flips"] += int(((x.detach() > 0) != mask).sum())
        return x * mask.to(x.dtype)

    F.relu = routed
    try:
        yield seen
    finally:
        F.relu = relu


def step_card_vs_cpu(dtype: torch.dtype, batch: int) -> dict:
    """One SGD step of BiSeNet-R18 at 64x128 on the card and on the CPU,
    same weights and batch, in ``dtype``, TF32 off; fails unless they
    agree.  The CPU step takes the card's ReLU routing: an input within
    rounding of zero may round to either side, and one such flip moves
    some tensors' updates by tens of times the limit (PERF.md).  Returns
    the loss's relative difference, the largest difference of the BN
    running statistics over ``1e-5 + 1e-4 * |cpu|``, per parameter tensor
    the largest difference of the two updates over ``1e-3 * largest update
    + 1e-6``, and the count of ReLU inputs whose sign on the CPU differed
    from the card's."""
    ds = SyntheticSegDataset(batch, (64, 128), CLASSES, seed=SEED + 3,
                             fixed_tints=True)
    images = normalize(torch.from_numpy(np.stack([ds[i][0]
                                                  for i in range(batch)])))
    images = images.to(dtype)
    labels = torch.from_numpy(np.stack([ds[i][1] for i in range(batch)]))
    labels[:, :3] = 19  # a band of ignored pixels
    cfg = load_config().model["bisenet"]
    states = {}
    for dev in ("cpu", "cuda"):
        model = make_bisenet(cfg, seed=SEED).to(dev, dtype)
        opt = make_optimizer("SGD", model.parameters(), 0.01, momentum=0.9)
        states[dev] = TrainState(model, opt)
    before = {k: v.detach().clone() for k, v in
              states["cpu"].model.named_parameters()}
    step = make_train_step(19)
    losses, masks = {}, []
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for dev in ("cuda", "cpu"):
                with relu_routing(masks, replay=dev == "cpu") as seen:
                    losses[dev] = float(step(states[dev], images.to(dev),
                                             labels.to(dev))["train_loss"])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    cpu_state = states["cpu"].model.state_dict()
    stats_err = max(float(((v.cpu() - cpu_state[k]).abs()
                           / (1e-5 + 1e-4 * cpu_state[k].abs())).max())
                    for k, v in states["cuda"].model.state_dict().items()
                    if "running_" in k)
    ratios = {}
    gpu_params = dict(states["cuda"].model.named_parameters())
    for k, p in states["cpu"].model.named_parameters():
        want = p.detach() - before[k]
        got = gpu_params[k].detach().cpu() - before[k]
        limit = 1e-3 * float(want.abs().max()) + 1e-6
        ratios[k] = float((got - want).abs().max()) / limit
    worst = sorted(ratios, key=ratios.get, reverse=True)
    result = {"dtype": str(dtype).replace("torch.", ""), "batch": batch,
              "loss_cpu": losses["cpu"], "loss_cuda": losses["cuda"],
              "loss_rel_diff": abs(losses["cuda"] - losses["cpu"])
              / abs(losses["cpu"]),
              "bn_stats_err_over_limit": stats_err,
              "tensors_over_limit": sum(r > 1.0 for r in ratios.values()),
              "worst_update_err_over_limit": {k: ratios[k]
                                              for k in worst[:3]},
              "relu_sign_flips": seen["flips"]}
    if (result["loss_rel_diff"] > 1e-4 or stats_err > 1.0
            or result["tensors_over_limit"]):
        raise AssertionError(f"the train step on the card differs from the "
                             f"CPU's: {result}")
    return result


def train_step_split(state, images, labels, reps: int = 10) -> dict:
    """Median ms of the parts of one train step, with CUDA events between
    them: forward + loss (autocast), backward, optimizer update."""
    model = state.model.train()
    marks = {"forward_loss": [], "backward": [], "optimizer": []}
    for i in range(reps + 2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        with state.autocast():
            outputs = model(images.permute(0, 3, 1, 2))
            loss = segmentation_loss(outputs, labels, 19)
        ev[1].record()
        state.optimizer.zero_grad()
        loss.backward()
        ev[2].record()
        state.optimizer.step()
        ev[3].record()
        ev[3].synchronize()
        if i >= 2:
            for j, key in enumerate(marks):
                marks[key].append(ev[j].elapsed_time(ev[j + 1]))
    return {k: statistics.median(v) for k, v in marks.items()}


KERNEL_GROUPS = (  # first match wins; names lower-cased
    ("conv/gemm", ("conv", "cudnn", "xmma", "gemm", "sm90", "implicit",
                   "wgrad", "dgrad", "fprop")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_")),
    ("resize", ("upsample", "interp")),
    ("pool", ("pool",)),
    ("loss", ("nll", "softmax", "cross_entropy")),
    ("optimizer", ("adam", "multi_tensor", "foreach")),
    ("copy", ("memcpy", "memset", "copy")),
)


def profile_steps(run, steps: int = 5) -> dict:
    """torch.profiler over ``steps`` calls of ``run`` (one train step each,
    after one untraced call): device busy time (the union of kernel
    intervals), the idle share of the host-clock window, device time by
    kernel group and the top kernels.  User annotations on the device's
    timeline (``Optimizer.step#Adam.step`` spans the optimizer's kernels)
    are no kernels and are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    notes = {e.name for e in device if getattr(e, "is_user_annotation", False)}
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in device
                   if not getattr(e, "is_user_annotation", False))
    if not spans:
        return {"device_time": "not measured (no device events)",
                "wall_ms_per_step": wall_ms / steps}
    busy, end = 0.0, -math.inf
    for a, b, _ in spans:  # union of the intervals, in us
        if b > end:
            busy += b - max(a, end)
            end = b
    by_group: dict = {}
    by_kernel: dict = {}
    for a, b, name in spans:
        low = name.lower()
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in low for k in keys)), "elementwise/other")
        by_group[group] = by_group.get(group, 0.0) + (b - a) / 1e3
        by_kernel[name] = by_kernel.get(name, 0.0) + (b - a) / 1e3
    total = sum(by_group.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "annotations_left_out": sorted(notes),
            "device_busy_ms_per_step": busy / 1e3 / steps,
            "device_idle_share": 1.0 - busy / 1e3 / wall_ms,
            "kernel_ms_per_step": total / steps,
            "share_by_group": {g: v / total for g, v in
                               sorted(by_group.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms_per_step": [[n[:80], v / steps] for n, v in top]}


def phase_training() -> dict:
    """Trains through the port's entry points; returns the K2 timing batch
    and the main-path launch counts of this phase."""
    dev = torch.device("cuda")
    tmp = tempfile.TemporaryDirectory(prefix="rtsds_smoke_")
    config = train_config()
    gta5 = ColorCodedLabels(
        SyntheticSegDataset(TRAIN_STEPS * TRAIN_BATCH, TRAIN_SIZE, CLASSES,
                            seed=SEED + 4, fixed_tints=True),
        class_colors_for_remap(), unmatched=UNMATCHED, seed=SEED)
    val = SyntheticSegDataset(TRAIN_VAL_BATCHES * TRAIN_BATCH, TRAIN_VAL_SIZE,
                              CLASSES, seed=SEED + 5, fixed_tints=True)
    loader = DataLoader(gta5, TRAIN_BATCH, shuffle=True, num_workers=4,
                        seed=SEED)
    val_loader = DataLoader(val, TRAIN_BATCH, shuffle=False, num_workers=4,
                            drop_last=False)
    transform = make_transform(TRAIN_SIZE, CLASSES, antialias=False,
                               augment_cfg=AugmentConfig.from_config(config),
                               decode_label_colors=True)
    val_transform = make_transform(TRAIN_VAL_SIZE, CLASSES, antialias=True)
    state = build_supervised(config, "bisenet", len(loader), dev, seed=SEED)
    recorder = _LossRecorder()
    checkpoint = ModelCheckpoint(save_dir=tmp.name, save_name="smoke",
                                 save_best=False)
    checked = {"checked": 0}
    plain_remap = preprocess.rgb_to_train_ids_cuda

    fast_hist_cuda.launches = 0
    rgb_to_train_ids_cuda.launches = 0
    preprocess.rgb_to_train_ids_cuda = _checked_remap(checked)
    t0 = time.perf_counter()
    try:
        _, history = supervised_fit(
            state, make_train_step(19),
            lambda epoch: device_batches(loader, transform, dev, seed=SEED,
                                         epoch=epoch),
            lambda epoch: device_batches(val_loader, val_transform, dev),
            epochs=TRAIN_EPOCHS, num_classes=CLASSES,
            class_names=CLASS_NAMES, callbacks=[recorder],
            checkpoint=checkpoint, device=dev)
        torch.cuda.synchronize()
    finally:
        preprocess.rgb_to_train_ids_cuda = plain_remap
    fit_s = time.perf_counter() - t0
    launches = {"fast_hist_cuda": fast_hist_cuda.launches,
                "rgb_to_train_ids_cuda": rgb_to_train_ids_cuda.launches}

    if len(recorder.losses) != TRAIN_EPOCHS * TRAIN_STEPS or not all(
            math.isfinite(x) for x in recorder.losses):
        raise AssertionError(f"train losses {recorder.losses}")
    if checked["checked"] != TRAIN_EPOCHS * TRAIN_STEPS:
        raise AssertionError(f"{checked['checked']} K2 calls checked")
    if len(history) != TRAIN_EPOCHS or not all(
            0.0 <= h["validation_mIoU"] <= 1.0 for h in history):
        raise AssertionError(f"history {history}")

    # one batch of the path, kept for the timings below
    host_images, host_rgb = next(iter(loader))
    images_dev = torch.from_numpy(host_images).to(dev)
    rgb_dev = torch.from_numpy(host_rgb).to(dev)
    images, labels = transform(images_dev, rgb_dev,
                               batch_generator(SEED, 0, 0))
    val_images, val_labels = next(iter(device_batches(
        val_loader, val_transform, dev)))

    # the saved checkpoint restored into a freshly initialised model
    fresh = build_supervised(config, "bisenet", len(loader), dev,
                             seed=SEED + 9)
    if not checkpoint.manager.restore({"model": fresh}):
        raise AssertionError("checkpoint restore failed")
    if fresh.step != state.step:
        raise AssertionError(f"restored step {fresh.step} != {state.step}")
    with torch.inference_mode(), state.autocast():
        want = state.model.eval()(val_images.permute(0, 3, 1, 2))
        got = fresh.model.eval()(val_images.permute(0, 3, 1, 2))
    restore_err = float((got - want).abs().max())
    if restore_err > 1e-5 * max(1.0, float(want.abs().max())):
        raise AssertionError(f"restored model's logits differ by "
                             f"{restore_err}")
    del want, got, fresh

    # float32 at four frames: at two, with the routing fixed, rounding
    # alone still moves a few tensors' updates past the limit (PERF.md)
    step_checks = [step_card_vs_cpu(torch.float64, 2),
                   step_card_vs_cpu(torch.float32, 4)]

    step = make_train_step(19)
    step_ms = cuda_ms(lambda: step(state, images, labels), reps=10)
    split = train_step_split(state, images, labels)
    h2d_frames_ms = cuda_ms(lambda: torch.from_numpy(host_images).to(dev))
    h2d_labels_ms = cuda_ms(lambda: torch.from_numpy(host_rgb).to(dev))
    gen = torch.Generator().manual_seed(SEED)
    transform_ms = cuda_ms(lambda: transform(images_dev, rgb_dev, gen))
    eval_step = make_eval_step(state.model.eval(), CLASSES,
                               compute_dtype=state.compute_dtype)
    hist = torch.zeros((CLASSES, CLASSES), dtype=torch.int32, device=dev)
    eval_ms = cuda_ms(lambda: eval_step(val_images, val_labels, hist))
    tmp.cleanup()
    emit({"phase": "training", "model": "bisenet-resnet18",
          "image_size": list(TRAIN_SIZE), "batch": TRAIN_BATCH,
          "dtype": "bfloat16", "epochs": TRAIN_EPOCHS,
          "steps_per_epoch": TRAIN_STEPS, "losses": recorder.losses,
          "history": history, "fit_s": fit_s,
          "k2_outputs_checked": checked["checked"],
          "launches": launches, "restore_max_abs_err": restore_err,
          "step_card_vs_cpu": step_checks, "train_step_p50_ms": step_ms,
          "samples_per_s": TRAIN_BATCH * 1000.0 / step_ms,
          "train_step_split_ms": split,
          "h2d_frames_ms": h2d_frames_ms, "h2d_rgb_labels_ms": h2d_labels_ms,
          "transform_ms": transform_ms, "eval_image_size":
          list(TRAIN_VAL_SIZE), "eval_step_ms": eval_ms,
          "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    return {"rgb": rgb_dev, "launches": launches, "state": state,
            "batch": (images, labels)}


class _DALossRecorder(Callback):
    def __init__(self):
        self.losses = []

    def on_batch_end(self, batch, logs=None):
        self.losses.append(dict(logs))


def da_step_card_vs_cpu(variant: str, grl_alpha: float = 0.0) -> dict:
    """One float64 SGD step of the adversarial trainer (BiSeNet-R18 and the
    Tiny discriminator, b2, source 64x96, target 64x128) on the card and
    on the CPU, same weights and batches; fails unless every loss agrees
    to 1e-4 relative, G's BN running statistics to rtol 1e-4 / atol 1e-5,
    and each parameter tensor's update, of G and of D, to 1e-3 of its
    largest update + 1e-6.  Returns the worst of each, over its limit."""
    def batch(size, seed):
        ds = SyntheticSegDataset(2, size, CLASSES, seed=seed,
                                 fixed_tints=True)
        images = normalize(torch.from_numpy(np.stack([ds[i][0]
                                                      for i in range(2)])))
        labels = torch.from_numpy(np.stack([ds[i][1] for i in range(2)]))
        return images.double(), labels

    src, labels = batch((64, 96), SEED + 8)
    labels[:, :3] = 19  # a band of ignored pixels
    tgt, _ = batch((64, 128), SEED + 9)
    config = load_config()
    states = {}
    for dev in ("cpu", "cuda"):
        gen = make_bisenet(config.model["bisenet"], seed=SEED).to(
            dev, torch.float64)
        dis = make_discriminator(
            config.model["adversarial_model"]["discriminator"],
            seed=SEED + 1).to(dev, torch.float64)
        states[dev] = (
            TrainState(gen, make_optimizer("SGD", gen.parameters(), 0.01,
                                           momentum=0.0)),
            TrainState(dis, make_optimizer("SGD", dis.parameters(), 0.02,
                                           momentum=0.0)))
    before = [{k: v.detach().clone() for k, v in s.model.named_parameters()}
              for s in states["cpu"]]
    step = make_adversarial_step(0.1, DA_ITERATIONS, DA_EPOCHS, 19, variant,
                                 grl_alpha=grl_alpha)
    metrics = {dev: step(*states[dev], src.to(dev), labels.to(dev),
                         tgt.to(dev)) for dev in ("cuda", "cpu")}
    loss_err = max(abs(float(metrics["cuda"][k]) - float(v)) / abs(float(v))
                   for k, v in metrics["cpu"].items()
                   if k.startswith("loss_"))
    cpu_state = states["cpu"][0].model.state_dict()
    stats_err = max(float(((v.cpu() - cpu_state[k]).abs()
                           / (1e-5 + 1e-4 * cpu_state[k].abs())).max())
                    for k, v in states["cuda"][0].model.state_dict().items()
                    if "running_" in k)
    ratios = {}
    for net, cpu_s, gpu_s, start in zip("GD", states["cpu"], states["cuda"],
                                        before):
        gpu_params = dict(gpu_s.model.named_parameters())
        for k, p in cpu_s.model.named_parameters():
            want = p.detach() - start[k]
            got = gpu_params[k].detach().cpu() - start[k]
            limit = 1e-3 * float(want.abs().max()) + 1e-6
            ratios[f"{net}:{k}"] = float((got - want).abs().max()) / limit
    worst = sorted(ratios, key=ratios.get, reverse=True)
    result = {"variant": variant, "grl_alpha": grl_alpha,
              "loss_gen_source_cpu": float(metrics["cpu"]["loss_gen_source"]),
              "loss_rel_diff": loss_err, "bn_stats_err_over_limit": stats_err,
              "tensors_over_limit": sum(r > 1.0 for r in ratios.values()),
              "worst_update_err_over_limit": {k: ratios[k]
                                              for k in worst[:2]}}
    if loss_err > 1e-4 or stats_err > 1.0 or result["tensors_over_limit"]:
        raise AssertionError(f"the DA step on the card differs from the "
                             f"CPU's: {result}")
    return result


def da_config():
    """The default config (Tiny discriminator, Adam, v1, blur + flip) in
    bf16, for ``DA_EPOCHS`` epochs of ``DA_ITERATIONS`` steps."""
    return load_config(overrides={
        "precision": {"compute_dtype": "bfloat16"},
        "training": {"domain_adaptation": {"epochs": DA_EPOCHS,
                                           "iterations": DA_ITERATIONS,
                                           "do_validation": 1}}})


def phase_da_training() -> dict:
    """Domain adaptation through the port's entry points; returns the
    main-path launch counts of this phase."""
    dev = torch.device("cuda")
    tmp = tempfile.TemporaryDirectory(prefix="rtsds_smoke_da_")
    config = da_config()
    tcfg = config.training["domain_adaptation"]
    n = DA_ITERATIONS * TRAIN_BATCH
    source = ColorCodedLabels(
        SyntheticSegDataset(n, TRAIN_SIZE, CLASSES, seed=SEED + 6,
                            fixed_tints=True),
        class_colors_for_remap(), unmatched=UNMATCHED, seed=SEED)
    target = SyntheticSegDataset(n, DA_TGT_SIZE, CLASSES, seed=SEED + 7,
                                 fixed_tints=True)
    val = SyntheticSegDataset(TRAIN_VAL_BATCHES * TRAIN_BATCH, TRAIN_VAL_SIZE,
                              CLASSES, seed=SEED + 5, fixed_tints=True)
    src_loader = DataLoader(source, TRAIN_BATCH, num_workers=4, seed=SEED,
                            infinite=True)
    tgt_loader = DataLoader(target, TRAIN_BATCH, num_workers=4,
                            seed=SEED + 1, infinite=True)
    val_loader = DataLoader(val, TRAIN_BATCH, shuffle=False, num_workers=4,
                            drop_last=False)
    src_transform = make_transform(
        TRAIN_SIZE, CLASSES, antialias=False,
        augment_cfg=AugmentConfig.from_config(config),
        decode_label_colors=True)
    tgt_transform = make_transform(DA_TGT_SIZE, CLASSES, antialias=True)
    val_transform = make_transform(TRAIN_VAL_SIZE, CLASSES, antialias=True)
    gen, dis = build_adversarial(config, dev, seed=SEED)
    step = make_adversarial_step(float(tcfg["lambda"]), DA_ITERATIONS,
                                 DA_EPOCHS, 19, "v1")
    recorder = _DALossRecorder()
    checkpoint = ModelCheckpoint(save_dir=tmp.name, save_name="smoke_da",
                                 save_best=False)
    checked = {"checked": 0}
    plain_remap = preprocess.rgb_to_train_ids_cuda
    source_iter = device_batches(src_loader, src_transform, dev, seed=SEED)
    target_iter = device_batches(tgt_loader, tgt_transform, dev)

    with contextlib.closing(source_iter), contextlib.closing(target_iter):
        fast_hist_cuda.launches = 0
        rgb_to_train_ids_cuda.launches = 0
        preprocess.rgb_to_train_ids_cuda = _checked_remap(checked)
        t0 = time.perf_counter()
        try:
            _, _, history = adversarial_fit(
                gen, dis, step, source_iter, target_iter,
                lambda epoch: device_batches(val_loader, val_transform, dev),
                iterations=DA_ITERATIONS, epochs=DA_EPOCHS,
                num_classes=CLASSES, class_names=CLASS_NAMES,
                callbacks=[recorder], checkpoint=checkpoint, device=dev)
            torch.cuda.synchronize()
        finally:
            preprocess.rgb_to_train_ids_cuda = plain_remap
        fit_s = time.perf_counter() - t0
        launches = {"fast_hist_cuda": fast_hist_cuda.launches,
                    "rgb_to_train_ids_cuda": rgb_to_train_ids_cuda.launches}
        # the next batch of each stream, kept for the profile
        batch = (*next(source_iter), next(target_iter)[0])

    steps = DA_EPOCHS * DA_ITERATIONS
    if len(recorder.losses) != steps or not all(
            sorted(logs) == sorted(DA_LOSS_KEYS[:4])
            and all(math.isfinite(v) for v in logs.values())
            for logs in recorder.losses):
        raise AssertionError(f"DA losses {recorder.losses}")
    if checked["checked"] != steps:
        raise AssertionError(f"{checked['checked']} K2 calls checked")
    if len(history) != DA_EPOCHS or not all(
            0.0 <= h["validation_mIoU"] <= 1.0 for h in history):
        raise AssertionError(f"history {history}")

    # the saved checkpoint restored into freshly initialised states
    val_images, _ = next(iter(device_batches(val_loader, val_transform,
                                             dev)))
    fresh_gen, fresh_dis = build_adversarial(config, dev, seed=SEED + 9)
    if not checkpoint.manager.restore({"generator": fresh_gen,
                                       "discriminator": fresh_dis}):
        raise AssertionError("DA checkpoint restore failed")
    if (fresh_gen.step, fresh_dis.step) != (gen.step, dis.step):
        raise AssertionError(f"restored steps {fresh_gen.step}, "
                             f"{fresh_dis.step} != {gen.step}, {dis.step}")
    with torch.inference_mode(), gen.autocast():
        x = val_images.permute(0, 3, 1, 2)
        want, got = gen.model.eval()(x), fresh_gen.model.eval()(x)
        feat = torch.softmax(want, dim=1)
        d_want, d_got = dis.model(feat), fresh_dis.model(feat)
    restore_err = {
        "generator_logits": float((got - want).abs().max()),
        "discriminator_outputs": float((d_got - d_want).abs().max())}
    if (restore_err["generator_logits"]
            > 1e-5 * max(1.0, float(want.abs().max()))
            or restore_err["discriminator_outputs"]
            > 1e-5 * max(1.0, float(d_want.abs().max()))):
        raise AssertionError(f"restored states differ: {restore_err}")
    del fresh_gen, fresh_dis, want, got, feat, x
    tmp.cleanup()
    torch.cuda.empty_cache()

    step_checks = [da_step_card_vs_cpu("v1"),
                   da_step_card_vs_cpu("v1", grl_alpha=0.1),
                   da_step_card_vs_cpu("v2")]
    torch.cuda.empty_cache()
    bench = {}
    for variant in ("v1", "v2"):
        bench[variant] = da_step_benchmark(
            batch_size=TRAIN_BATCH, src_hw=TRAIN_SIZE, tgt_hw=DA_TGT_SIZE,
            steps=DA_BENCH_STEPS, repeats=DA_BENCH_REPEATS,
            dtype=torch.bfloat16, variant=variant, seed=SEED)
        torch.cuda.empty_cache()
    emit({"phase": "da_training", "generator": "bisenet-resnet18",
          "discriminator": "tiny", "source_size": list(TRAIN_SIZE),
          "target_size": list(DA_TGT_SIZE), "batch": TRAIN_BATCH,
          "dtype": "bfloat16", "variant": "v1", "epochs": DA_EPOCHS,
          "iterations": DA_ITERATIONS, "losses": recorder.losses,
          "history": history, "fit_s": fit_s,
          "k2_outputs_checked": checked["checked"], "launches": launches,
          "restore_max_abs_err": restore_err,
          "step_card_vs_cpu_float64": step_checks,
          "v1_ms_per_step": bench["v1"]["ms_per_step"],
          "v1_steps_per_sec": bench["v1"]["steps_per_sec"],
          "v1_split_ms": bench["v1"]["split_ms"],
          "v2_ms_per_step": bench["v2"]["ms_per_step"],
          "v2_steps_per_sec": bench["v2"]["steps_per_sec"],
          "bench": bench})
    for variant, b in bench.items():
        if not math.isfinite(b["last_loss_gen_source"]):
            raise AssertionError(f"DA bench {variant}: loss "
                                 f"{b['last_loss_gen_source']}")
    return {"launches": launches,
            "profile_run": lambda: step(gen, dis, *batch)}


def timed_entry(kernel, plain, library, nbytes: int) -> dict:
    """The measured keys of a ``kernels`` entry: the kernel's device time
    (median, min, max), its wrapper's host cost, the plain version's and
    the library call's (if any) device time, and the bytes bound; each of
    ``kernel``, ``plain`` and ``library`` is a call of no arguments."""
    timed = device_ms(kernel)
    return {"ms": timed["ms"], "ms_min": timed["ms_min"],
            "ms_max": timed["ms_max"], "timing": KERNEL_TIMING,
            "host_us": host_us(kernel), "plain_ms": device_ms(plain)["ms"],
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": device_ms(library)["ms"] if library else None}


def remap_timing(rgb: torch.Tensor, launches: int,
                 max_abs_err: float) -> dict:
    """The remap kernel's entry of the ``kernels`` line, timed on one
    training batch's colour-coded labels.  No single PyTorch call computes
    a first-match colour-key lookup, so ``library_ms`` is null."""
    pixels = rgb.numel() // 3
    nbytes = pixels * 3 + pixels * 4  # uint8 RGB in, int32 ids out
    return {"name": "rgb_to_train_ids_cuda", "route": "cuda",
            "source": "rtsds_tpu_torch/ops/cuda/csrc/remap.cu",
            "replaces": "rtsds_tpu/ops/pallas/remap.py:42",
            "launches": launches, "max_abs_err": max_abs_err,
            **timed_entry(lambda: rgb_to_train_ids_cuda(rgb),
                          lambda: rgb_to_train_ids(rgb), None, nbytes)}


def kernel_timing(labels: torch.Tensor, preds: torch.Tensor,
                  launches: int, max_abs_err: float) -> dict:
    """The hist kernel's entry of the ``kernels`` line, timed on the eval
    step's own labels and int32 predictions.  The library yardstick is
    ``torch.bincount`` of the joint ids, which syncs with the host to size
    its output."""
    n = CLASSES
    l64, p64 = labels.reshape(-1).long(), preds.reshape(-1).long()
    idx = torch.where((l64 >= 0) & (l64 < n) & (p64 >= 0) & (p64 < n),
                      l64 * n + p64, n * n)
    nbytes = labels.numel() * 4 + preds.numel() * 4 + n * n * 4
    return {"name": "fast_hist_cuda", "route": "cuda",
            "source": "rtsds_tpu_torch/ops/cuda/csrc/hist.cu",
            "replaces": "rtsds_tpu/ops/pallas/hist.py:48",
            "launches": launches, "max_abs_err": max_abs_err,
            **timed_entry(lambda: fast_hist_cuda(labels, preds, n),
                          lambda: fast_hist(labels, preds, n),
                          lambda: torch.bincount(idx, minlength=n * n + 1),
                          nbytes)}


def profile_kernels(calls: dict, launches: int = 20) -> dict:
    """torch.profiler's device time per launch of each hand-written kernel,
    each launch after the same L2 flush as :func:`device_ms`: a cross-check
    of that timer.  ``calls`` maps a kernel's name in the trace to a call
    that launches it once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = l2_flush()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            for _ in range(launches):
                flush()
                fn()
        torch.cuda.synchronize()
    out = {}
    for name in calls:
        spans = [(e.time_range.end - e.time_range.start) / 1e3
                 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and name in e.name]
        out[name] = {"launches_seen": len(spans),
                     "median_ms": statistics.median(spans) if spans
                     else "not measured (no device events)"}
    return out


def kernels_only() -> int:
    """Builds the kernels and times K1 and K2 alone with :func:`device_ms`,
    at the main paths' shapes; K2's output is held against the plain
    remap.  K2's labels are made as the trainer's are; K1's predictions
    are the labels with 30% noise, not a model's argmax.  To compare two
    trees in one call, copy this script to each tree's root and run it
    there with ``--kernels-only``."""
    phase_device()
    dev = torch.device("cuda")
    gta5 = ColorCodedLabels(
        SyntheticSegDataset(TRAIN_BATCH, TRAIN_SIZE, CLASSES, seed=SEED + 4,
                            fixed_tints=True),
        class_colors_for_remap(), unmatched=UNMATCHED, seed=SEED)
    rgb = torch.from_numpy(np.stack([gta5[i][1]
                                     for i in range(TRAIN_BATCH)])).to(dev)
    if not torch.equal(rgb_to_train_ids_cuda(rgb), rgb_to_train_ids(rgb)):
        raise AssertionError("remap kernel != plain on the training batch")
    label_map = SyntheticSegDataset(1, SIZE, CLASSES, seed=SEED)[0][1]
    labels = torch.from_numpy(label_map).to(dev).expand(
        BATCH, *SIZE).contiguous()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    noise = torch.randint(0, CLASSES, labels.shape, generator=gen,
                          device=dev, dtype=torch.int32)
    preds = torch.where(torch.rand(labels.shape, generator=gen, device=dev)
                        < 0.3, noise, labels)
    times = {}
    for name, fn in (
            ("fast_hist_cuda", lambda: fast_hist_cuda(labels, preds,
                                                      CLASSES)),
            ("rgb_to_train_ids_cuda", lambda: rgb_to_train_ids_cuda(rgb))):
        times[name] = {**device_ms(fn), "host_us": host_us(fn)}
    emit({"phase": "kernel_times", "timing": KERNEL_TIMING,
          "launches_per_timing": TIMED_LAUNCHES,
          "remap_pixels": rgb.numel() // 3, "hist_pixels": labels.numel(),
          "kernels": times})
    print(gpu_name_and_power_limit(), flush=True)
    return 0


def main() -> int:
    if sys.argv[1:] == ["--kernels-only"]:
        return kernels_only()
    if sys.argv[1:]:
        raise SystemExit(f"usage: {sys.argv[0]} [--kernels-only]")
    device = phase_device()
    hist_err = phase_hist_check()
    remap_err = phase_remap_check()

    ds = SyntheticSegDataset(SERVE_FRAMES + 2, SIZE, CLASSES, seed=SEED,
                             fixed_tints=True)
    frames = np.stack([ds[i][0] for i in range(SERVE_FRAMES)])
    calib = np.stack([ds[SERVE_FRAMES + i][0] for i in range(2)])
    tree = calibrate_batch_stats(random_flax_bisenet(SEED), calib, "cuda")

    # main path 1: serving and validation
    fast_hist_cuda.launches = 0
    rgb_to_train_ids_cuda.launches = 0
    predictor = phase_serving(tree, frames)
    labels, preds = phase_validation(predictor)
    serve_launches = fast_hist_cuda.launches
    if serve_launches < 1:
        raise AssertionError("serving/validation never launched K1")
    del predictor
    torch.cuda.empty_cache()

    # main path 2: supervised training (counts reset inside, just before)
    trained = phase_training()
    train_launches = trained["launches"]
    for name, n in train_launches.items():
        if n < 1:
            raise AssertionError(f"the training path never launched {name}")

    # main path 3: domain adaptation (counts reset inside, just before)
    da = phase_da_training()
    da_launches = da["launches"]
    for name, n in da_launches.items():
        if n < 1:
            raise AssertionError(f"the DA path never launched {name}")

    preds = preds.to(torch.int32)
    kernels = [
        kernel_timing(labels, preds,
                      serve_launches + train_launches["fast_hist_cuda"]
                      + da_launches["fast_hist_cuda"], hist_err),
        remap_timing(trained["rgb"], train_launches["rgb_to_train_ids_cuda"]
                     + da_launches["rgb_to_train_ids_cuda"], remap_err)]
    # last: the profiler's tracing may slow what runs after it
    traced = profile_kernels({
        "hist_kernel": lambda: fast_hist_cuda(labels, preds, CLASSES),
        "remap_kernel": lambda: rgb_to_train_ids_cuda(trained["rgb"])})
    for entry, name in zip(kernels, ("hist_kernel", "remap_kernel")):
        seen = traced[name]
        seen["timer_ms"] = entry["ms"]
        if isinstance(seen["median_ms"], float):
            seen["profiler_over_timer"] = seen["median_ms"] / entry["ms"]
    step = make_train_step(19)
    emit({"phase": "train_profile", "image_size": list(TRAIN_SIZE),
          "batch": TRAIN_BATCH, "kernel_device_ms": traced,
          **profile_steps(lambda: step(trained["state"], *trained["batch"])),
          "da_v1": {"source_size": list(TRAIN_SIZE),
                    "target_size": list(DA_TGT_SIZE),
                    **profile_steps(da["profile_run"], steps=3)}})
    emit({"kernels": kernels})
    print(gpu_name_and_power_limit(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": device["name"],
                                 "count": device["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
