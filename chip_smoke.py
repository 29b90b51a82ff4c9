#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rtsds_tpu_torch``) on one GPU.

    python3 chip_smoke.py                 # from the repository root, one card
    python3 chip_smoke.py --kernels-only  # build and time K1 and K2 alone
    python3 chip_smoke.py --int8-only     # the int8 phases alone

Kernels are timed on the device alone with the L2 cold: each timed launch
follows a write of a 256 MB buffer, as K2 follows the transform's write of
the float32 image on the training path, and CUDA events bracket that
launch only, so the wrapper's host cost (timed on its own) drops out.

Phases, each printing one JSON line; any failure exits non-zero:

  1. device: the card, its power limit, and the build of the CUDA kernels
     from ``rtsds_tpu_torch/ops/cuda/csrc``;
  2. hist_check: the confusion-matrix kernel (K1) against its plain PyTorch
     version, exactly, on edge cases, on each pair of id dtypes the main
     paths pass it, and at the eval batch's size;
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
  8. deeplab_serving, deeplab_validation, deeplab_training, deeplab_da:
     DeepLabV2-R101 served, validated under each protocol, trained and
     adapted at full width;
  9. the DA extras, BiSeNet-R18 at full width (source 720x1280, target
     512x1024, batch 8, bf16), each through the port's entry points on
     colour-coded labels (K2 in the source transform, K1 in the
     validation), with its step's p50, peak memory and one float64 step on
     the card held against the CPU's:
     ema_accumulate (supervised, EMA and gradient accumulation in 2
     micro-batches, validated on the EMA, its checkpoint restored),
     da_minent_fda (DA v1 and v2 with MinEnt and FDA), self_training (the
     mean-teacher step with CBST calibration and ClassMix) and
     distillation (a DeepLabV2-R101 teacher checkpoint with an ``ema``
     item, read back by ``load_teacher``, distilled into BiSeNet);
  10. serving_checkpoint: ema_accumulate's checkpoint served at full
     width by ``Predictor.from_checkpoint`` (its EMA weights checked),
     ``predict_iter`` held against ``predict`` and both timed, the HTTP
     micro-batching server answering raw requests from 4 client threads,
     each reply held against ``predict``, and ``validate`` of the served
     model (K1);
  11. the port's benches, each its own line: latency_sweep (BiSeNet-R18
     1024x2048 at b1, b8, b64), deeplab_latency, protocol_benches
     (sliding, ensemble), model_flops, and one_line_bench (``python -m
     rtsds_tpu_torch.bench`` in a subprocess);
  12. int8 (W8A8, ``ops/quant.py``): int8_ops (every distinct quantized
     conv of both default policies at full width, and the shapes the int8
     GEMM pads, held exactly against a float64 conv on the card; the
     quantizers and the BN fold on the card against the CPU),
     int8_serving (``Predictor(quantize="int8")`` for BiSeNet-R18 at
     1024x2048 and DeepLabV2-R101 at 512x1024, b8, calibrated with the max
     and the percentile statistic, masks against bf16, timed, validated
     with K1; DeepLab's sliding and ensemble protocols in int8), qat
     (``qat.finetune`` at its CLI defaults on in-memory frames, the step
     bench, the export grid, the write-back, the sidecar served by
     ``from_checkpoint``, one float32 step on the card against the CPU's
     on the card's activation codes), distillation_int8 (the CLI's int8
     DeepLab teacher, K2 and K1 on its path, its step against the bf16
     teacher's), pseudo_label (the sweep's in-memory core in int8 with
     CBST thresholds) and quant_bench (whole-network int8 against bf16,
     and DeepLab's 3x3 conv shapes with the im2col and the GEMM apart);
     ``python3 chip_smoke.py --int8-only`` runs these alone;
  13. train_profile: torch.profiler over a few train steps: the device's
     idle share and kernel time by group, and each hand-written kernel's
     device time per launch beside the timer's (run after the kernel
     timings, which the profiler's tracing could slow);
  14. the ``kernels`` line: each kernel's launches on the main paths (each
     counted from zero), its device time as the main path calls it
     (median, min, max), its wrapper's host cost, its plain version's
     time, a one-call library yardstick where one exists, and the card's
     bound; K1's also on int32 predictions.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from rtsds_tpu_torch.bench.da_bench import da_step_benchmark
from rtsds_tpu_torch.bench.train_bench import supervised_step_benchmark
from rtsds_tpu_torch.callbacks.base import Callback
from rtsds_tpu_torch.callbacks.checkpoint import ModelCheckpoint
from rtsds_tpu_torch.config import load_config
from rtsds_tpu_torch.data.pipeline import (
    DataLoader, batch_generator, device_batches)
from rtsds_tpu_torch.data.synthetic import (
    ColorCodedLabels, SyntheticSegDataset)
from rtsds_tpu_torch.eval.ensemble import make_ensemble_eval_step
from rtsds_tpu_torch.eval.sliding import make_sliding_eval_step
from rtsds_tpu_torch.eval.validate import make_eval_step, validate
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.deeplabv2 import STAGES as DEEPLAB_STAGES
from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2
from rtsds_tpu_torch.models.bisenet_int8 import (
    bisenet_bf16_apply, bisenet_int8_apply, fold_bisenet)
from rtsds_tpu_torch.models.deeplab_int8 import deeplab_int8_apply
from rtsds_tpu_torch.models.pretrained import (
    load_flax_variables, load_segmentor_state, state_dict_from_flax,
    torch_scope)
from rtsds_tpu_torch.ops import preprocess, quant
from rtsds_tpu_torch.ops.augment import AugmentConfig
from rtsds_tpu_torch.ops.cuda import _build
from rtsds_tpu_torch.ops.cuda.hist import fast_hist_cuda
from rtsds_tpu_torch.ops.cuda.remap import rgb_to_train_ids_cuda
from rtsds_tpu_torch.ops.losses import segmentation_loss
from rtsds_tpu_torch.ops.preprocess import make_transform, normalize
from rtsds_tpu_torch.ops.quant import (
    QuantizedSegmentor, conv_bf16, conv_int8, fake_quant_act,
    fake_quant_kernel, fold_bn, folded_on, int8_model_module, quantize_act,
    quantize_kernel)
from rtsds_tpu_torch.ops.remap import rgb_to_train_ids
from rtsds_tpu_torch.serve import Predictor
from rtsds_tpu_torch.train.adversarial import make_adversarial_step
from rtsds_tpu_torch.train.factory import (
    build_adversarial, build_supervised, make_discriminator, make_segmentor)
from rtsds_tpu_torch.train.loop import adversarial_fit, supervised_fit
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.qat import (
    create_qat_state, export_int8, load_act_scales, prepare_qat, writeback)
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
# DeepLabV2-R101: served and validated at the JAX package's DeepLab
# serving shape, the sliding protocol at SIZE with this window, the
# ensemble at these scales with flip; trained on the GTA5 shape above
DEEPLAB_SIZE = (512, 1024)
DEEPLAB_SCALES = (0.75, 1.0, 1.25)
DEEPLAB_VAL_BATCHES = 2
DEEPLAB_TRAIN_STEPS = 3   # one epoch
DEEPLAB_DA_ITERATIONS = 2  # one epoch
DEEPLAB_BENCH_STEPS = 3   # per timed repeat
# serving a trained checkpoint, and the port's benches
SERVER_CLIENTS = 4
REQUESTS_PER_CLIENT = 4
STREAM_BATCHES = 10      # per timed predict / predict_iter run
SWEEP_BATCHES = (1, 8, 64)
LATENCY_SAMPLES = 100    # per-call samples: p99 needs 100
PROTOCOL_BENCH_ITERS = 10
ONE_LINE_ITERS = 10
INT8_CALIB_BATCHES = 2   # calibration batches of the int8 predictors
QAT_STEPS = 2            # fine-tune steps of the qat phase
QB_ITERS = 10            # per-call samples of each quant_bench timing
# a float32 QAT step, card against CPU (the earlier card-vs-CPU steps'
# update limit): the loss to this relative difference, each parameter's
# update within this share of its tensor's largest update (+ 1e-6)
QAT_LOSS_RTOL = 1e-5
QAT_UPDATE_RTOL = 1e-3
# the activation codes and ReLU signs that the CPU's QAT step may take from
# the card's run: each one is an input within f32 rounding of a half step
# (or of zero), and the first card runs read 3 codes and 0 signs (PERF.md)
MAX_QAT_REPLAYED_FLIPS = 16
# least share of pixels whose bf16 DeepLab mask equals the f32 mask.  The
# first card run read 0.4563 (PERF.md): bf16 rounding through 101 layers
# of random weights flips the argmax where the top two logits are close,
# far more often than in BiSeNet-R18 (0.8947).  A broken bf16 path agrees
# on about one pixel in CLASSES; the limit sits between the two
MIN_DEEPLAB_BF16_AGREEMENT = 0.35
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
# least share of pixels whose int8 mask equals the bf16 mask, per model
# (plain, both statistics, and DeepLab's protocols).  The first card runs
# read 0.540-0.712 (BiSeNet) and 0.376-0.720 (DeepLab) on random weights,
# whose small top-two logit margins near-tie many pixels (PERF.md).  This
# bound catches only a gross fault: a planted one (every quantized conv's
# dequantization scale doubled) is measured and printed beside it, and
# the int8 wiring at full width is held by INT8_WALK_* below
MIN_INT8_AGREEMENT = {"bisenet": 0.45, "deeplab": 0.30}
# one full-width frame's float32 int8 walk (TF32 off) on the card against
# the CPU's on the same quantized tree, as tests/test_torch_cuda.py holds
# it at 64x128: the logits within this share of their peak, and at least
# this share of the argmax equal (an activation within f32 rounding of a
# half step may take the other code on either side)
INT8_WALK_ATOL_SHARE = 2e-2
INT8_WALK_MIN_ARGMAX = 0.99


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


class _FlaxTree:
    """A Flax variable tree made with numpy from ``seed``: He-scaled
    kernels and BN statistics near the identity."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.params: dict = {}
        self.stats: dict = {}

    @staticmethod
    def _node(tree: dict, path: tuple) -> dict:
        for p in path:
            tree = tree.setdefault(p, {})
        return tree

    def conv(self, path: tuple, k: int, cin: int, cout: int,
             bias: bool = False, fan_in: int | None = None) -> None:
        fan_in = fan_in or k * k * cin
        leaf = self._node(self.params, path)
        leaf["kernel"] = (self.rng.standard_normal((k, k, cin, cout))
                          * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if bias:
            leaf["bias"] = (0.01 * self.rng.standard_normal(cout)).astype(
                np.float32)

    def bn(self, path: tuple, c: int) -> None:
        rng = self.rng
        self._node(self.params, path).update(
            scale=rng.uniform(0.8, 1.2, c).astype(np.float32),
            bias=(0.05 * rng.standard_normal(c)).astype(np.float32))
        self._node(self.stats, path).update(
            mean=(0.05 * rng.standard_normal(c)).astype(np.float32),
            var=rng.uniform(0.8, 1.2, c).astype(np.float32))

    def variables(self) -> dict:
        return {"params": self.params, "batch_stats": self.stats}


def random_flax_bisenet(seed: int, num_classes: int = CLASSES,
                        train: bool = False) -> dict:
    """A BiSeNet-R18 variable tree in the JAX package's Flax layout
    (:class:`_FlaxTree`).  ``train=False`` leaves out the two train-only
    heads, as a Flax init for eval does."""
    t = _FlaxTree(seed)

    def convblock(path, cin, cout):
        t.conv((*path, "conv1"), 3, cin, cout)
        t.bn((*path, "bn"), cout)

    for i, (cin, cout) in enumerate(((3, 64), (64, 128), (128, 256)), 1):
        convblock(("spatial_path", f"convblock{i}"), cin, cout)

    t.conv(("context_path", "conv1"), 7, 3, 64)
    t.bn(("context_path", "bn1"), 64)
    cin = 64
    for stage, width in enumerate((64, 128, 256, 512), 1):
        for b in range(2):
            scope = ("context_path", f"layer{stage}_{b}")
            stride = 2 if stage > 1 and b == 0 else 1
            t.conv((*scope, "conv1"), 3, cin, width)
            t.bn((*scope, "bn1"), width)
            t.conv((*scope, "conv2"), 3, width, width)
            t.bn((*scope, "bn2"), width)
            if b == 0 and (stride != 1 or cin != width):
                t.conv((*scope, "downsample_conv"), 1, cin, width)
                t.bn((*scope, "downsample_bn"), width)
            cin = width

    for name, c in (("arm1", 256), ("arm2", 512)):
        t.conv((name, "conv"), 1, c, c, bias=True)
        t.bn((name, "bn"), c)
    if train:
        t.conv(("supervision1",), 1, 256, num_classes, bias=True)
        t.conv(("supervision2",), 1, 512, num_classes, bias=True)
    convblock(("ffm", "convblock"), 256 + 256 + 512, num_classes)
    t.conv(("ffm", "conv1"), 1, num_classes, num_classes, bias=True)
    t.conv(("ffm", "conv2"), 1, num_classes, num_classes, bias=True)
    t.conv(("conv",), 1, num_classes, num_classes, bias=True)
    return t.variables()


def random_flax_deeplab(seed: int, num_classes: int = CLASSES) -> dict:
    """A DeepLabV2-R101 variable tree in the JAX package's Flax layout
    (:class:`_FlaxTree`); the classifier's kernels are He-scaled over its
    four summed branches.  Train and eval inits hold the same tree."""
    t = _FlaxTree(seed)
    t.conv(("conv1",), 7, 3, 64)
    t.bn(("bn1",), 64)
    cin = 64
    for stage, ((width, _, _), depth) in enumerate(
            zip(DEEPLAB_STAGES, (3, 4, 23, 3)), 1):
        for b in range(depth):
            scope = (f"layer{stage}_{b}",)
            t.conv((*scope, "conv1"), 1, cin, width)
            t.bn((*scope, "bn1"), width)
            t.conv((*scope, "conv2"), 3, width, width)
            t.bn((*scope, "bn2"), width)
            t.conv((*scope, "conv3"), 1, width, 4 * width)
            t.bn((*scope, "bn3"), 4 * width)
            if b == 0:  # every stage's first block projects its skip
                t.conv((*scope, "downsample_conv"), 1, cin, 4 * width)
                t.bn((*scope, "downsample_bn"), 4 * width)
            cin = 4 * width
    for i in range(4):
        t.conv(("layer6", f"conv2d_list_{i}"), 3, cin, num_classes,
               bias=True, fan_in=4 * 9 * cin)
    return t.variables()


def calibrate_batch_stats(tree: dict, frames: np.ndarray,
                          device: str = "cpu", model_cls=BiSeNet) -> dict:
    """Replace the tree's BN statistics, in place, by those of ``frames``
    (one f32 train-mode forward of a ``model_cls``, cumulative averages),
    as training would have set them.  Random statistics let the
    activations grow to ~1e9 and the argmax collapse onto two classes;
    calibrated ones keep the logits near unit scale and the predictions
    spread over classes."""
    model = load_flax_variables(model_cls(), tree).to(device)
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


# the (label, prediction) id dtypes K1 reads as they are
ID_DTYPE_PAIRS = ((torch.int32, torch.int32), (torch.int32, torch.int64),
                  (torch.uint8, torch.int64), (torch.int64, torch.int64))


def out_of_range_ids(gen: torch.Generator, n: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """``n`` ids of ``dtype`` on the card, about a third in [0, CLASSES),
    the rest negative or >= CLASSES; in int64 a third of all >= 2^32, of
    which 2^32 + k would wrap to k in 32 bits."""
    dev = torch.device("cuda")
    lo, hi = (0, 256) if dtype == torch.uint8 else (-2 * CLASSES,
                                                     2 * CLASSES)
    ids = torch.randint(lo, hi, (n,), generator=gen, device=dev)
    if dtype == torch.int64:
        wide = torch.rand((n,), generator=gen, device=dev) < 1 / 3
        ids = torch.where(wide, ids.remainder(CLASSES) + 2 ** 32, ids)
    return ids.to(dtype)


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
    # each pair of id dtypes the main paths pass, read as it is: negative
    # ids, ids >= n and, in int64, ids of 2^32 and above, which must not
    # wrap into range
    for label_dtype, pred_dtype in ID_DTYPE_PAIRS:
        name = (f"{str(label_dtype)[6:]}_labels_{str(pred_dtype)[6:]}_preds"
                f"_out_of_range")
        cases[name] = (out_of_range_ids(gen, 1_000_003, label_dtype),
                       out_of_range_ids(gen, 1_000_003, pred_dtype), CLASSES)
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


def _synthetic_batches(n_batches: int, size: tuple[int, int],
                       seed: int) -> list:
    """``n_batches`` normalized (images, labels) batches of ``BATCH``
    synthetic frames at ``size``, on the card."""
    ds = SyntheticSegDataset(n_batches * BATCH, size, CLASSES, seed=seed,
                             fixed_tints=True)
    batches = []
    for b in range(n_batches):
        items = [ds[b * BATCH + i] for i in range(BATCH)]
        images = torch.from_numpy(np.stack([im for im, _ in items])).cuda()
        labels = torch.from_numpy(np.stack([lb for _, lb in items])).cuda()
        batches.append((normalize(images), labels))
    return batches


def checked_eval_step(step, step_ms: list, last: dict | None = None):
    """``step`` timed with CUDA events into ``step_ms``, each histogram it
    adds held against the plain ``fast_hist`` of its predictions; the
    last batch's (labels, preds) kept in ``last``."""
    def run(images, labels, hist):
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
        if last is not None:
            last["labels"], last["preds"] = labels, preds
        return new_hist, preds
    return run


def phase_validation(predictor: Predictor):
    """Returns the last batch's (labels, preds) on the device."""
    batches = _synthetic_batches(VAL_BATCHES, SIZE, seed=SEED + 1)
    step = make_eval_step(predictor.model, CLASSES, return_preds=True)
    step_ms = []
    last = {}
    miou, per_class = validate(predictor.model, iter(batches), CLASSES,
                               class_names=CLASS_NAMES,
                               eval_step=checked_eval_step(step, step_ms,
                                                           last),
                               device="cuda")
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


def on_main_path(run) -> tuple:
    """``run()`` as a main path: K1's and K2's launch counts set to 0 just
    before it and read just after, and every K2 output that
    ``make_transform`` takes held against the plain remap.  Returns
    ``(run's result, launches by kernel, K2 outputs checked)``."""
    checked = {"checked": 0}
    plain_remap = preprocess.rgb_to_train_ids_cuda
    fast_hist_cuda.launches = 0
    rgb_to_train_ids_cuda.launches = 0
    preprocess.rgb_to_train_ids_cuda = _checked_remap(checked)
    try:
        out = run()
        torch.cuda.synchronize()
    finally:
        preprocess.rgb_to_train_ids_cuda = plain_remap
    launches = {"fast_hist_cuda": fast_hist_cuda.launches,
                "rgb_to_train_ids_cuda": rgb_to_train_ids_cuda.launches}
    return out, launches, checked["checked"]


def _gta5_stream(n: int, seed: int, infinite: bool = False):
    """A loader of ``n`` colour-coded GTA5-sized synthetic frames and the
    source transform (blur + flip, K2) of the default config."""
    gta5 = ColorCodedLabels(
        SyntheticSegDataset(n, TRAIN_SIZE, CLASSES, seed=seed,
                            fixed_tints=True),
        class_colors_for_remap(), unmatched=UNMATCHED, seed=SEED)
    loader = DataLoader(gta5, TRAIN_BATCH, shuffle=True, num_workers=4,
                        seed=SEED, infinite=infinite)
    transform = make_transform(
        TRAIN_SIZE, CLASSES, antialias=False,
        augment_cfg=AugmentConfig.from_config(load_config()),
        decode_label_colors=True)
    return loader, transform


def _target_stream(n: int, seed: int):
    """An endless loader of ``n`` Cityscapes-sized synthetic frames and its
    transform."""
    target = SyntheticSegDataset(n, DA_TGT_SIZE, CLASSES, seed=seed,
                                 fixed_tints=True)
    loader = DataLoader(target, TRAIN_BATCH, num_workers=4, seed=SEED + 1,
                        infinite=True)
    return loader, make_transform(DA_TGT_SIZE, CLASSES, antialias=True)


def _val_stream():
    """``make_val_batches`` of the trainers: TRAIN_VAL_BATCHES batches of
    Cityscapes-sized synthetic frames on the card."""
    val = SyntheticSegDataset(TRAIN_VAL_BATCHES * TRAIN_BATCH, TRAIN_VAL_SIZE,
                              CLASSES, seed=SEED + 5, fixed_tints=True)
    loader = DataLoader(val, TRAIN_BATCH, shuffle=False, num_workers=4,
                        drop_last=False)
    transform = make_transform(TRAIN_VAL_SIZE, CLASSES, antialias=True)
    return lambda epoch: device_batches(loader, transform, "cuda")


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


def step_card_vs_cpu(dtype: torch.dtype, batch: int,
                     model_name: str = "bisenet",
                     size: tuple[int, int] = (64, 128),
                     accumulate_steps: int = 1) -> dict:
    """One SGD step of ``model_name`` at full depth (BiSeNet-R18, or
    DeepLabV2-R101 with its BN affines frozen) at ``size`` on the card and
    on the CPU, same weights and batch, in ``dtype``, TF32 off (with
    ``accumulate_steps`` > 1, the accumulating step over that many
    micro-batches); fails unless they agree, and unless the frozen affines
    stay exactly still.
    The CPU step takes the card's ReLU routing: an input within rounding of
    zero may round to either side, and one such flip moves some tensors'
    updates by tens of times the limit (PERF.md).  Returns
    the loss's relative difference, the largest difference of the BN
    running statistics over ``1e-5 + 1e-4 * |cpu|``, per parameter tensor
    the largest difference of the two updates over ``1e-3 * largest update
    + 1e-6``, and the count of ReLU inputs whose sign on the CPU differed
    from the card's."""
    ds = SyntheticSegDataset(batch, size, CLASSES, seed=SEED + 3,
                             fixed_tints=True)
    images = normalize(torch.from_numpy(np.stack([ds[i][0]
                                                  for i in range(batch)])))
    images = images.to(dtype)
    labels = torch.from_numpy(np.stack([ds[i][1] for i in range(batch)]))
    labels[:, :3] = 19  # a band of ignored pixels
    config = load_config()
    states = {}
    frozen_names = []
    for dev in ("cpu", "cuda"):
        model, frozen = make_segmentor(config, model_name, seed=SEED)
        model.to(dev, dtype)
        opt = make_optimizer("SGD", model.parameters(), 0.01, momentum=0.9,
                             frozen=frozen)
        states[dev] = TrainState(model, opt)
        names = {id(p): k for k, p in model.named_parameters()}
        frozen_names = [names[id(p)] for p in frozen]
    before = {k: v.detach().clone() for k, v in
              states["cpu"].model.named_parameters()}
    step = make_train_step(19)
    if accumulate_steps > 1:
        from rtsds_tpu_torch.train.accumulate import (
            make_accumulating_train_step, split_microbatches)
        acc = make_accumulating_train_step(19)

        def step(state, images, labels):  # noqa: F811
            return acc(state, split_microbatches(images, accumulate_steps),
                       split_microbatches(labels, accumulate_steps))
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
    frozen_moved = [k for k in frozen_names
                    if not torch.equal(gpu_params[k].detach().cpu(),
                                       before[k])]
    result = {"model": model_name, "size": list(size),
              "dtype": str(dtype).replace("torch.", ""), "batch": batch,
              "accumulate_steps": accumulate_steps,
              "loss_cpu": losses["cpu"], "loss_cuda": losses["cuda"],
              "loss_rel_diff": abs(losses["cuda"] - losses["cpu"])
              / abs(losses["cpu"]),
              "bn_stats_err_over_limit": stats_err,
              "tensors_over_limit": sum(r > 1.0 for r in ratios.values()),
              "worst_update_err_over_limit": {k: ratios[k]
                                              for k in worst[:3]},
              "relu_sign_flips": seen["flips"],
              "frozen_bn_tensors": len(frozen_names),
              "frozen_bn_moved_on_card": len(frozen_moved)}
    if (result["loss_rel_diff"] > 1e-4 or stats_err > 1.0
            or result["tensors_over_limit"] or frozen_moved):
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
    loader, transform = _gta5_stream(TRAIN_STEPS * TRAIN_BATCH, SEED + 4)
    val_batches = _val_stream()
    state = build_supervised(config, "bisenet", len(loader), dev, seed=SEED)
    recorder = _LossRecorder()
    checkpoint = ModelCheckpoint(save_dir=tmp.name, save_name="smoke",
                                 save_best=False)

    t0 = time.perf_counter()
    (_, history), launches, checked = on_main_path(
        lambda: supervised_fit(
            state, make_train_step(19),
            lambda epoch: device_batches(loader, transform, dev, seed=SEED,
                                         epoch=epoch),
            val_batches, epochs=TRAIN_EPOCHS, num_classes=CLASSES,
            class_names=CLASS_NAMES, callbacks=[recorder],
            checkpoint=checkpoint, device=dev))
    fit_s = time.perf_counter() - t0

    if len(recorder.losses) != TRAIN_EPOCHS * TRAIN_STEPS or not all(
            math.isfinite(x) for x in recorder.losses):
        raise AssertionError(f"train losses {recorder.losses}")
    if checked != TRAIN_EPOCHS * TRAIN_STEPS:
        raise AssertionError(f"{checked} K2 calls checked")
    if len(history) != TRAIN_EPOCHS or not all(
            0.0 <= h["validation_mIoU"] <= 1.0 for h in history):
        raise AssertionError(f"history {history}")

    # one batch of the path, kept for the timings below
    host_images, host_rgb = next(iter(loader))
    images_dev = torch.from_numpy(host_images).to(dev)
    rgb_dev = torch.from_numpy(host_rgb).to(dev)
    images, labels = transform(images_dev, rgb_dev,
                               batch_generator(SEED, 0, 0))
    val_images, val_labels = next(iter(val_batches(0)))

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
          "k2_outputs_checked": checked,
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


def _update_ratios(named: dict, before: dict, prefix: str) -> dict:
    """Per tensor, the largest difference of the card's update from the
    CPU's over ``1e-3 * largest CPU update + 1e-6``; ``named`` maps a name
    to its (CPU tensor, card tensor)."""
    ratios = {}
    for k, (cpu, gpu) in named.items():
        want = cpu.detach() - before[k]
        got = gpu.detach().cpu() - before[k]
        limit = 1e-3 * float(want.abs().max()) + 1e-6
        ratios[f"{prefix}:{k}"] = float((got - want).abs().max()) / limit
    return ratios


def da_step_card_vs_cpu(variant: str = "v1", grl_alpha: float = 0.0,
                        generator: str = "bisenet", lambda_ent: float = 0.0,
                        fda_beta: float = 0.0,
                        self_training: bool = False) -> dict:
    """One float64 SGD step of the adversarial trainer (a BiSeNet-R18 or
    DeepLabV2-R101 ``generator``, the latter with its BN affines frozen,
    and the Tiny discriminator, b2, source 64x96, target 64x128) on the
    card and on the CPU, same weights and batches; with ``lambda_ent`` and
    ``fda_beta`` its MinEnt and FDA, and with ``self_training`` the
    mean-teacher step (ClassMix on scores drawn on the CPU, a threshold
    near the median confidence), whose EMA is compared too.  Fails unless
    every loss agrees to 1e-4 relative, G's BN running statistics to rtol
    1e-4 / atol 1e-5, and each parameter tensor's update, of G, of D and
    of the EMA, to 1e-3 of its largest update + 1e-6.  Returns the worst of
    each, over its limit."""
    from rtsds_tpu_torch.train.ema import ema_init
    from rtsds_tpu_torch.train.self_training import (
        classmix_scores, make_self_training_step)

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
        gen, frozen = make_segmentor(config, generator, seed=SEED)
        gen.to(dev, torch.float64)
        dis = make_discriminator(
            config.model["adversarial_model"]["discriminator"],
            seed=SEED + 1).to(dev, torch.float64)
        states[dev] = (
            TrainState(gen, make_optimizer("SGD", gen.parameters(), 0.01,
                                           momentum=0.0, frozen=frozen)),
            TrainState(dis, make_optimizer("SGD", dis.parameters(), 0.02,
                                           momentum=0.0)))
    before = [{k: v.detach().clone() for k, v in s.model.named_parameters()}
              for s in states["cpu"]]
    if self_training:
        emas = {dev: ema_init(states[dev][0].model) for dev in states}
        scores = classmix_scores(SEED, 0, 2, CLASSES)
        st_step = make_self_training_step(
            0.1, DA_ITERATIONS, 19, threshold=0.18, ema_decay=0.99,
            lambda_ent=lambda_ent, fda_beta=fda_beta, classmix=True)

        def run(dev):
            return st_step(*states[dev], emas[dev], src.to(dev),
                           labels.to(dev), tgt.to(dev), scores=scores)
    else:
        step = make_adversarial_step(0.1, DA_ITERATIONS, DA_EPOCHS, 19,
                                     variant, lambda_ent=lambda_ent,
                                     fda_beta=fda_beta, grl_alpha=grl_alpha)

        def run(dev):
            return step(*states[dev], src.to(dev), labels.to(dev),
                        tgt.to(dev))
    metrics = {dev: run(dev) for dev in ("cuda", "cpu")}
    loss_keys = [k for k in metrics["cpu"] if k.startswith(("loss_", "pl_",
                                                            "mix_"))]
    loss_err = max(abs(float(metrics["cuda"][k]) - float(metrics["cpu"][k]))
                   / max(abs(float(metrics["cpu"][k])), 1e-12)
                   for k in loss_keys)
    cpu_state = states["cpu"][0].model.state_dict()
    stats_err = max(float(((v.cpu() - cpu_state[k]).abs()
                           / (1e-5 + 1e-4 * cpu_state[k].abs())).max())
                    for k, v in states["cuda"][0].model.state_dict().items()
                    if "running_" in k)
    ratios = {}
    for net, cpu_s, gpu_s, start in zip("GD", states["cpu"], states["cuda"],
                                        before):
        gpu_params = dict(gpu_s.model.named_parameters())
        ratios.update(_update_ratios(
            {k: (p, gpu_params[k]) for k, p in
             cpu_s.model.named_parameters()}, start, net))
    if self_training:
        ratios.update(_update_ratios(
            {k: (v, emas["cuda"][k]) for k, v in emas["cpu"].items()},
            before[0], "EMA"))
    worst = sorted(ratios, key=ratios.get, reverse=True)
    result = {"generator": generator, "variant": variant,
              "grl_alpha": grl_alpha, "lambda_ent": lambda_ent,
              "fda_beta": fda_beta, "self_training": self_training,
              "losses_cpu": {k: float(metrics["cpu"][k]) for k in loss_keys},
              "loss_rel_diff": loss_err, "bn_stats_err_over_limit": stats_err,
              "tensors_compared": len(ratios),
              "tensors_over_limit": sum(r > 1.0 for r in ratios.values()),
              "worst_update_err_over_limit": {k: ratios[k]
                                              for k in worst[:2]}}
    if loss_err > 1e-4 or stats_err > 1.0 or result["tensors_over_limit"]:
        raise AssertionError(f"the DA step on the card differs from the "
                             f"CPU's: {result}")
    return result


def distill_step_card_vs_cpu() -> dict:
    """One float64 SGD step of distillation on the card and on the CPU:
    the BiSeNet-R18 student (b2, 64x96) under a DeepLabV2-R101 teacher at
    full depth, each made from a seed; fails unless the three losses agree
    to 1e-4 relative, the student's BN running statistics to rtol 1e-4 /
    atol 1e-5, and each parameter's update to 1e-3 of its largest update
    + 1e-6."""
    from rtsds_tpu_torch.train.distill import make_distill_step

    ds = SyntheticSegDataset(2, (64, 96), CLASSES, seed=SEED + 15,
                             fixed_tints=True)
    images = normalize(torch.from_numpy(np.stack([ds[i][0]
                                                  for i in range(2)])))
    images = images.double()
    labels = torch.from_numpy(np.stack([ds[i][1] for i in range(2)]))
    labels[:, :3] = 19
    config = load_config()
    states, metrics = {}, {}
    for dev in ("cuda", "cpu"):
        student, _ = make_segmentor(config, "bisenet", seed=SEED)
        student.to(dev, torch.float64)
        teacher, _ = make_segmentor(config, "deeplab", seed=SEED + 1)
        teacher.to(dev, torch.float64)
        states[dev] = TrainState(student, make_optimizer(
            "SGD", student.parameters(), 0.01, momentum=0.0))
        before = {k: v.detach().clone().cpu() for k, v in
                  student.named_parameters()}
        metrics[dev] = make_distill_step(teacher, 19)(
            states[dev], images.to(dev), labels.to(dev))
    keys = ("train_loss", "loss_ce", "loss_distill")
    loss_err = max(abs(float(metrics["cuda"][k]) - float(metrics["cpu"][k]))
                   / abs(float(metrics["cpu"][k])) for k in keys)
    cpu_state = states["cpu"].model.state_dict()
    stats_err = max(float(((v.cpu() - cpu_state[k]).abs()
                           / (1e-5 + 1e-4 * cpu_state[k].abs())).max())
                    for k, v in states["cuda"].model.state_dict().items()
                    if "running_" in k)
    gpu_params = dict(states["cuda"].model.named_parameters())
    ratios = _update_ratios({k: (p, gpu_params[k]) for k, p in
                             states["cpu"].model.named_parameters()},
                            before, "student")
    worst = sorted(ratios, key=ratios.get, reverse=True)
    result = {"student": "bisenet-resnet18", "teacher": "deeplabv2-resnet101",
              "losses_cpu": {k: float(metrics["cpu"][k]) for k in keys},
              "loss_rel_diff": loss_err, "bn_stats_err_over_limit": stats_err,
              "tensors_over_limit": sum(r > 1.0 for r in ratios.values()),
              "worst_update_err_over_limit": {k: ratios[k]
                                              for k in worst[:2]}}
    if loss_err > 1e-4 or stats_err > 1.0 or result["tensors_over_limit"]:
        raise AssertionError(f"the distillation step on the card differs "
                             f"from the CPU's: {result}")
    return result


V1_LOSS_KEYS = ("loss_gen_source", "loss_adversarial", "loss_disc_source",
                "loss_disc_target")


def check_da_losses(losses: list, steps: int,
                    keys: tuple = V1_LOSS_KEYS) -> None:
    """``steps`` rows of the losses ``keys`` (v1's four by default), every
    one finite."""
    if len(losses) != steps or not all(
            sorted(logs) == sorted(keys)
            and all(math.isfinite(v) for v in logs.values())
            for logs in losses):
        raise AssertionError(f"DA losses {losses}")


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
    src_loader, src_transform = _gta5_stream(n, SEED + 6, infinite=True)
    tgt_loader, tgt_transform = _target_stream(n, SEED + 7)
    val_batches = _val_stream()
    gen, dis = build_adversarial(config, dev, seed=SEED)
    step = make_adversarial_step(float(tcfg["lambda"]), DA_ITERATIONS,
                                 DA_EPOCHS, 19, "v1")
    recorder = _DALossRecorder()
    checkpoint = ModelCheckpoint(save_dir=tmp.name, save_name="smoke_da",
                                 save_best=False)
    source_iter = device_batches(src_loader, src_transform, dev, seed=SEED)
    target_iter = device_batches(tgt_loader, tgt_transform, dev)

    with contextlib.closing(source_iter), contextlib.closing(target_iter):
        t0 = time.perf_counter()
        (_, _, history), launches, checked = on_main_path(
            lambda: adversarial_fit(
                gen, dis, step, source_iter, target_iter, val_batches,
                iterations=DA_ITERATIONS, epochs=DA_EPOCHS,
                num_classes=CLASSES, class_names=CLASS_NAMES,
                callbacks=[recorder], checkpoint=checkpoint, device=dev))
        fit_s = time.perf_counter() - t0
        # the next batch of each stream, kept for the profile
        batch = (*next(source_iter), next(target_iter)[0])

    steps = DA_EPOCHS * DA_ITERATIONS
    check_da_losses(recorder.losses, steps)
    if checked != steps:
        raise AssertionError(f"{checked} K2 calls checked")
    if len(history) != DA_EPOCHS or not all(
            0.0 <= h["validation_mIoU"] <= 1.0 for h in history):
        raise AssertionError(f"history {history}")

    # the saved checkpoint restored into freshly initialised states
    val_images, _ = next(iter(val_batches(0)))
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
          "k2_outputs_checked": checked, "launches": launches,
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


def _masks_ok(masks: np.ndarray, shape: tuple, what: str) -> None:
    if masks.shape != shape or masks.dtype != np.int32:
        raise AssertionError(f"{what}: masks {masks.shape} {masks.dtype}")
    if masks.min() < 0 or masks.max() >= CLASSES:
        raise AssertionError(f"{what}: mask ids outside [0, {CLASSES})")


def phase_deeplab_serving(tree: dict, frames: np.ndarray,
                          big_frames: np.ndarray) -> dict:
    """DeepLabV2-R101 served at DEEPLAB_SIZE b8 bf16 (``frames``), held
    against an f32 run and its CUDA f32 logits against the CPU's; the
    sliding protocol at SIZE (``big_frames``) with a DEEPLAB_SIZE window
    and the ensemble at DEEPLAB_SIZE, each timed, and each held to the
    plain masks where the two must agree: a window covering the whole
    frame, and scale 1 without flip."""
    common = {"model_name": "deeplab", "variables": tree,
              "batch_size": BATCH, "device": "cuda"}
    plain = Predictor(image_size=DEEPLAB_SIZE, **common).warmup()
    on_device = plain._predict(frames[:BATCH])
    if not (on_device.is_cuda and on_device.dtype == torch.uint8
            and tuple(on_device.shape) == (BATCH, *DEEPLAB_SIZE)):
        raise AssertionError(f"device masks: {on_device.device} "
                             f"{on_device.dtype} {tuple(on_device.shape)}")
    masks = plain.predict(frames)
    _masks_ok(masks, (len(frames), *DEEPLAB_SIZE), "deeplab plain")
    batch = frames[:BATCH]
    p50 = cuda_ms(lambda: plain.predict(batch), reps=10)
    x = normalize(torch.from_numpy(batch).cuda()).permute(0, 3, 1, 2)
    x = x.to(torch.bfloat16)
    with torch.inference_mode():
        forward_ms = cuda_ms(lambda: plain.model(x).argmax(dim=1), reps=10)
    del x, on_device

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        f32 = Predictor(image_size=DEEPLAB_SIZE, dtype=torch.float32,
                        **common)
        masks32 = f32.predict(frames)
        x = normalize(torch.from_numpy(frames[:1, :128, :256].copy()))
        x = x.permute(0, 3, 1, 2).contiguous()
        cpu_model = load_flax_variables(DeepLabV2(output_f32=False), tree)
        with torch.inference_mode():
            want = cpu_model.eval()(x)
            got = f32.model(x.cuda()).cpu()
        cpu_err = float((got - want).abs().max())
        cpu_scale = float(want.abs().max())
        del f32, cpu_model
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags
    torch.cuda.empty_cache()
    agreement = float((masks == masks32).mean())

    protocols = {}
    for name, size, kwargs, fr in (
            ("sliding", SIZE, {"window": DEEPLAB_SIZE}, big_frames),
            ("ensemble", DEEPLAB_SIZE, {"scales": DEEPLAB_SCALES}, batch)):
        pred = Predictor(image_size=size, protocol=name,
                         protocol_kwargs=kwargs, **common).warmup()
        _masks_ok(pred.predict(fr), (len(fr), *size), f"deeplab {name}")
        ms = cuda_ms(lambda: pred.predict(fr), reps=5, warmup=1)
        protocols[name] = {"image_size": list(size), **kwargs,
                           "frames": len(fr), "p50_ms_per_batch": ms,
                           "fps": len(fr) * 1000.0 / ms}
        del pred
        torch.cuda.empty_cache()
    # where a protocol must give the plain forward's masks
    for name, kwargs in (("sliding", {"window": DEEPLAB_SIZE}),
                         ("ensemble", {"scales": (1.0,), "flip": False})):
        pred = Predictor(image_size=DEEPLAB_SIZE, protocol=name,
                         protocol_kwargs=kwargs, **common)
        same = float((pred.predict(batch) == masks[:BATCH]).mean())
        protocols[name]["plain_case"] = kwargs
        protocols[name]["plain_case_pixel_agreement"] = same
        del pred
    torch.cuda.empty_cache()
    emit({"phase": "deeplab_serving", "model": "deeplabv2-resnet101",
          "image_size": list(DEEPLAB_SIZE), "batch": BATCH,
          "dtype": "bfloat16", "frames": len(frames),
          "p50_ms_per_batch": p50, "fps": BATCH * 1000.0 / p50,
          "forward_argmax_ms": forward_ms,
          "bf16_vs_f32_pixel_agreement": agreement,
          "min_bf16_agreement": MIN_DEEPLAB_BF16_AGREEMENT,
          "f32_cuda_vs_cpu_max_abs_err": cpu_err,
          "f32_cpu_logit_max_abs": cpu_scale, "protocols": protocols})
    if agreement < MIN_DEEPLAB_BF16_AGREEMENT:
        raise AssertionError(f"DeepLab bf16 masks agree with f32 on "
                             f"{agreement:.4%} of pixels, below "
                             f"{MIN_DEEPLAB_BF16_AGREEMENT:.0%}")
    if not cpu_err <= 1e-3 * max(1.0, cpu_scale):
        raise AssertionError(f"DeepLab f32 CUDA logits differ from the "
                             f"CPU's by {cpu_err}")
    for name, r in protocols.items():
        if r["plain_case_pixel_agreement"] != 1.0:
            raise AssertionError(f"the {name} protocol's masks differ from "
                                 f"the plain forward's: {r}")
    return {"p50_ms": p50, "protocols": protocols}


def phase_deeplab_validation(tree: dict) -> dict:
    """``validate`` of DeepLabV2-R101 (f32 weights, bf16 autocast, as the
    trainer validates) under the plain, sliding and ensemble eval steps,
    each a main path of its own; each step's histogram held against the
    plain ``fast_hist``.  Returns K1's launches on each."""
    model = load_flax_variables(DeepLabV2(), tree).cuda().eval()
    bf16 = {"compute_dtype": torch.bfloat16, "return_preds": True}
    steps = {
        "plain": (DEEPLAB_SIZE,
                  make_eval_step(model, CLASSES, **bf16)),
        "sliding": (SIZE, make_sliding_eval_step(
            model, SIZE, CLASSES, window=DEEPLAB_SIZE, **bf16)),
        "ensemble": (DEEPLAB_SIZE, make_ensemble_eval_step(
            model, DEEPLAB_SIZE, CLASSES, scales=DEEPLAB_SCALES, **bf16))}
    report = {}
    for name, (size, step) in steps.items():
        batches = _synthetic_batches(DEEPLAB_VAL_BATCHES, size,
                                     seed=SEED + 11)
        step_ms = []
        checked_step = checked_eval_step(step, step_ms)
        (miou, per_class), launches, _ = on_main_path(
            lambda: validate(model, iter(batches), CLASSES,
                             class_names=CLASS_NAMES,
                             eval_step=checked_step, device="cuda"))
        if not 0.0 <= miou <= 1.0 or len(per_class) != CLASSES:
            raise AssertionError(f"{name}: mIoU {miou}")
        if launches["fast_hist_cuda"] < 1:
            raise AssertionError(f"DeepLab {name} validation never launched "
                                 f"K1")
        report[name] = {"image_size": list(size), "miou": miou,
                        "eval_step_ms": step_ms,
                        "fast_hist_cuda_launches": launches["fast_hist_cuda"]}
        del batches
        torch.cuda.empty_cache()
    emit({"phase": "deeplab_validation", "model": "deeplabv2-resnet101",
          "batches": DEEPLAB_VAL_BATCHES, "batch": BATCH,
          "dtype": "bfloat16 autocast", "protocols": report})
    return {name: r["fast_hist_cuda_launches"] for name, r in report.items()}


def deeplab_config():
    """The default config in bf16 for one epoch of DeepLabV2-R101 training
    (Adam, poly LR, blur + flip, BN affines frozen) and of DA v1 with a
    DeepLabV2-R101 generator and the Tiny discriminator."""
    return load_config(overrides={
        "precision": {"compute_dtype": "bfloat16"},
        "training": {"segmentation": {"epochs": 1, "do_validation": 1},
                     "domain_adaptation": {
                         "epochs": 1, "iterations": DEEPLAB_DA_ITERATIONS,
                         "do_validation": 1}},
        "model": {"adversarial_model": {"generator": {"name": "deeplab"}}}})


def _frozen_still(state, before: list) -> None:
    if not all(torch.equal(p, b) for p, b in zip(state.optimizer.frozen,
                                                  before)):
        raise AssertionError("a frozen BN affine parameter moved")


def phase_deeplab_training() -> dict:
    """DeepLabV2-R101 supervised training through the port's entry points
    (one epoch of DEEPLAB_TRAIN_STEPS steps at 720x1280 b8 bf16 on
    colour-coded labels, K2 in the transform, K1 in the validation at
    512x1024); every K2 output checked, the frozen BN affines unmoved, the
    checkpoint restored, one float64 step on the card held against the
    CPU's at full depth, and the step timed through ``train_bench`` with
    remat off and on and with ``bn_eval``."""
    dev = torch.device("cuda")
    tmp = tempfile.TemporaryDirectory(prefix="rtsds_smoke_dl_")
    config = deeplab_config()
    loader, transform = _gta5_stream(DEEPLAB_TRAIN_STEPS * TRAIN_BATCH,
                                     SEED + 12)
    state = build_supervised(config, "deeplab", len(loader), dev, seed=SEED)
    frozen_before = [p.detach().clone() for p in state.optimizer.frozen]
    recorder = _LossRecorder()
    checkpoint = ModelCheckpoint(save_dir=tmp.name, save_name="smoke_dl",
                                 save_best=False)
    val_batches = _val_stream()
    t0 = time.perf_counter()
    (_, history), launches, checked = on_main_path(
        lambda: supervised_fit(
            state, make_train_step(19),
            lambda epoch: device_batches(loader, transform, dev, seed=SEED,
                                         epoch=epoch),
            val_batches, epochs=1, num_classes=CLASSES,
            class_names=CLASS_NAMES, callbacks=[recorder],
            checkpoint=checkpoint, device=dev))
    fit_s = time.perf_counter() - t0
    if len(recorder.losses) != DEEPLAB_TRAIN_STEPS or not all(
            math.isfinite(x) for x in recorder.losses):
        raise AssertionError(f"DeepLab train losses {recorder.losses}")
    if checked != DEEPLAB_TRAIN_STEPS:
        raise AssertionError(f"{checked} K2 calls checked")
    if len(history) != 1 or not 0.0 <= history[0]["validation_mIoU"] <= 1.0:
        raise AssertionError(f"history {history}")
    _frozen_still(state, frozen_before)

    host_images, host_rgb = next(iter(loader))
    images, labels = transform(torch.from_numpy(host_images).to(dev),
                               torch.from_numpy(host_rgb).to(dev),
                               batch_generator(SEED, 0, 0))
    val_images, _ = next(iter(val_batches(0)))
    fresh = build_supervised(config, "deeplab", len(loader), dev,
                             seed=SEED + 9)
    if not checkpoint.manager.restore({"model": fresh}):
        raise AssertionError("DeepLab checkpoint restore failed")
    with torch.inference_mode(), state.autocast():
        want = state.model.eval()(val_images.permute(0, 3, 1, 2))
        got = fresh.model.eval()(val_images.permute(0, 3, 1, 2))
    restore_err = float((got - want).abs().max())
    if fresh.step != state.step or restore_err > 1e-5 * max(
            1.0, float(want.abs().max())):
        raise AssertionError(f"restored DeepLab: step {fresh.step}, logits "
                             f"differ by {restore_err}")
    del want, got, fresh, val_images
    tmp.cleanup()
    torch.cuda.empty_cache()

    step_check = step_card_vs_cpu(torch.float64, 2, "deeplab", (64, 96))
    split = train_step_split(state, images, labels, reps=4)
    torch.cuda.empty_cache()
    bench = {}
    for name, kwargs in (("plain", {}), ("remat", {"remat": True}),
                         ("bn_eval", {"bn_eval": True})):
        bench[name] = supervised_step_benchmark(
            "deeplab", batch_size=TRAIN_BATCH, image_size=TRAIN_SIZE,
            steps=DEEPLAB_BENCH_STEPS, repeats=3, seed=SEED, **kwargs)
        torch.cuda.empty_cache()
        if not math.isfinite(bench[name]["last_train_loss"]):
            raise AssertionError(f"DeepLab bench {name}: {bench[name]}")
    emit({"phase": "deeplab_training", "model": "deeplabv2-resnet101",
          "image_size": list(TRAIN_SIZE), "batch": TRAIN_BATCH,
          "dtype": "bfloat16", "steps": DEEPLAB_TRAIN_STEPS,
          "losses": recorder.losses, "history": history, "fit_s": fit_s,
          "k2_outputs_checked": checked, "launches": launches,
          "frozen_bn_tensors": len(frozen_before),
          "restore_max_abs_err": restore_err,
          "step_card_vs_cpu_float64": step_check,
          "train_step_split_ms": split,
          **{f"{k}_ms_per_step": b["ms_per_step"] for k, b in bench.items()},
          **{f"{k}_samples_per_s": b["samples_per_sec"]
             for k, b in bench.items()},
          **{f"{k}_max_memory_gb": b["max_memory_gb"]
             for k, b in bench.items()},
          "bench": bench})
    return {"launches": launches, "state": state, "batch": (images, labels)}


def phase_deeplab_da() -> dict:
    """DA v1 with a DeepLabV2-R101 generator and the Tiny discriminator
    through the port's entry points (source 720x1280 colour-coded with K2
    in its transform, target 512x1024, b8 bf16, one epoch of
    DEEPLAB_DA_ITERATIONS steps, K1 in the validation); every loss finite,
    every K2 output checked, the frozen BN affines unmoved; the step timed
    with its peak memory (``da_bench``); one float64 v1 step on the card
    held against the CPU's."""
    dev = torch.device("cuda")
    config = deeplab_config()
    n = DEEPLAB_DA_ITERATIONS * TRAIN_BATCH
    src_loader, src_transform = _gta5_stream(n, SEED + 13, infinite=True)
    tgt_loader, tgt_transform = _target_stream(n, SEED + 14)
    gen, dis = build_adversarial(config, dev, seed=SEED)
    frozen_before = [p.detach().clone() for p in gen.optimizer.frozen]
    tcfg = config.training["domain_adaptation"]
    step = make_adversarial_step(float(tcfg["lambda"]),
                                 DEEPLAB_DA_ITERATIONS, 1, 19, "v1")
    recorder = _DALossRecorder()
    source_iter = device_batches(src_loader, src_transform, dev, seed=SEED)
    target_iter = device_batches(tgt_loader, tgt_transform, dev)
    with contextlib.closing(source_iter), contextlib.closing(target_iter):
        t0 = time.perf_counter()
        (_, _, history), launches, checked = on_main_path(
            lambda: adversarial_fit(
                gen, dis, step, source_iter, target_iter, _val_stream(),
                iterations=DEEPLAB_DA_ITERATIONS, epochs=1,
                num_classes=CLASSES, class_names=CLASS_NAMES,
                callbacks=[recorder], device=dev))
        fit_s = time.perf_counter() - t0
    check_da_losses(recorder.losses, DEEPLAB_DA_ITERATIONS)
    if checked != DEEPLAB_DA_ITERATIONS:
        raise AssertionError(f"{checked} K2 calls checked")
    if len(history) != 1 or not 0.0 <= history[0]["validation_mIoU"] <= 1.0:
        raise AssertionError(f"history {history}")
    _frozen_still(gen, frozen_before)
    del gen, dis
    torch.cuda.empty_cache()

    bench = da_step_benchmark(
        batch_size=TRAIN_BATCH, src_hw=TRAIN_SIZE, tgt_hw=DA_TGT_SIZE,
        steps=DEEPLAB_BENCH_STEPS, repeats=3, dtype=torch.bfloat16,
        variant="v1", seed=SEED, generator="deeplab")
    torch.cuda.empty_cache()
    if not math.isfinite(bench["last_loss_gen_source"]):
        raise AssertionError(f"DeepLab DA bench: {bench}")
    step_check = da_step_card_vs_cpu("v1", generator="deeplab")
    emit({"phase": "deeplab_da", "generator": "deeplabv2-resnet101",
          "discriminator": "tiny", "source_size": list(TRAIN_SIZE),
          "target_size": list(DA_TGT_SIZE), "batch": TRAIN_BATCH,
          "dtype": "bfloat16", "variant": "v1", "epochs": 1,
          "iterations": DEEPLAB_DA_ITERATIONS, "losses": recorder.losses,
          "history": history, "fit_s": fit_s, "k2_outputs_checked": checked,
          "launches": launches, "frozen_bn_tensors": len(frozen_before),
          "v1_ms_per_step": bench["ms_per_step"],
          "v1_steps_per_sec": bench["steps_per_sec"],
          "v1_split_ms": bench["split_ms"],
          "max_memory_gb": bench["max_memory_gb"],
          "step_card_vs_cpu_float64": step_check, "bench": bench})
    return {"launches": launches}


def _extras_config(**training):
    """The default config in bf16 with ``training`` merged in."""
    return load_config(overrides={
        "precision": {"compute_dtype": "bfloat16"}, "training": training})


def _peak_gb(run) -> float:
    """The peak device memory allocated while ``run()`` runs, in GB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def phase_ema_accumulate() -> dict:
    """Supervised BiSeNet-R18 through ``supervised_fit`` with an EMA (decay
    0.999) and gradient accumulation over 2 micro-batches of 4, one epoch of
    TRAIN_STEPS steps at 720x1280 b8 bf16 on colour-coded labels (K2),
    validated on the EMA at 512x1024 (K1); the saved ``ema`` item restored
    exactly by ``resume``, the step and the EMA update timed, one float64
    accumulated step at b4 (micro 2) on the card held against the CPU's.
    Returns the launches and the run's checkpoint directory (``tmp``, a
    ``TemporaryDirectory`` the caller cleans up), which the
    serving_checkpoint phase serves."""
    from rtsds_tpu_torch.train.accumulate import (
        make_accumulating_train_step, split_microbatches)
    from rtsds_tpu_torch.train.ema import ema_update, setup_ema
    from rtsds_tpu_torch.train.loop import on_ema

    dev = torch.device("cuda")
    tmp = tempfile.TemporaryDirectory(prefix="rtsds_smoke_ema_")
    k = 2
    config = _extras_config(segmentation={
        "epochs": 1, "do_validation": 1, "accumulate_steps": k,
        "ema": {"enabled": True, "decay": 0.999}})
    loader, transform = _gta5_stream(TRAIN_STEPS * TRAIN_BATCH, SEED + 16)
    val_batches = _val_stream()
    state = build_supervised(config, "bisenet", len(loader), dev, seed=SEED)
    acc = make_accumulating_train_step(19)

    def step(st, images, labels):
        return acc(st, split_microbatches(images, k),
                   split_microbatches(labels, k))

    recorder = _LossRecorder()
    checkpoint = ModelCheckpoint(save_dir=tmp.name, save_name="smoke_ema",
                                 save_best=False)
    (_, history), launches, checked = on_main_path(
        lambda: supervised_fit(
            state, step,
            lambda epoch: device_batches(loader, transform, dev, seed=SEED,
                                         epoch=epoch),
            val_batches, epochs=1, num_classes=CLASSES,
            class_names=CLASS_NAMES, callbacks=[recorder],
            checkpoint=checkpoint, device=dev, ema_decay=0.999))
    if len(recorder.losses) != TRAIN_STEPS or not all(
            math.isfinite(x) for x in recorder.losses):
        raise AssertionError(f"EMA/accumulation losses {recorder.losses}")
    if checked != TRAIN_STEPS or state.step != TRAIN_STEPS:
        raise AssertionError(f"{checked} K2 calls checked, step {state.step}")
    bn_counts = {int(v) for key, v in state.model.state_dict().items()
                 if key.endswith("num_batches_tracked")}
    if bn_counts != {k * TRAIN_STEPS}:
        raise AssertionError(f"BN counts {bn_counts}, want {k * TRAIN_STEPS}")

    # --resume's round trip: the stored EMA restored exactly into fresh
    # states, and validated again on the restored model's BN statistics
    saved = checkpoint.manager.load(checkpoint.manager.latest_step())
    fresh = build_supervised(config, "bisenet", len(loader), dev,
                             seed=SEED + 9)
    template = setup_ema(fresh.model)
    restored, start = ModelCheckpoint(
        save_dir=tmp.name, save_name="smoke_ema").resume(
            {"model": fresh, "ema": template}, optional=("ema",))
    if start != 1 or "ema" not in restored:
        raise AssertionError(f"EMA resume: start {start}, {sorted(restored)}")
    ema_mismatch = [key for key, v in saved["ema"]["params"].items()
                    if not torch.equal(template.params[key].cpu(), v)]
    if ema_mismatch or all(torch.equal(saved["ema"]["params"][key], v.cpu())
                           for key, v in fresh.model.named_parameters()):
        raise AssertionError(f"EMA not restored exactly: {ema_mismatch[:4]}")
    miou_restored, _ = validate(
        fresh.model, val_batches(0), CLASSES,
        eval_step=on_ema(make_eval_step(fresh.model, CLASSES,
                                        compute_dtype=torch.bfloat16),
                         fresh.model, template), device=dev)
    del fresh, template, saved

    host_images, host_rgb = next(iter(loader))
    images, labels = transform(torch.from_numpy(host_images).to(dev),
                               torch.from_numpy(host_rgb).to(dev),
                               batch_generator(SEED, 0, 0))
    ema = setup_ema(state.model)
    step_ms = cuda_ms(lambda: step(state, images, labels), reps=10)
    plain_step = make_train_step(19)
    plain_ms = cuda_ms(lambda: plain_step(state, images, labels), reps=10)
    ema_ms = cuda_ms(lambda: ema_update(ema.params, state.model, 0.999,
                                        state.step))
    peak = _peak_gb(lambda: step(state, images, labels))
    torch.cuda.empty_cache()
    check = step_card_vs_cpu(torch.float64, 4, accumulate_steps=2)
    result = {"phase": "ema_accumulate", "model": "bisenet-resnet18",
              "image_size": list(TRAIN_SIZE), "batch": TRAIN_BATCH,
              "accumulate_steps": k, "micro_batch": TRAIN_BATCH // k,
              "ema_decay": 0.999, "dtype": "bfloat16",
              "steps": TRAIN_STEPS, "losses": recorder.losses,
              "history": history, "k2_outputs_checked": checked,
              "launches": launches,
              "validation_mIoU_on_ema": history[0]["validation_mIoU"],
              "validation_mIoU_on_restored_ema": miou_restored,
              "step_p50_ms": step_ms, "plain_b8_step_p50_ms": plain_ms,
              "ema_update_ms": ema_ms, "max_memory_gb": peak,
              "step_card_vs_cpu_float64": check}
    emit(result)
    if abs(miou_restored - history[0]["validation_mIoU"]) > 1e-3:
        raise AssertionError("the restored EMA validates differently")
    return {"launches": launches, "tmp": tmp,
            "checkpoint": checkpoint.manager.save_dir}


def _da_fit(config, make_step, seed: int, iterations: int = DA_ITERATIONS,
            **fit_kwargs) -> tuple:
    """One epoch of ``iterations`` DA steps of a fresh BiSeNet-R18 and Tiny
    discriminator (``config``'s) through ``adversarial_fit`` as a main path,
    the step ``make_step(generator state)``: colour-coded GTA5 source (K2),
    Cityscapes-sized target, validation at 512x1024 (K1).  Returns
    ``(history, launches, K2 outputs checked, losses, fit seconds)``."""
    dev = torch.device("cuda")
    n = iterations * TRAIN_BATCH
    src_loader, src_transform = _gta5_stream(n, seed, infinite=True)
    tgt_loader, tgt_transform = _target_stream(n, seed + 1)
    gen, dis = build_adversarial(config, dev, seed=SEED)
    step = make_step(gen)
    recorder = _DALossRecorder()
    source_iter = device_batches(src_loader, src_transform, dev, seed=SEED)
    target_iter = device_batches(tgt_loader, tgt_transform, dev)
    with contextlib.closing(source_iter), contextlib.closing(target_iter):
        t0 = time.perf_counter()
        (_, _, history), launches, checked = on_main_path(
            lambda: adversarial_fit(
                gen, dis, step, source_iter, target_iter, _val_stream(),
                iterations=iterations, epochs=1, num_classes=CLASSES,
                class_names=CLASS_NAMES, callbacks=[recorder], device=dev,
                **fit_kwargs))
        fit_s = time.perf_counter() - t0
    if checked != iterations:
        raise AssertionError(f"{checked} K2 calls checked")
    if len(history) != 1 or not 0.0 <= history[0]["validation_mIoU"] <= 1.0:
        raise AssertionError(f"history {history}")
    return history, launches, checked, recorder.losses, fit_s


def _bench_summary(b: dict) -> dict:
    return {"p50_ms": b["ms_per_step"], "steps_per_sec": b["steps_per_sec"],
            "max_memory_gb": b["max_memory_gb"], "fda_ms": b["fda_ms"]}


def phase_da_minent_fda() -> dict:
    """BiSeNet DA v1 and v2 with MinEnt (lambda 0.005) and FDA (beta 0.01)
    through ``adversarial_fit``, an epoch of DA_ITERATIONS steps each;
    both steps timed with their peak memory and FDA's own time on the b8
    batch (``da_bench``); one float64 v1 step with both extras (FDA at
    beta 0.05, whose window is empty at 64x96 below 1/64) on the card held
    against the CPU's.  Returns the launches of each path."""
    lambda_ent, fda_beta = 0.005, 0.01
    report, paths = {}, {}
    for variant in ("v1", "v2"):
        config = _extras_config(domain_adaptation={
            "epochs": 1, "iterations": DA_ITERATIONS, "do_validation": 1,
            "variant": variant,
            "entropy_min": {"enabled": True, "lambda": lambda_ent},
            "fda": {"enabled": True, "beta": fda_beta}})
        step = make_adversarial_step(
            float(config.training["domain_adaptation"]["lambda"]),
            DA_ITERATIONS, 1, 19, variant, lambda_ent=lambda_ent,
            fda_beta=fda_beta)
        history, launches, checked, losses, fit_s = _da_fit(
            config, lambda gen: step, SEED + 17 + (variant == "v2"))
        keys = V1_LOSS_KEYS + ("loss_entropy",) + (
            ("loss_gen_total", "loss_disc_total") if variant == "v2" else ())
        check_da_losses(losses, DA_ITERATIONS, keys)
        torch.cuda.empty_cache()
        bench = da_step_benchmark(
            batch_size=TRAIN_BATCH, src_hw=TRAIN_SIZE, tgt_hw=DA_TGT_SIZE,
            steps=DA_BENCH_STEPS, repeats=DA_BENCH_REPEATS,
            dtype=torch.bfloat16, variant=variant, seed=SEED,
            lambda_ent=lambda_ent, fda_beta=fda_beta)
        torch.cuda.empty_cache()
        if not math.isfinite(bench["last_loss_gen_source"]):
            raise AssertionError(f"DA bench {variant}: {bench}")
        report[variant] = {"history": history, "fit_s": fit_s,
                           "losses": losses, "k2_outputs_checked": checked,
                           "launches": launches, **_bench_summary(bench)}
        paths[variant] = launches
    check = da_step_card_vs_cpu("v1", lambda_ent=lambda_ent, fda_beta=0.05)
    emit({"phase": "da_minent_fda", "generator": "bisenet-resnet18",
          "discriminator": "tiny", "source_size": list(TRAIN_SIZE),
          "target_size": list(DA_TGT_SIZE), "batch": TRAIN_BATCH,
          "dtype": "bfloat16", "lambda_ent": lambda_ent,
          "fda_beta": fda_beta, "iterations": DA_ITERATIONS, **report,
          "step_card_vs_cpu_float64": check})
    return paths


def phase_self_training() -> dict:
    """The mean-teacher self-training step (v1, EMA 0.999, ClassMix, CBST
    thresholds calibrated over 2 target batches on the generator as it
    starts) through ``adversarial_fit`` with ``ema_in_step``, an epoch of
    DA_ITERATIONS steps at full width; the step timed with its peak memory
    (``da_bench``); one float64 step on the card, ClassMix scores drawn on
    the CPU, held against the CPU's, EMA included.  Returns the
    launches."""
    from rtsds_tpu_torch.train.self_training import (
        calibrate_class_thresholds, make_self_training_step)

    config = _extras_config(domain_adaptation={
        "epochs": 1, "iterations": DA_ITERATIONS, "do_validation": 1,
        "ema": {"enabled": True, "decay": 0.999},
        "self_training": {"enabled": True, "classmix": {"enabled": True},
                          "calibration": {"enabled": True, "portion": 0.5,
                                          "batches": 2}}})
    calibrated = {}

    def build(gen):
        # the target batches the calibration reads come from a stream of
        # their own, so that the training stream starts where it would
        cal_loader, cal_transform = _target_stream(2 * TRAIN_BATCH, SEED + 21)
        cal = device_batches(cal_loader, cal_transform, gen.device)
        with contextlib.closing(cal):
            thr = calibrate_class_thresholds(
                gen.model, [next(cal) for _ in range(2)], CLASSES,
                portion=0.5, compute_dtype=gen.compute_dtype)
        calibrated["thresholds"] = [float(t) for t in thr]
        return make_self_training_step(
            float(config.training["domain_adaptation"]["lambda"]),
            DA_ITERATIONS, 19, threshold=thr, ema_decay=0.999,
            classmix=True, classmix_seed=SEED)

    history, launches, checked, losses, fit_s = _da_fit(
        config, build, SEED + 19, ema_in_step=True)
    keys = V1_LOSS_KEYS + ("loss_pseudo", "pl_coverage", "mix_coverage")
    check_da_losses(losses, DA_ITERATIONS, keys)
    torch.cuda.empty_cache()
    bench = da_step_benchmark(
        batch_size=TRAIN_BATCH, src_hw=TRAIN_SIZE, tgt_hw=DA_TGT_SIZE,
        steps=DA_BENCH_STEPS, repeats=DA_BENCH_REPEATS, dtype=torch.bfloat16,
        seed=SEED, self_training=True, classmix=True)
    torch.cuda.empty_cache()
    if not math.isfinite(bench["last_loss_gen_source"]):
        raise AssertionError(f"self-training bench: {bench}")
    check = da_step_card_vs_cpu(self_training=True)
    emit({"phase": "self_training", "generator": "bisenet-resnet18",
          "discriminator": "tiny", "source_size": list(TRAIN_SIZE),
          "target_size": list(DA_TGT_SIZE), "batch": TRAIN_BATCH,
          "dtype": "bfloat16", "ema_decay": 0.999, "classmix": True,
          "calibration_batches": 2, **calibrated,
          "iterations": DA_ITERATIONS, "history": history, "fit_s": fit_s,
          "losses": losses,
          "pl_coverage": [row["pl_coverage"] for row in losses],
          "mix_coverage": [row["mix_coverage"] for row in losses],
          "k2_outputs_checked": checked, "launches": launches,
          **_bench_summary(bench), "step_card_vs_cpu_float64": check})
    return launches


def phase_distillation() -> dict:
    """A DeepLabV2-R101 teacher checkpoint written by the port from seeded
    weights, its ``ema`` item made from another seed; ``load_teacher``
    reads it back, and the distillation loss shows that the ``ema`` item
    was taken.  BiSeNet-R18 distils from it through ``supervised_fit``, an
    epoch of TRAIN_STEPS steps at 720x1280 b8 bf16 on colour-coded labels
    (K2), validated at 512x1024 (K1); the step and the teacher's forward
    timed (``train_bench --distill deeplab``) with the peak memory; one
    float64 step on the card held against the CPU's.  Returns the
    launches."""
    from rtsds_tpu_torch.callbacks.checkpoint import CheckpointManager
    from rtsds_tpu_torch.models.pretrained import load_segmentor_state
    from rtsds_tpu_torch.train.distill import (
        distillation_kl, load_teacher, make_distill_step)
    from rtsds_tpu_torch.train.ema import EMA, ema_init

    dev = torch.device("cuda")
    tmp = tempfile.TemporaryDirectory(prefix="rtsds_smoke_kd_")
    config = train_config()
    trained, _ = make_segmentor(config, "deeplab", seed=SEED + 22)
    averaged, _ = make_segmentor(config, "deeplab", seed=SEED + 23)
    CheckpointManager(tmp.name).save(0, {
        "model": TrainState(trained, make_optimizer(
            "SGD", trained.parameters(), 0.01)),
        "ema": EMA(ema_init(averaged))}, monitor=0.5)

    def teacher_from(state):
        model, _ = make_segmentor(config, "deeplab", seed=SEED)
        return load_segmentor_state(model, state).to(dev).eval()

    teacher = teacher_from(load_teacher(tmp.name))
    raw = teacher_from(load_teacher(tmp.name, use_ema=False))
    direct = teacher_from({**trained.state_dict(), **ema_init(averaged)})
    del trained, averaged
    tmp.cleanup()
    val_images, _ = next(iter(_val_stream()(0)))
    x = val_images.permute(0, 3, 1, 2)
    with torch.inference_mode(), torch.autocast("cuda", torch.bfloat16):
        student_out = BiSeNet().to(dev).eval()(x)
        kd = {name: float(distillation_kl(student_out, t(x)))
              for name, t in (("loaded", teacher), ("ema_weights", direct),
                              ("model_weights", raw))}
    del raw, direct, student_out, x
    # the same weights give the same loss up to the order of the card's
    # sums; the trained weights another
    if not (abs(kd["loaded"] - kd["ema_weights"]) <= 1e-6 * kd["loaded"]
            < 1e-3 * abs(kd["loaded"] - kd["model_weights"])):
        raise AssertionError(f"load_teacher did not take the ema item: {kd}")

    loader, transform = _gta5_stream(TRAIN_STEPS * TRAIN_BATCH, SEED + 24)
    state = build_supervised(config, "bisenet", len(loader), dev, seed=SEED)
    step = make_distill_step(teacher, 19)
    losses = []

    class _KD(Callback):
        def on_batch_end(self, batch, logs=None):
            losses.append({k: logs[k] for k in ("train_loss", "loss_ce",
                                                "loss_distill")})

    (_, history), launches, checked = on_main_path(
        lambda: supervised_fit(
            state, step,
            lambda epoch: device_batches(loader, transform, dev, seed=SEED,
                                         epoch=epoch),
            _val_stream(), epochs=1, num_classes=CLASSES,
            class_names=CLASS_NAMES, callbacks=[_KD()], device=dev))
    if len(losses) != TRAIN_STEPS or not all(
            math.isfinite(v) for row in losses for v in row.values()):
        raise AssertionError(f"distillation losses {losses}")
    if checked != TRAIN_STEPS or len(history) != 1:
        raise AssertionError(f"{checked} K2 calls checked, {history}")
    del teacher, state, step
    torch.cuda.empty_cache()
    bench = supervised_step_benchmark(
        "bisenet", batch_size=TRAIN_BATCH, image_size=TRAIN_SIZE,
        steps=DA_BENCH_STEPS, repeats=3, seed=SEED, distill="deeplab")
    torch.cuda.empty_cache()
    if not math.isfinite(bench["last_train_loss"]):
        raise AssertionError(f"distillation bench: {bench}")
    check = distill_step_card_vs_cpu()
    emit({"phase": "distillation", "student": "bisenet-resnet18",
          "teacher": "deeplabv2-resnet101", "image_size": list(TRAIN_SIZE),
          "batch": TRAIN_BATCH, "dtype": "bfloat16", "steps": TRAIN_STEPS,
          "teacher_kl_on_val_batch": kd, "losses": losses,
          "history": history, "k2_outputs_checked": checked,
          "launches": launches, "step_p50_ms": bench["ms_per_step"],
          "steps_per_sec": bench["steps_per_sec"],
          "teacher_forward_ms": bench["teacher_forward_ms"],
          "max_memory_gb": bench["max_memory_gb"],
          "step_card_vs_cpu_float64": check})
    return launches


def _post_raw(url: str, frame: np.ndarray) -> np.ndarray:
    """POST one frame's raw bytes to the server; its mask back.  A reply
    other than 200 raises (``urlopen`` raises on 4xx and 5xx)."""
    import urllib.request

    req = urllib.request.Request(
        url, data=frame.tobytes(),
        headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=120) as reply:
        if reply.status != 200:
            raise AssertionError(f"server replied {reply.status}")
        body = reply.read()
    return np.frombuffer(body, np.uint8).reshape(frame.shape[:2])


def _get(url: str) -> bytes:
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as reply:
        if reply.status != 200:
            raise AssertionError(f"{url}: {reply.status}")
        return reply.read()


def serve_over_http(predictor: Predictor, frames: np.ndarray) -> dict:
    """The port's HTTP server (``serve_server.py``) on 127.0.0.1 at an
    ephemeral port, in a thread, over ``predictor``: SERVER_CLIENTS client
    threads each POST REQUESTS_PER_CLIENT raw frames, one after another.
    Every reply is held against ``predict`` of its frame; ``/healthz`` and
    ``/stats`` are read; the server shuts down with nothing in flight."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from rtsds_tpu_torch.serve_server import MicroBatcher, make_http_server

    batcher = MicroBatcher(predictor, max_batch=BATCH, max_wait_ms=5.0)
    server = make_http_server(batcher, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    replies, client_ms = {}, []

    def client(c):
        for j in range(REQUESTS_PER_CLIENT):
            i = (c * REQUESTS_PER_CLIENT + j) % len(frames)
            t0 = time.perf_counter()
            replies[c, j] = (i, _post_raw(f"{base}/predict", frames[i]))
            client_ms.append((time.perf_counter() - t0) * 1e3)

    try:
        if _get(f"{base}/healthz") != b"ok":
            raise AssertionError("/healthz did not answer ok")
        t0 = time.perf_counter()
        with ThreadPoolExecutor(SERVER_CLIENTS) as pool:
            for fut in [pool.submit(client, c)
                        for c in range(SERVER_CLIENTS)]:
                fut.result(timeout=600)
        wall_s = time.perf_counter() - t0
        stats = json.loads(_get(f"{base}/stats"))
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=60)
    n = SERVER_CLIENTS * REQUESTS_PER_CLIENT
    wrong = [key for key, (i, mask) in replies.items()
             if not np.array_equal(mask, predictor.predict(frames[i]))]
    result = {"clients": SERVER_CLIENTS,
              "requests_per_client": REQUESTS_PER_CLIENT,
              "replies": len(replies), "replies_not_equal_predict": wrong,
              "requests_per_s": n / wall_s,
              "client_p50_ms": statistics.median(client_ms),
              "client_max_ms": max(client_ms), "stats": stats,
              "server_thread_alive": thread.is_alive()}
    if len(replies) != n or wrong:
        raise AssertionError(f"server replies: {result}")
    if (stats["requests"] != n or stats["errors"] or stats["queued"]
            or stats["latency_p50_ms"] is None
            or not 1 <= stats["batches"] < n):
        raise AssertionError(f"server stats: {stats}")
    if thread.is_alive():
        raise AssertionError("the server thread did not stop")
    return result


def phase_serving_checkpoint(ckpt_dir: str, frames: np.ndarray) -> dict:
    """Serving a trained checkpoint, as a user would: the ema_accumulate
    phase's checkpoint (BiSeNet-R18 trained on colour-coded labels through
    K2, with an ``ema`` item) served by ``Predictor.from_checkpoint`` at
    1024x2048 b8 bf16; the served weights held against ``load_teacher``'s
    EMA tensors (and away from the raw ones); ``predict_iter`` over 3
    batches (the last one short) held exactly against ``predict`` and both
    timed per batch; the HTTP server answering 16 raw requests from 4
    client threads (:func:`serve_over_http`); and ``validate`` of the
    served model at 512x1024 (K1).  Returns the path's launches."""
    from rtsds_tpu_torch.train.distill import load_teacher

    def run():
        predictor = Predictor.from_checkpoint(
            ckpt_dir, image_size=SIZE, batch_size=BATCH,
            device="cuda").warmup()
        ema, raw = load_teacher(ckpt_dir), load_teacher(ckpt_dir,
                                                        use_ema=False)
        served = predictor.model.state_dict()
        if set(served) != set(ema):
            raise AssertionError("served and checkpoint keys differ")
        off = [k for k, v in served.items()
               if not torch.equal(v.cpu(), ema[k].to(v.dtype))]
        from_raw = sum(not torch.equal(v.cpu(), raw[k].to(v.dtype))
                       for k, v in served.items())
        if off or not from_raw:
            raise AssertionError(f"served weights are not the EMA's: "
                                 f"{off[:4]}, {from_raw} differ from raw")

        batches = [frames[:BATCH], frames[BATCH:2 * BATCH], frames[:5]]
        want = [predictor.predict(b) for b in batches]
        got = list(predictor.predict_iter(iter(batches)))
        if len(got) != 3 or not all(np.array_equal(g, w)
                                    for g, w in zip(got, want)):
            raise AssertionError("predict_iter != predict")
        stream = [batches[i % 2] for i in range(STREAM_BATCHES)]
        per_batch = {"predict": [], "predict_iter": []}
        for name in ("predict", "predict_iter", "predict_iter", "predict"):
            t0 = time.perf_counter()
            if name == "predict":
                for b in stream:
                    predictor.predict(b)
            else:
                for _ in predictor.predict_iter(stream):
                    pass
            per_batch[name].append(
                (time.perf_counter() - t0) / len(stream) * 1e3)

        http = serve_over_http(predictor, frames)

        val = _synthetic_batches(TRAIN_VAL_BATCHES, TRAIN_VAL_SIZE,
                                 seed=SEED + 30)
        step_ms = []
        miou, per_class = validate(
            predictor.model, iter(val), CLASSES, class_names=CLASS_NAMES,
            eval_step=checked_eval_step(make_eval_step(
                predictor.model, CLASSES, return_preds=True), step_ms),
            device="cuda")
        if not 0.0 <= miou <= 1.0 or len(per_class) != CLASSES:
            raise AssertionError(f"mIoU {miou}, {len(per_class)} classes")
        return {"served_tensors": len(served),
                "tensors_differing_from_raw": from_raw,
                "predict_iter_equals_predict": True,
                "stream_batches": STREAM_BATCHES,
                "predict_ms_per_batch": per_batch["predict"],
                "predict_iter_ms_per_batch": per_batch["predict_iter"],
                "http": http, "validation_image_size": list(TRAIN_VAL_SIZE),
                "validation_mIoU": miou, "eval_step_ms": step_ms}

    out, launches, _ = on_main_path(run)
    torch.cuda.empty_cache()
    emit({"phase": "serving_checkpoint", "model": "bisenet-resnet18",
          "checkpoint": "ema_accumulate's (ema item)",
          "image_size": list(SIZE), "batch": BATCH, "dtype": "bfloat16",
          **out, "launches": launches})
    return launches


def phase_benches() -> None:
    """The port's benches on the card, each printing its own line: the
    latency sweep of BiSeNet-R18 serving at 1024x2048 over SWEEP_BATCHES
    and DeepLabV2-R101 at 512x1024 b8 (LATENCY_SAMPLES per-call samples
    each, inputs on the card), the sliding and ensemble benches at their
    defaults, ``model_flops`` of both models, and the one-line bench run
    as ``python -m rtsds_tpu_torch.bench`` in a subprocess with few
    iterations."""
    from rtsds_tpu_torch.bench.ensemble_bench import bench_ensemble
    from rtsds_tpu_torch.bench.flops import model_flops
    from rtsds_tpu_torch.bench.latency import (
        bisenet_inference_benchmark, deeplab_inference_benchmark)
    from rtsds_tpu_torch.bench.sliding_bench import bench_sliding

    keys = ("batch_size", "samples", "mean_ms", "p50_ms", "p99_ms", "fps",
            "flops_per_image", "mfu")
    sweep = []
    for batch in SWEEP_BATCHES:
        stats = bisenet_inference_benchmark(
            SIZE, batch, iterations=LATENCY_SAMPLES)
        sweep.append({k: stats[k] for k in keys})
        torch.cuda.empty_cache()
    emit({"phase": "latency_sweep", "model": "bisenet-resnet18",
          "image_size": list(SIZE), "dtype": "bfloat16",
          "mode": "masks (forward + argmax, inputs on the card)",
          "sweep": sweep})
    dl = deeplab_inference_benchmark(DEEPLAB_SIZE, BATCH,
                                     iterations=LATENCY_SAMPLES)
    torch.cuda.empty_cache()
    emit({"phase": "deeplab_latency", "model": "deeplabv2-resnet101",
          "image_size": list(DEEPLAB_SIZE), "dtype": "bfloat16",
          **{k: dl[k] for k in keys}})
    sliding = bench_sliding(iterations=PROTOCOL_BENCH_ITERS)
    torch.cuda.empty_cache()
    ensemble = bench_ensemble(iterations=PROTOCOL_BENCH_ITERS)
    torch.cuda.empty_cache()
    emit({"phase": "protocol_benches", "sliding": sliding,
          "ensemble": ensemble})
    emit({"phase": "model_flops",
          "bisenet_1x1024x2048": model_flops(
              BiSeNet(num_classes=CLASSES), (1, *SIZE, 3)),
          "deeplab_1x512x1024": model_flops(
              DeepLabV2(num_classes=CLASSES), (1, *DEEPLAB_SIZE, 3))})
    env = {**os.environ, "BENCH_ITERS": str(ONE_LINE_ITERS),
           "BENCH_REPEATS": "1", "BENCH_DA_STEPS": "2"}
    proc = subprocess.run([sys.executable, "-m", "rtsds_tpu_torch.bench"],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the one-line bench exited "
                             f"{proc.returncode}: {proc.stderr[-4000:]}")
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    missing = {"metric", "value", "unit", "p50_ms", "p50_ms_per_image",
               "p99_ms", "batch_size", "dtype", "flops_per_image", "mfu",
               "device", "da_training", "models"} - set(record)
    if missing or any(k.startswith("vs_baseline") for k in record):
        raise AssertionError(f"one-line bench keys: missing {missing}, "
                             f"got {sorted(record)}")
    if not record["value"] > 0:
        raise AssertionError(f"one-line bench: {record}")
    emit({"phase": "one_line_bench", "env": {
        k: env[k] for k in ("BENCH_ITERS", "BENCH_REPEATS",
                            "BENCH_DA_STEPS")}, "record": record})


def quantized_conv_calls(model_name: str, state: dict,
                         size: tuple[int, int], policy) -> dict:
    """The distinct convs that ``policy`` quantizes in a forward of
    ``model_name`` at BATCH x ``size``, traced on the ``meta`` device
    (shapes only): ``{(input shape, OIHW kernel shape, stride, padding,
    dilation): [conv names]}``."""
    q = int8_model_module(model_name)
    folded = folded_on(q.fold(state), "meta")
    calls: dict = {}

    def op(name, x, stride, padding, dilation):
        kernel, bias = folded[name]
        if policy(name, tuple(kernel.shape)):
            calls.setdefault((tuple(x.shape), tuple(kernel.shape), stride,
                              padding, dilation), []).append(name)
        return conv_bf16(x, kernel, bias, stride, padding, dilation)

    with torch.no_grad():
        q.make_walk(folded)(op, torch.empty((BATCH, 3, *size), device="meta",
                                            dtype=torch.bfloat16))
    return calls


def phase_int8_ops(bisenet_state: dict, deeplab_state: dict) -> dict:
    """The int8 conv (``ops/quant.py:conv_int8``: im2col + ``_int_mm``) on
    the card against a float64 ``F.conv2d`` on the card, for every distinct
    quantized conv of both default policies at full width (BiSeNet-R18
    1024x2048 b8, DeepLabV2-R101 512x1024 b8), plus the shapes that the
    GEMM's rules make it pad (a pooled gate at 8 rows with K = N = 19, the
    3-channel stems at K = 27 and 147): the int32 results must be equal.
    Then ``quantize_kernel``, ``quantize_act``, ``fold_bn`` and the whole
    BiSeNet fold on the card against the CPU, exactly."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    calls = {}
    for model_name, state, size in (("bisenet", bisenet_state, SIZE),
                                    ("deeplab", deeplab_state,
                                     DEEPLAB_SIZE)):
        policy = int8_model_module(model_name).default_policy
        for key, names in quantized_conv_calls(model_name, state, size,
                                               policy).items():
            calls.setdefault(key, []).extend(f"{model_name}:{n}"
                                             for n in names)
    calls[((BATCH, CLASSES, 1, 1), (CLASSES, CLASSES, 1, 1), 1, 0, 1)] = [
        "padded: a pooled gate, M=8 K=N=19"]
    calls[((BATCH, 3, *SIZE), (64, 3, 3, 3), 2, 1, 1)] = [
        "padded: bisenet:spatial_path/convblock1, K=27"]
    calls[((BATCH, 3, *SIZE), (64, 3, 7, 7), 2, 3, 1)] = [
        "padded: bisenet:context_path/conv1, K=147"]
    rows = []
    for (xs, ws, stride, padding, dilation), names in calls.items():
        x_q = torch.randint(-127, 128, xs, generator=gen, device="cuda",
                            dtype=torch.int8)
        w_q = torch.randint(-127, 128, ws, generator=gen, device="cuda",
                            dtype=torch.int8)
        got = conv_int8(x_q, w_q, stride, padding, dilation)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = F.conv2d(x_q.double(), w_q.double(), None, stride, padding,
                        dilation)
        torch.cuda.synchronize()
        f64_s = time.perf_counter() - t0
        equal = torch.equal(got.double(), want)
        rows.append({"input": list(xs), "kernel": list(ws), "stride": stride,
                     "padding": padding, "dilation": dilation,
                     "convs": names, "equal": equal,
                     "int8_ms": cuda_ms(lambda: conv_int8(
                         x_q, w_q, stride, padding, dilation), reps=5),
                     "float64_reference_s": f64_s})
        del x_q, w_q, got, want
    torch.cuda.empty_cache()

    cpu = torch.Generator().manual_seed(SEED + 41)
    kernel = (torch.randn((256, 128, 3, 3), generator=cpu)
              * torch.rand((256, 1, 1, 1), generator=cpu) * 3)
    x = torch.randn((BATCH, 64, 128, 256), generator=cpu) * 3
    stats = [torch.rand(256, generator=cpu) + 0.5,
             torch.randn(256, generator=cpu),
             0.3 * torch.randn(256, generator=cpu),
             torch.rand(256, generator=cpu) + 0.5]
    same = {}
    wq, ws = quantize_kernel(kernel)
    wq_c, ws_c = quantize_kernel(kernel.cuda())
    same["quantize_kernel"] = (torch.equal(wq, wq_c.cpu())
                               and torch.equal(ws, ws_c.cpu()))
    same["quantize_act"] = all(
        torch.equal(quantize_act(x, s), quantize_act(x.cuda(), s).cpu())
        for s in (0.0123456, 1 / 127, 0.0078125))
    kf, bf = fold_bn(kernel, None, *stats)
    kf_c, bf_c = fold_bn(kernel.cuda(), None, *(t.cuda() for t in stats))
    same["fold_bn"] = (torch.equal(kf, kf_c.cpu())
                       and torch.equal(bf, bf_c.cpu()))
    folded = fold_bisenet(bisenet_state)
    folded_c = fold_bisenet({k: v.cuda() for k, v in bisenet_state.items()})
    same["fold_bisenet"] = all(
        torch.equal(k, folded_c[n][0].cpu())
        and (b is None or torch.equal(b, folded_c[n][1].cpu()))
        for n, (k, b) in folded.items())
    emit({"phase": "int8_ops", "route": "torch._int_mm (cuBLASLt int8 "
          "GEMM) over an int8 im2col", "reference": "float64 F.conv2d on "
          "the card", "distinct_convs": len(rows),
          "all_equal": all(r["equal"] for r in rows), "convs": rows,
          "card_equals_cpu": same})
    bad = [r for r in rows if not r["equal"]]
    if bad:
        raise AssertionError(f"int8 convs differ from float64: {bad[:3]}")
    if not all(same.values()):
        raise AssertionError(f"int8 ops on the card != the CPU's: {same}")
    return {"distinct_convs": len(rows)}


def _int8_validation(model: torch.nn.Module, size: tuple[int, int],
                     seed: int) -> tuple:
    """``validate`` of an int8 model over TRAIN_VAL_BATCHES synthetic
    batches at ``size``, each histogram held against the plain one; a
    main path (K1).  Returns ``(mIoU, eval step ms, K1 launches)``."""
    val = _synthetic_batches(TRAIN_VAL_BATCHES, size, seed=seed)
    step_ms = []

    def run():
        return validate(model, iter(val), CLASSES, class_names=CLASS_NAMES,
                        eval_step=checked_eval_step(make_eval_step(
                            model, CLASSES, return_preds=True), step_ms),
                        device="cuda")

    (miou, per_class), launches, _ = on_main_path(run)
    if not 0.0 <= miou <= 1.0 or len(per_class) != CLASSES:
        raise AssertionError(f"int8 mIoU {miou}, {len(per_class)} classes")
    return miou, step_ms, launches["fast_hist_cuda"]


def _tree_on(qtree: dict, device) -> dict:
    return {kind: {name: tuple(None if t is None else t.to(device)
                               for t in entry)
                   for name, entry in qtree[kind].items()}
            for kind in ("q8", "bf16")}


def int8_walk_card_vs_cpu(model_name: str, qtree: dict,
                          x: torch.Tensor) -> dict:
    """The float32 int8 walk of ``qtree`` (``*_int8_apply(out_dtype=
    float32)``) on one full-width frame ``x``, on the card with TF32 off
    and on the CPU on the same tree: fails unless the logits agree within
    INT8_WALK_ATOL_SHARE of their peak and the argmax on at least
    INT8_WALK_MIN_ARGMAX of the pixels.  The CPU's walk is the one the CPU
    tests hold against the JAX package."""
    apply = (bisenet_int8_apply if model_name == "bisenet"
             else deeplab_int8_apply)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False), \
                torch.inference_mode():
            got = apply(qtree, x, out_dtype=torch.float32).cpu()
            t0 = time.perf_counter()
            want = apply(_tree_on(qtree, "cpu"), x.cpu(),
                         out_dtype=torch.float32)
            cpu_s = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    peak = float(want.abs().max())
    result = {"frame": list(x.shape), "logit_peak": peak,
              "max_abs_err_over_peak": float((got - want).abs().max()) / peak,
              "argmax_agreement": float((got.argmax(1) == want.argmax(1))
                                        .float().mean()),
              "cpu_walk_s": cpu_s, "atol_share": INT8_WALK_ATOL_SHARE,
              "min_argmax": INT8_WALK_MIN_ARGMAX}
    if (not math.isfinite(peak)
            or result["max_abs_err_over_peak"] > INT8_WALK_ATOL_SHARE
            or result["argmax_agreement"] < INT8_WALK_MIN_ARGMAX):
        raise AssertionError(f"{model_name} float32 int8 walk on the card "
                             f"differs from the CPU's: {result}")
    return result


def planted_fault_agreement(model: QuantizedSegmentor, x: torch.Tensor,
                            want: np.ndarray) -> float:
    """The share of pixels where ``model`` with every quantized conv's
    dequantization scale doubled (a planted wiring fault) still gives the
    bf16 masks ``want``: what MIN_INT8_AGREEMENT is to stay above."""
    tree = model.qtree
    tree["q8"] = {name: (w_q, 2 * w_scale, x_scale, bias)
                  for name, (w_q, w_scale, x_scale, bias)
                  in tree["q8"].items()}
    broken = QuantizedSegmentor(model._walk, tree)
    with torch.inference_mode():
        masks = broken(x).argmax(dim=1).to(torch.uint8).cpu().numpy()
    return float((masks == want).mean())


def phase_int8_serving(bisenet_tree: dict, frames: np.ndarray,
                       deeplab_tree: dict, dl_frames: np.ndarray) -> dict:
    """``Predictor(quantize="int8")`` for both models at full width, b8:
    calibrated on INT8_CALIB_BATCHES batches with the max and with the
    99.9th-percentile statistic (every conv's scale finite and positive,
    the percentile's at most the max's), masks checked and held against
    the bf16 predictor's (the share of equal pixels, at least
    MIN_INT8_AGREEMENT), ``predict`` p50 and forward + argmax with the
    inputs on the card, int8 against bf16; one frame's float32 int8 walk
    held against the CPU's (:func:`int8_walk_card_vs_cpu`) and a planted
    fault's agreement (:func:`planted_fault_agreement`); ``validate`` of
    each int8 model
    (K1, a main path each); and DeepLab's sliding (1024x2048 in 512x1024
    windows) and ensemble (0.75/1/1.25 + flip) protocols in int8 on the
    same scales, held against their bf16 masks and timed.  Returns the K1
    launches by path."""
    out, launches = {}, {}
    for model_name, tree, size, fr in (
            ("bisenet", bisenet_tree, SIZE, frames),
            ("deeplab", deeplab_tree, DEEPLAB_SIZE, dl_frames)):
        common = {"model_name": model_name, "variables": tree,
                  "image_size": size, "batch_size": BATCH, "device": "cuda"}
        calib = fr[:INT8_CALIB_BATCHES * BATCH]
        batch = fr[:BATCH]
        bf16 = Predictor(**common).warmup()
        want = bf16.predict(batch)
        res = {"calib_frames": len(calib)}
        preds = {}
        for stat in ("max", "percentile"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred = Predictor(quantize="int8", calib_frames=calib,
                             calib_stat=stat, calib_percentile=99.9,
                             **common)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            scales = pred.act_scales
            if not all(math.isfinite(v) and v > 0 for v in scales.values()):
                raise AssertionError(f"{model_name} {stat} scales {scales}")
            masks = pred.predict(batch)
            _masks_ok(masks, (BATCH, *size), f"{model_name} int8 {stat}")
            res[stat] = {"build_and_calibrate_s": build_s,
                         "quantized_convs": len(pred.model.qtree["q8"]),
                         "bf16_convs": len(pred.model.qtree["bf16"]),
                         "int8_vs_bf16_pixel_agreement":
                             float((masks == want).mean())}
            preds[stat] = pred
        over = [n for n, s in preds["percentile"].act_scales.items()
                if s > preds["max"].act_scales[n]]
        if over:
            raise AssertionError(f"{model_name} percentile scales above "
                                 f"the max's: {over[:4]}")
        int8 = preds["max"]
        del preds
        x = normalize(torch.from_numpy(batch).cuda()).permute(0, 3, 1, 2)
        with torch.inference_mode():
            res["forward_argmax_ms"] = {
                "bf16": cuda_ms(lambda: bf16.model(x.to(torch.bfloat16))
                                .argmax(dim=1), reps=10),
                "int8": cuda_ms(lambda: int8.model(x).argmax(dim=1),
                                reps=10)}
        res["predict_p50_ms"] = {
            "bf16": cuda_ms(lambda: bf16.predict(batch), reps=10),
            "int8": cuda_ms(lambda: int8.predict(batch), reps=10)}
        res["f32_walk_card_vs_cpu"] = int8_walk_card_vs_cpu(
            model_name, int8.model.qtree, x[:1])
        res["planted_fault_pixel_agreement"] = planted_fault_agreement(
            int8.model, x, want)
        del x, bf16
        torch.cuda.empty_cache()
        miou, step_ms, k1 = _int8_validation(int8.model, size,
                                             SEED + 42)
        res.update({"validation_mIoU": miou, "eval_step_ms": step_ms})
        launches[f"{model_name}_int8_validation"] = k1
        if model_name == "deeplab":
            res["protocols"] = {}
            for name, psize, kwargs, pf in (
                    ("sliding", SIZE, {"window": DEEPLAB_SIZE},
                     frames[:BATCH]),
                    ("ensemble", DEEPLAB_SIZE, {"scales": DEEPLAB_SCALES},
                     batch)):
                kw = {**common, "image_size": psize, "protocol": name,
                      "protocol_kwargs": kwargs}
                ref = Predictor(**kw).predict(pf)
                torch.cuda.empty_cache()
                q8 = Predictor(quantize="int8", act_scales=int8.act_scales,
                               **kw).warmup()
                masks = q8.predict(pf)
                _masks_ok(masks, (len(pf), *psize), f"deeplab int8 {name}")
                ms = cuda_ms(lambda: q8.predict(pf), reps=5, warmup=1)
                res["protocols"][name] = {
                    "image_size": list(psize), **kwargs,
                    "int8_p50_ms_per_batch": ms,
                    "int8_vs_bf16_pixel_agreement":
                        float((masks == ref).mean())}
                del q8
                torch.cuda.empty_cache()
        out[model_name] = res
        del int8
        torch.cuda.empty_cache()
    emit({"phase": "int8_serving", "image_sizes": {
        "bisenet": list(SIZE), "deeplab": list(DEEPLAB_SIZE)},
        "batch": BATCH, "min_int8_agreement": MIN_INT8_AGREEMENT, **out,
        "launches": launches})
    for model_name, res in out.items():
        worst = min([res[s]["int8_vs_bf16_pixel_agreement"]
                     for s in ("max", "percentile")]
                    + [r["int8_vs_bf16_pixel_agreement"]
                       for r in res.get("protocols", {}).values()])
        if worst < MIN_INT8_AGREEMENT[model_name]:
            raise AssertionError(
                f"{model_name} int8 masks agree with bf16 on {worst:.4%} "
                f"of pixels, below {MIN_INT8_AGREEMENT[model_name]:.0%}")
    return launches


@contextlib.contextmanager
def fake_quant_routing(codes: list, replay: bool = False):
    """``ops/quant.py:fake_quant_act`` records, in call order, the int8
    codes it rounds each activation to; with ``replay`` it takes the codes
    ``codes`` recorded instead, so the step sees another run's activation
    grid.  Yields a dict whose ``flips`` counts the codes that the replay
    overrode."""
    plain = quant.fake_quant_act
    recorded = iter(list(codes)) if replay else None
    seen = {"flips": 0}

    def routed(x, scale):
        xf = x.to(torch.float32)
        s = torch.as_tensor(scale, dtype=torch.float32, device=xf.device)
        own = torch.clamp(torch.round(xf / s), -127, 127)
        if recorded is None:
            codes.append(own.detach().cpu())
            return plain(x, scale)
        q = next(recorded).to(xf.device)
        seen["flips"] += int((own != q).sum())
        dq = q * s
        ste = xf + (dq - xf).detach()
        return torch.where(xf.abs() <= s * 127.0, ste, dq.detach())

    quant.fake_quant_act = routed
    try:
        yield seen
    finally:
        quant.fake_quant_act = plain


def qat_step_card_vs_cpu(state: dict) -> dict:
    """One float32 QAT step (fake-quant BiSeNet-R18 of ``state``, b2,
    64x128, SGD) on the card with TF32 off and on the CPU, from one prep
    (the CPU's fold and scales); fails unless the losses agree to
    QAT_LOSS_RTOL and every parameter's update to QAT_UPDATE_RTOL of its
    tensor's largest update + 1e-6.  The fake-quant forward is not
    continuous: an activation within rounding of a half step takes either
    code, and a 1e-6 relative change of the input moved the loss by 1% on
    the CPU.  So the CPU step takes the card's activation codes and ReLU
    routing (:func:`fake_quant_routing`, :func:`relu_routing`), and fails
    if it overrode more than MAX_QAT_REPLAYED_FLIPS codes and signs."""
    ds = SyntheticSegDataset(2, (64, 128), CLASSES, seed=SEED + 43,
                             fixed_tints=True)
    images = normalize(torch.from_numpy(np.stack([ds[i][0]
                                                  for i in range(2)])))
    labels = torch.from_numpy(np.stack([ds[i][1] for i in range(2)]))
    prep = prepare_qat("bisenet", state, [images.permute(0, 3, 1, 2)],
                       device="cpu")
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    states, metrics, before = {}, {}, None
    codes, masks, flips = [], [], {}
    try:
        for dev in ("cuda", "cpu"):
            p = prep._replace(folded=folded_on(prep.folded, dev))
            states[dev] = create_qat_state(p, 0.01, "SGD")
            before = {k: v.detach().clone().cpu() for k, v in
                      states[dev].model.named_parameters()}
            replay = dev == "cpu"
            with fake_quant_routing(codes, replay) as fq, \
                    relu_routing(masks, replay) as relu:
                metrics[dev] = make_train_step(19)(
                    states[dev], images.to(dev), labels.to(dev))
            flips = {"fake_quant_codes": fq["flips"],
                     "relu_signs": relu["flips"]}
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags
    loss = {d: float(m["train_loss"]) for d, m in metrics.items()}
    loss_err = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    gpu = dict(states["cuda"].model.named_parameters())
    worst, over = 0.0, []
    for k, p in states["cpu"].model.named_parameters():
        upd = p.detach() - before[k]
        err = (gpu[k].detach().cpu() - p.detach()).abs().max()
        limit = QAT_UPDATE_RTOL * upd.abs().max() + 1e-6
        ratio = float(err / limit)
        worst = max(worst, ratio)
        if ratio > 1.0:
            over.append(k)
    result = {"losses": loss, "loss_rel_diff": loss_err,
              "replayed_flips": flips,
              "worst_update_err_over_limit": worst,
              "tensors_over_limit": over, "loss_rtol": QAT_LOSS_RTOL,
              "update_rtol": QAT_UPDATE_RTOL,
              "max_replayed_flips": MAX_QAT_REPLAYED_FLIPS}
    if (loss_err > QAT_LOSS_RTOL or over
            or sum(flips.values()) > MAX_QAT_REPLAYED_FLIPS):
        raise AssertionError(f"the QAT step on the card differs from the "
                             f"CPU's: {result}")
    return result


def phase_qat(tree: dict, frames: np.ndarray, labels: np.ndarray) -> dict:
    """Quantization-aware fine-tuning of BiSeNet-R18 at ``qat.py``'s CLI
    defaults (1024x2048, b8, lr 1e-5, float32 fake-quant): ``finetune`` on
    in-memory frames for QAT_STEPS steps, writing the serving checkpoint and
    its scales sidecar; the step's p50 and peak memory from ``train_bench
    --qat`` (b4 when b8 does not fit, said in the line); ``export_int8``'s
    weights equal the fake-quant grid and its activation grid the
    fake-quant activations'; ``writeback`` re-folds to the tuned tree bit
    for bit, and cuDNN's eval BN on it equals the folded walk within
    float32 rounding (TF32 off); the checkpoint served by
    ``Predictor.from_checkpoint(quantize="int8")`` takes the sidecar's
    scales; one float32 step on the card held against the CPU's."""
    from rtsds_tpu_torch.qat import finetune

    state = {k: v for k, v in state_dict_from_flax(tree).items()}
    tmp = tempfile.TemporaryDirectory(prefix="rtsds_smoke_qat_")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = finetune(state, lambda idx: frames[idx], lambda idx: labels[idx],
                     len(frames), tmp.name, model_name="bisenet",
                     batch_size=BATCH, steps=QAT_STEPS, lr=1e-5,
                     calib_batches=1, log_every=1, device="cuda")
    torch.cuda.synchronize()
    finetune_s = time.perf_counter() - t0
    if not math.isfinite(stats["final_loss"]):
        raise AssertionError(f"QAT fine-tune: {stats}")
    torch.cuda.empty_cache()

    bench = None
    for batch in (BATCH, BATCH // 2):
        try:
            bench = supervised_step_benchmark(
                "bisenet", batch_size=batch, image_size=SIZE, steps=3,
                repeats=3, seed=SEED, qat=True)
            break
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
    if bench is None or not math.isfinite(bench["last_train_loss"]):
        raise AssertionError(f"QAT step bench: {bench}")
    torch.cuda.empty_cache()

    x = normalize(torch.from_numpy(frames[:BATCH]).cuda()).permute(0, 3, 1, 2)
    prep = prepare_qat("bisenet", state, [x], device="cuda")
    exported = export_int8(prep).qtree["q8"]
    grid_ok = set(exported) == set(prep.quant_names) and all(
        torch.equal(w_q.float() * w_s.reshape(-1, 1, 1, 1),
                    fake_quant_kernel(prep.folded[n][0]))
        for n, (w_q, w_s, _, _) in exported.items())
    scale = next(iter(exported.values()))[2]
    grid_ok &= torch.equal(fake_quant_act(x, scale),
                           quantize_act(x, scale).float() * scale)
    written = writeback("bisenet", state, prep.folded)
    refold = fold_bisenet(written)
    refold_exact = all(
        torch.equal(k, prep.folded[n][0].cpu())
        and (b is None or torch.equal(b, prep.folded[n][1].cpu()))
        for n, (k, b) in refold.items())
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = load_segmentor_state(BiSeNet(output_f32=False), written)
        model = model.cuda().eval()
        with torch.inference_mode():
            xb = x[:2]
            bn = model(xb)
            walk = bisenet_bf16_apply({k: v.cuda() for k, v in
                                       written.items()}, xb,
                                      dtype=torch.float32)
        bn_err = float((bn - walk).abs().max())
        bn_scale = float(walk.abs().max())
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags
    del model, bn, walk
    torch.cuda.empty_cache()

    served = Predictor.from_checkpoint(tmp.name, quantize="int8",
                                       image_size=SIZE, batch_size=BATCH,
                                       device="cuda")
    sidecar = load_act_scales(tmp.name)[0]
    q8 = served.model.qtree["q8"]
    sidecar_served = (served.act_scales == sidecar and all(
        float(entry[2]) == float(np.float32(sidecar[n]))
        for n, entry in q8.items()))
    _masks_ok(served.predict(frames[:BATCH]), (BATCH, *SIZE), "QAT served")
    del served
    tmp.cleanup()
    torch.cuda.empty_cache()
    check = qat_step_card_vs_cpu(state)
    emit({"phase": "qat", "model": "bisenet-resnet18",
          "image_size": list(SIZE), "dtype": "float32 (fake-quant)",
          "finetune": {**{k: stats[k] for k in (
              "steps", "final_loss", "quantized_convs", "bf16_convs",
              "calib_stat")}, "wall_s": finetune_s},
          "step_bench": {"batch": bench["batch_size"],
                         "fits_b8": bench["batch_size"] == BATCH,
                         "step_p50_ms": bench["ms_per_step"],
                         "steps_per_sec": bench["steps_per_sec"],
                         "max_memory_gb": bench["max_memory_gb"]},
          "export_grid_equals_fake_quant": grid_ok,
          "writeback_refold_exact": refold_exact,
          "eval_bn_vs_folded_walk_max_abs_err": bn_err,
          "folded_walk_logit_max_abs": bn_scale,
          "from_checkpoint_serves_sidecar_scales": sidecar_served,
          "step_card_vs_cpu_float32": check})
    if not (grid_ok and refold_exact and sidecar_served):
        raise AssertionError("QAT export, write-back or sidecar check "
                             "failed")
    if not bn_err <= 1e-4 * max(1.0, bn_scale):
        raise AssertionError(f"eval BN on the written-back weights differs "
                             f"from the folded walk by {bn_err}")
    return {"step_p50_ms": bench["ms_per_step"]}


def phase_distillation_int8() -> dict:
    """The int8 distillation teacher through the CLI's path
    (``cli.supervised_train_step`` with ``distillation.teacher.quantize:
    int8``): a DeepLabV2-R101 teacher checkpoint written by the port,
    quantized by ``quantize_teacher`` after calibration on 2 training
    batches (K2 in their transform), then the loader rewound; BiSeNet-R18
    distils from it through ``supervised_fit``, an epoch of TRAIN_STEPS
    steps at 720x1280 b8 bf16 on colour-coded labels (K2), validated at
    512x1024 (K1).  The int8-teacher step's p50 beside the bf16 teacher's
    (``train_bench --distill deeplab [--distill_quant int8]``).  Returns
    the launches."""
    import argparse

    from rtsds_tpu_torch import cli
    from rtsds_tpu_torch.callbacks.checkpoint import CheckpointManager
    from rtsds_tpu_torch.train import distill

    dev = torch.device("cuda")
    tmp = tempfile.TemporaryDirectory(prefix="rtsds_smoke_kd8_")
    teacher, _ = make_segmentor(train_config(), "deeplab", seed=SEED + 22)
    CheckpointManager(tmp.name).save(0, {"model": TrainState(
        teacher, make_optimizer("SGD", teacher.parameters(), 0.01))},
        monitor=0.5)
    del teacher
    config = load_config(overrides={
        "precision": {"compute_dtype": "bfloat16"},
        "training": {"segmentation": {
            "epochs": 1, "do_validation": 1,
            "distillation": {"enabled": True, "teacher": {
                "model": "deeplab", "checkpoint_dir": tmp.name,
                "quantize": "int8", "calib_batches": 2}}}}})
    args = argparse.Namespace(seed=SEED, model="bisenet",
                              validate_only=False)
    loader, transform = _gta5_stream(TRAIN_STEPS * TRAIN_BATCH, SEED + 44)
    state = build_supervised(config, "bisenet", len(loader), dev, seed=SEED)

    def batches(epoch):
        return device_batches(loader, transform, dev, seed=SEED, epoch=epoch)

    made = []
    plain_quantize = distill.quantize_teacher

    def recorded(name, teacher_state, calib, **kwargs):
        calib = list(calib)
        module = plain_quantize(name, teacher_state, calib, **kwargs)
        made.append({"model": name, "calib_batches": len(calib),
                     "quantized_convs": len(module.qtree["q8"]),
                     "bf16_convs": len(module.qtree["bf16"])})
        return module

    losses = []

    class _KD(Callback):
        def on_batch_end(self, batch, logs=None):
            losses.append({k: logs[k] for k in ("train_loss", "loss_ce",
                                                "loss_distill")})

    def run():
        step = cli.supervised_train_step(
            args, config, config.training["segmentation"], loader, dev,
            lambda: batches(0))
        return supervised_fit(
            state, step, batches, _val_stream(), epochs=1,
            num_classes=CLASSES, class_names=CLASS_NAMES, callbacks=[_KD()],
            device=dev)

    distill.quantize_teacher = recorded
    try:
        (_, history), launches, checked = on_main_path(run)
    finally:
        distill.quantize_teacher = plain_quantize
    tmp.cleanup()
    if len(made) != 1 or made[0]["calib_batches"] != 2:
        raise AssertionError(f"the CLI made int8 teachers {made}")
    if len(losses) != TRAIN_STEPS or not all(
            math.isfinite(v) for row in losses for v in row.values()):
        raise AssertionError(f"int8-teacher distillation losses {losses}")
    if checked != TRAIN_STEPS + 2 or len(history) != 1:
        raise AssertionError(f"{checked} K2 calls checked, {history}")
    del state
    torch.cuda.empty_cache()
    bench = {}
    for quant in ("int8", None):
        b = supervised_step_benchmark(
            "bisenet", batch_size=TRAIN_BATCH, image_size=TRAIN_SIZE,
            steps=DA_BENCH_STEPS, repeats=3, seed=SEED, distill="deeplab",
            distill_quant=quant)
        torch.cuda.empty_cache()
        if not math.isfinite(b["last_train_loss"]):
            raise AssertionError(f"distillation bench: {b}")
        bench[quant or "bf16"] = {k: b[k] for k in (
            "ms_per_step", "steps_per_sec", "teacher_forward_ms",
            "max_memory_gb")}
    emit({"phase": "distillation_int8", "student": "bisenet-resnet18",
          "teacher": "deeplabv2-resnet101 (int8, default policy)",
          "image_size": list(TRAIN_SIZE), "batch": TRAIN_BATCH,
          "dtype": "bfloat16", "steps": TRAIN_STEPS, "teacher_made": made[0],
          "losses": losses, "history": history,
          "k2_outputs_checked": checked, "launches": launches,
          "step_p50_ms": {k: v["ms_per_step"] for k, v in bench.items()},
          "bench": bench})
    return launches


def phase_pseudo_label(tree: dict, frames: np.ndarray) -> dict:
    """The offline pseudo-label sweep's in-memory core at 1024x2048 b8:
    the int8 model (``sweep_model(quantize="int8", calibrate=True)``,
    calibrated on one batch) with CBST per-class thresholds; its uint8
    masks (``infer_masks``) equal ``pseudo_labels`` applied to the int8
    forward's logits; timed.  No PNG is written (no PIL on the card's
    machine)."""
    from rtsds_tpu_torch.pseudo_label import infer_masks, sweep_model
    from rtsds_tpu_torch.train.self_training import pseudo_labels

    state = state_dict_from_flax(tree)
    model, thr = sweep_model("bisenet", state, [frames[:BATCH]],
                             quantize="int8", calibrate=True, device="cuda")
    thr = np.asarray(thr)
    if not (isinstance(model, QuantizedSegmentor) and thr.shape == (CLASSES,)
            and ((thr > 0) & (thr <= 1)).all()):
        raise AssertionError(f"pseudo-label model/thresholds: {thr}")
    x = torch.from_numpy(frames[:BATCH]).cuda()
    masks = infer_masks(model, x, thr)
    with torch.inference_mode():
        logits = model(normalize(x).permute(0, 3, 1, 2))
        want, coverage = pseudo_labels(logits, thr, 19)
    equal = bool(torch.equal(masks, want.to(torch.uint8)))
    ms = cuda_ms(lambda: infer_masks(model, x, thr), reps=10)
    emit({"phase": "pseudo_label", "model": "bisenet-resnet18 int8",
          "image_size": list(SIZE), "batch": BATCH,
          "cbst_thresholds": thr.tolist(), "coverage": float(coverage),
          "masks_equal_pseudo_labels_of_int8_logits": equal,
          "masks_dtype": str(masks.dtype), "p50_ms_per_batch": ms})
    if not equal or masks.dtype != torch.uint8:
        raise AssertionError("pseudo-label masks != pseudo_labels of the "
                             "int8 logits")
    return {"p50_ms": ms}


def phase_quant_bench() -> dict:
    """``bench/quant_bench.py`` on the card: ``bench_e2e`` (DeepLabV2-R101
    512x1024 b8) and ``bench_e2e_bisenet`` (1024x2048 at the JAX package's
    b48 and at b8), the default policy against bf16 (and the folded bf16
    walk), and the per-shape rows of DeepLab's 3x3 convs, with the int8
    conv's im2col and GEMM apart."""
    from rtsds_tpu_torch.bench.quant_bench import (
        DEEPLAB_CONVS, bench_e2e, bench_e2e_bisenet, bench_shape)

    e2e = {"deeplab_b8": bench_e2e(batch=BATCH, image_size=DEEPLAB_SIZE,
                                   iterations=QB_ITERS)}
    torch.cuda.empty_cache()
    for batch in (48, BATCH):
        e2e[f"bisenet_b{batch}"] = bench_e2e_bisenet(
            batch=batch, iterations=QB_ITERS)
        torch.cuda.empty_cache()
    rows = []
    for name, count, h, w, cin, cout, k, dil in DEEPLAB_CONVS:
        if k == 3:
            rows.append({**bench_shape(name, BATCH, h, w, cin, cout, k, dil,
                                       iterations=QB_ITERS), "count": count})
    torch.cuda.empty_cache()
    emit({"phase": "quant_bench", "iterations": QB_ITERS, "e2e": e2e,
          "deeplab_3x3_shapes": rows})
    for r in e2e.values():
        if not (r["bf16_ms"] > 0 and r["default"]["int8_ms"] > 0):
            raise AssertionError(f"quant_bench e2e: {r}")
    return e2e


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


def hist_bytes(labels: torch.Tensor, preds: torch.Tensor) -> int:
    """K1's bytes: each id read once in its own dtype, the (n, n) int32
    matrix written once."""
    return (labels.numel() * labels.element_size()
            + preds.numel() * preds.element_size() + CLASSES * CLASSES * 4)


def kernel_timing(labels: torch.Tensor, preds: torch.Tensor,
                  launches: int, max_abs_err: float) -> dict:
    """The hist kernel's entry of the ``kernels`` line, timed on the eval
    step's own int32 labels and int64 predictions, as it calls K1
    (``as_called_ms``, which is also ``ms``), and, beside it, on the same
    predictions cast to int32 beforehand (``int32_preds_ms``).  The bound
    is that of the as-called dtypes.  The library yardstick is
    ``torch.bincount`` of the joint ids, which syncs with the host to size
    its output."""
    n = CLASSES
    l64, p64 = labels.reshape(-1).long(), preds.reshape(-1).long()
    idx = torch.where((l64 >= 0) & (l64 < n) & (p64 >= 0) & (p64 < n),
                      l64 * n + p64, n * n)
    preds32 = preds.to(torch.int32)
    entry = timed_entry(lambda: fast_hist_cuda(labels, preds, n),
                        lambda: fast_hist(labels, preds, n),
                        lambda: torch.bincount(idx, minlength=n * n + 1),
                        hist_bytes(labels, preds))
    int32 = device_ms(lambda: fast_hist_cuda(labels, preds32, n))
    return {"name": "fast_hist_cuda", "route": "cuda",
            "source": "rtsds_tpu_torch/ops/cuda/csrc/hist.cu",
            "replaces": "rtsds_tpu/ops/pallas/hist.py:48",
            "launches": launches, "max_abs_err": max_abs_err, **entry,
            "as_called_ms": entry["ms"],
            "as_called_dtypes": [str(labels.dtype)[6:], str(preds.dtype)[6:]],
            "int32_preds_ms": int32["ms"],
            "int32_preds_bound_ms": hist_bytes(labels, preds32)
            / HBM_BYTES_PER_S * 1e3}


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
    remap.  K2's labels are made as the trainer's are; K1's labels are
    int32 and its predictions int64, as the eval step passes them (the
    labels with 30% noise, not a model's argmax), and K1 is also timed on
    the predictions cast to int32 beforehand.  To compare two trees in one
    call, copy this script to each tree's root and run it there with
    ``--kernels-only``: it imports only what earlier trees have."""
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
                          device=dev)
    # int64, as the eval step's argmax gives them
    preds = torch.where(torch.rand(labels.shape, generator=gen, device=dev)
                        < 0.3, noise, labels.long())
    preds32 = preds.to(torch.int32)
    if not torch.equal(fast_hist_cuda(labels, preds, CLASSES),
                       fast_hist(labels, preds, CLASSES)):
        raise AssertionError("hist kernel != plain on int64 predictions")
    times = {}
    for name, fn in (
            ("fast_hist_cuda_as_called",
             lambda: fast_hist_cuda(labels, preds, CLASSES)),
            ("fast_hist_cuda_int32_preds",
             lambda: fast_hist_cuda(labels, preds32, CLASSES)),
            ("rgb_to_train_ids_cuda", lambda: rgb_to_train_ids_cuda(rgb))):
        times[name] = {**device_ms(fn), "host_us": host_us(fn)}
    emit({"phase": "kernel_times", "timing": KERNEL_TIMING,
          "launches_per_timing": TIMED_LAUNCHES,
          "remap_pixels": rgb.numel() // 3, "hist_pixels": labels.numel(),
          "hist_dtypes": {"labels": str(labels.dtype)[6:],
                          "as_called_preds": str(preds.dtype)[6:]},
          "hist_bound_ms": {
              "as_called": hist_bytes(labels, preds) / HBM_BYTES_PER_S * 1e3,
              "int32_preds": hist_bytes(labels, preds32) / HBM_BYTES_PER_S
              * 1e3},
          "kernels": times})
    print(gpu_name_and_power_limit(), flush=True)
    return 0


def serving_data() -> tuple:
    """The serving frames (and their labels) and the seeded, BN-calibrated
    weight trees of BiSeNet-R18 at SIZE and DeepLabV2-R101 at
    DEEPLAB_SIZE: ``(frames, labels, tree, dl_frames, dl_tree)``."""
    ds = SyntheticSegDataset(SERVE_FRAMES + 2, SIZE, CLASSES, seed=SEED,
                             fixed_tints=True)
    frames = np.stack([ds[i][0] for i in range(SERVE_FRAMES)])
    labels = np.stack([ds[i][1] for i in range(SERVE_FRAMES)])
    calib = np.stack([ds[SERVE_FRAMES + i][0] for i in range(2)])
    tree = calibrate_batch_stats(random_flax_bisenet(SEED), calib, "cuda")
    dl_ds = SyntheticSegDataset(SERVE_FRAMES + 2, DEEPLAB_SIZE, CLASSES,
                                seed=SEED + 10, fixed_tints=True)
    dl_frames = np.stack([dl_ds[i][0] for i in range(SERVE_FRAMES)])
    dl_tree = calibrate_batch_stats(
        random_flax_deeplab(SEED),
        np.stack([dl_ds[SERVE_FRAMES + i][0] for i in range(2)]), "cuda",
        DeepLabV2)
    return frames, labels, tree, dl_frames, dl_tree


def int8_phases(frames, labels, tree, dl_frames, dl_tree) -> dict:
    """The int8 phases; returns the K1 and K2 launches of their main paths
    (int8 validation of each model, the int8-teacher distillation)."""
    phase_int8_ops(state_dict_from_flax(tree), state_dict_from_flax(dl_tree))
    launches = {"fast_hist_cuda": phase_int8_serving(tree, frames, dl_tree,
                                                     dl_frames),
                "rgb_to_train_ids_cuda": {}}
    torch.cuda.empty_cache()
    phase_qat(tree, frames, labels)
    torch.cuda.empty_cache()
    kd = phase_distillation_int8()
    for kernel, n in kd.items():
        launches[kernel]["bisenet_distillation_int8"] = n
    torch.cuda.empty_cache()
    phase_pseudo_label(tree, frames)
    torch.cuda.empty_cache()
    phase_quant_bench()
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if sys.argv[1:] == ["--kernels-only"]:
        return kernels_only()
    if sys.argv[1:] == ["--int8-only"]:
        phase_device()
        int8_phases(*serving_data())
        print(gpu_name_and_power_limit(), flush=True)
        return 0
    if sys.argv[1:]:
        raise SystemExit(f"usage: {sys.argv[0]} [--kernels-only | "
                         f"--int8-only]")
    device = phase_device()
    hist_err = phase_hist_check()
    remap_err = phase_remap_check()

    frames, frame_labels, tree, dl_frames, dl_tree = serving_data()

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

    # main paths 4-8: DeepLabV2-R101 serving (no hand-written kernel on
    # it), validation under each protocol, training, DA (counts reset
    # inside each, just before)
    phase_deeplab_serving(dl_tree, dl_frames, frames[:BATCH])
    dl_val = phase_deeplab_validation(dl_tree)
    dl_train = phase_deeplab_training()
    dl_da = phase_deeplab_da()
    torch.cuda.empty_cache()

    # main paths 9-13: the DA extras (counts reset inside each, just
    # before)
    ema = phase_ema_accumulate()
    extras = {"ema_accumulate": ema["launches"]}
    torch.cuda.empty_cache()
    # main path 14: serving the checkpoint that ema_accumulate trained
    # (its K2 launches) and validating the served model (K1; counts reset
    # inside, just before); then the benches
    serve_ckpt = phase_serving_checkpoint(ema["checkpoint"], frames)
    ema["tmp"].cleanup()
    phase_benches()
    torch.cuda.empty_cache()
    for variant, n in phase_da_minent_fda().items():
        extras[f"da_minent_fda_{variant}"] = n
    torch.cuda.empty_cache()
    extras["self_training"] = phase_self_training()
    torch.cuda.empty_cache()
    extras["distillation"] = phase_distillation()
    torch.cuda.empty_cache()
    # main paths 15-17: int8 validation of each model and the int8-teacher
    # distillation (counts reset inside each, just before)
    int8 = int8_phases(frames, frame_labels, tree, dl_frames, dl_tree)

    hist_paths = {"bisenet_serving_validation": serve_launches,
                  "bisenet_training": train_launches["fast_hist_cuda"],
                  "bisenet_da": da_launches["fast_hist_cuda"],
                  **{f"deeplab_validation_{k}": n for k, n in dl_val.items()},
                  "deeplab_training": dl_train["launches"]["fast_hist_cuda"],
                  "deeplab_da": dl_da["launches"]["fast_hist_cuda"],
                  **{f"bisenet_{k}": n["fast_hist_cuda"]
                     for k, n in extras.items()},
                  "bisenet_serving_checkpoint": serve_ckpt["fast_hist_cuda"],
                  **int8["fast_hist_cuda"]}
    remap_paths = {
        "bisenet_training": train_launches["rgb_to_train_ids_cuda"],
        "bisenet_da": da_launches["rgb_to_train_ids_cuda"],
        "deeplab_training": dl_train["launches"]["rgb_to_train_ids_cuda"],
        "deeplab_da": dl_da["launches"]["rgb_to_train_ids_cuda"],
        **{f"bisenet_{k}": n["rgb_to_train_ids_cuda"]
           for k, n in extras.items()},
        # the training that wrote the served checkpoint: the same launches
        # as bisenet_ema_accumulate's, counted once in the total
        "bisenet_serving_checkpoint": ema["launches"]["rgb_to_train_ids_cuda"],
        **int8["rgb_to_train_ids_cuda"]}
    if serve_ckpt["rgb_to_train_ids_cuda"]:
        raise AssertionError("serving launched K2")
    for kernel, paths in (("K1", hist_paths), ("K2", remap_paths)):
        missed = [p for p, n in paths.items() if n < 1]
        if missed:
            raise AssertionError(f"{kernel} never launched on {missed}")
    shared = {"bisenet_serving_checkpoint": "bisenet_ema_accumulate"}

    # the eval step's own int32 labels and int64 argmax, as it passes them
    kernels = [
        {**kernel_timing(labels, preds, sum(hist_paths.values()), hist_err),
         "launches_by_path": hist_paths},
        {**remap_timing(trained["rgb"], sum(remap_paths.values())
                        - remap_paths["bisenet_serving_checkpoint"],
                        remap_err),
         "launches_by_path": remap_paths,
         "launches_shared_by_paths": shared}]
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
                    **profile_steps(da["profile_run"], steps=3)},
          "deeplab_supervised": {
              "model": "deeplabv2-resnet101",
              **profile_steps(lambda: step(dl_train["state"],
                                           *dl_train["batch"]), steps=3)}})
    emit({"kernels": kernels})
    print(gpu_name_and_power_limit(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": device["name"],
                                 "count": device["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
