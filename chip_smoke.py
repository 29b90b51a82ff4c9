#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rtsds_tpu_torch``) on one GPU.

    python3 chip_smoke.py                 # from the repository root, one card
    python3 chip_smoke.py --kernels-only  # build and time K1 and K2 alone
    python3 chip_smoke.py --int8-only     # the int8 phases alone
    python3 chip_smoke.py --tooling-only  # artifacts, tooling, converter
    python3 chip_smoke.py --parallel-only # data, model, spatial, pipe axes
    python3 chip_smoke.py --axes-only     # the model and spatial axes alone
    python3 chip_smoke.py --composed-only # the composed meshes alone
    python3 chip_smoke.py --spatial-extras-only  # the extras on bands alone

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
  13. serving_artifact (``serve_export.py``: BiSeNet-R18 at 1024x2048
     bf16 with a dynamic batch at b8 and b3, DeepLabV2-R101 at 512x1024,
     the int8 BiSeNet, a sliding BiSeNet with a static batch, each
     artifact's masks against ``Predictor.predict``, export seconds, MB
     and ``predict`` p50 beside the predictor's), training_tooling (the
     CLI trains BiSeNet-R18 at 720x1280 b8 on colour-coded labels with
     blur + flip + ColorJitter + RandomZoom and the history, image-plot,
     TensorBoard and W&B-stub callbacks; SIGTERM mid-epoch, the emergency
     checkpoint, ``--resume`` replaying the epoch from a bit-identical
     snapshot; one ``--debug`` step stopped by a planted NaN) and
     convert_gta5 (``convert_labels`` on the card over 8 GTA5-size
     labels, exactly the host LUT's, frames/s beside the LUT's);
     ``python3 chip_smoke.py --tooling-only`` runs these alone;
  14. parallel (``python3 chip_smoke.py --parallel-only`` runs it alone):
     parallel_shared_card (two ranks spawned on cuda:0 under gloo, CUDA
     tensors: one float64 BiSeNet-R18 supervised step and one DA v1 step,
     b2 per rank with uneven void pixels, held against one process's step
     on the global batch at the card-vs-CPU limits; then bf16 at full
     width, global b8, 720x1280 (DA target 512x1024), 2 x 4 steps of each
     through ``supervised_fit``/``adversarial_fit`` on MultiHostDataLoader
     shards, K2 in the transforms and K1 in the validations, every rank
     matrix summing to the all-reduced one, the ranks' metrics equal and
     their parameters bit-identical; not a scaling figure),
     parallel_nccl_world1 (the CLI's ``--multihost`` under NCCL at world
     size 1, 2 steps and a validation, rank 0's checkpoint, its step's
     p50 beside the plain step's; the global-batch BN, a gradient
     all-reduce and a metrics reduction forced on under NCCL, and a full
     step with every BN synchronized, timed), parallel_serving (a batch
     mesh of two replicas on cuda:0, BiSeNet-R18 1024x2048 b8: exactly
     one device's masks at b4 in bf16 and f32, >= 0.999 of f32 b8's, and
     the HTTP server over it) and parallel_pipe (DeepLabV2-R101, pipe 2 on
     cuda:0, M = 2: a float64 step against the accumulating step, then
     bf16 at 720x1280 b8 through ``supervised_fit`` with K2 and K1,
     timed beside the accumulating step), then the extras on two ranks
     and under NCCL, spatial serving, and the model and spatial axes
     (``python3 chip_smoke.py --axes-only`` runs these four alone):
     parallel_model_axis (two gloo ranks on cuda:0 with ``mesh: {model:
     2}``, FSDP through the all_reduce forms: a float64 BiSeNet-R18 step
     and a DA v1 step against one process's replicated steps; bf16 at
     720x1280 through ``supervised_fit``, BiSeNet-R18 global b8 2 x 4
     steps and DeepLabV2-R101 global b2 1 x 2 steps, K2 in the transforms
     and K1 in the validations, each rank's bytes of parameters and Adam
     moments equal to the placement rule's, the gathered parameters
     bit-identical across the ranks, and the BiSeNet checkpoint served by
     ``Predictor.from_checkpoint`` with the replicated weights' masks),
     parallel_model_nccl_world1 (NCCL at world size 1 with the model axis
     forced on, so that ``all_gather_into_tensor`` and
     ``reduce_scatter_tensor`` run: a float64 step against the plain one,
     a bf16 720x1280 b8 step timed beside it), parallel_spatial_training
     (2 bands on cuda:0: float64 BiSeNet-R18 and DeepLabV2-R101 steps
     against one device; bf16 BiSeNet-R18 720x1280 b8 2 x 4 steps, DA v1
     1 x 2 steps (target 512x1024) and DeepLabV2-R101 512x1024 b2 1 x 2
     steps through the trainers, K2 before banding and K1 per band, each
     summed matrix against the plain version over the gathered masks; the
     step on bands timed beside one device, with the peak memory) and
     spatial_sliding (DeepLabV2-R101 at 1024x2048 b1 with a 512x1024
     window on 2 bands: float64 masks equal to one device's, the bf16
     agreement beside one device's b1-vs-b2 yardstick, both timed),
     spatial_extras (``--spatial-extras-only`` runs it alone; ROADMAP
     17.5b: on 2 bands of cuda:0 the float64 steps of the training extras
     (the int8 teacher's among them) against one device, CBST's
     thresholds equal; then bf16 at full width through the trainers, K2
     before banding and K1 per band, each step timed beside one device
     with its peak memory: BiSeNet-R18 720x1280 b8 with EMA +
     accumulation 2 + remat, DA v1 with MinEnt + FDA + the reversal step,
     DA v2, self-training with CBST and ClassMix, DeepLabV2-R101 512x1024
     b2 distilled from an int8 teacher, and validation at 1024x2048 under
     the sliding and the ensemble protocols); then
     the composed meshes (``--composed-only`` runs these two alone, and
     ``--axes-only`` runs them too): parallel_composed (two gloo ranks on
     cuda:0 with 2 bands each: float64 BiSeNet-R18 supervised and DA v1
     steps on ``{data: 2, spatial: 2}`` and ``{spatial: 2, model: 2}``
     against one process, DeepLabV2-R101 bf16 512x1024 global b2 on
     ``{spatial: 2, model: 2}``, and on ``{model: 2}`` the float64 steps
     of the nine training extras (EMA, accumulation, remat, MinEnt + FDA,
     v2, the reversal step, self-training, distillation under a float
     and an int8 teacher) against one process, CBST's thresholds equal,
     each rank's EMA bytes the placement rule's, and bf16 EMA +
     accumulation and self-training at full width; four gloo ranks on
     ``{data: 2, spatial: 2, model: 2}``: BiSeNet-R18 720x1280 global b8
     and DA v1 (target 512x1024) through the trainers; every bf16 path
     with K2 before banding and K1 per band, its losses finite and its
     ranks' gathered parameters bit-identical; on the four ranks also DA
     v1 with MinEnt + FDA and 2-micro-batch accumulation, and the hybrid
     mesh (ROADMAP 17.6): each rank's shard of a DA batch on a 2 x 2
     (nodes x local GPUs) grid bit-identical to the flat data mesh's,
     on which the step is the flat data group's) and
     parallel_composed_nccl_world1 (the CLI's ``--multihost`` on ``mesh:
     {spatial: 2}`` under NCCL at world size 1 with the data axis forced,
     its checkpoint served by ``Predictor.from_checkpoint``; a float64
     step on 2 bands with the data and model axes' collectives forced
     against the plain step, and the bf16 720x1280 b8 composed step
     timed beside the plain one, not a scaling figure);
  15. train_profile: torch.profiler over a few train steps: the device's
     idle share and kernel time by group, and each hand-written kernel's
     device time per launch beside the timer's (run after the kernel
     timings, which the profiler's tracing could slow);
  16. the ``kernels`` line: each kernel's launches on the main paths (each
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
import signal
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


def stream_ms(predictor: Predictor, batches: list) -> dict:
    """``predict`` and ``predict_iter`` over a stream of STREAM_BATCHES of
    ``batches`` in turn, each run twice in turns (predict, predict_iter,
    predict_iter, predict): host-clock ms a batch."""
    stream = [batches[i % len(batches)] for i in range(STREAM_BATCHES)]
    per_batch = {"predict": [], "predict_iter": []}
    for name in ("predict", "predict_iter", "predict_iter", "predict"):
        t0 = time.perf_counter()
        if name == "predict":
            for b in stream:
                predictor.predict(b)
        else:
            for _ in predictor.predict_iter(stream):
                pass
        per_batch[name].append((time.perf_counter() - t0) / len(stream)
                               * 1e3)
    return per_batch


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
        per_batch = stream_ms(predictor, batches[:2])

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
            want = apply(quant.tree_on(qtree, "cpu"), x.cpu(),
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


# ---------------------------------------------------------------------------
# Serving artifacts, the training tooling and the GTA5 data tools.
# ---------------------------------------------------------------------------

# the artifact's masks against Predictor.predict's at the same batch: the
# exported graph runs the eager forward's ops, none decomposed.  At another
# batch cuDNN may pick other conv algorithms, which moves bf16 rounding
# (ROADMAP C), so each comparison runs both at one batch
MIN_ARTIFACT_AGREEMENT = 1.0
MIN_INT8_ARTIFACT_AGREEMENT = 0.99
ARTIFACT_TIMING_REPS = 10
# a dynamic artifact bounded below this many frames (BiSeNet at 1024x2048:
# 53) is also run one frame past its bound
CHECKED_BATCH_BOUND = 64
SLIDING_ARTIFACT_BATCH = 2
TOOLING_STEPS = 2          # per epoch: 16 synthetic GTA5 frames at b8
GTA5_LABEL_SIZE = (1052, 1914)
CONVERT_FRAMES = 8


def _agreement(got: np.ndarray, want: np.ndarray, what: str,
               least: float) -> float:
    if got.shape != want.shape or got.dtype != np.int32:
        raise AssertionError(f"{what}: masks {got.shape} {got.dtype}, "
                             f"want {want.shape}")
    share = float((got == want).mean())
    if share < least:
        raise AssertionError(f"{what}: the artifact agrees with "
                             f"Predictor.predict on {share} of pixels "
                             f"(< {least})")
    return share


def _export_and_check(predictor: Predictor, frames: np.ndarray, what: str,
                      batch="dynamic", least: float = MIN_ARTIFACT_AGREEMENT,
                      time_it: bool = False) -> dict:
    """Exports ``predictor`` (``serve_export.export_predictor``), loads the
    artifact onto the card and holds its masks of ``frames`` (all of
    them, and 3) against the predictor's at the same batch, and, where
    the program bounds its batch below CHECKED_BATCH_BOUND, one batch past
    the bound; with ``time_it``, both ``predict`` calls' p50 at b8, taken
    in turns."""
    from rtsds_tpu_torch.serve_export import export_predictor, load_predictor

    with tempfile.TemporaryDirectory(prefix="rtsds_smoke_art_") as tmp:
        path = os.path.join(tmp, "model.rtsds")
        t0 = time.perf_counter()
        export_predictor(predictor, path, batch=batch)
        export_s = time.perf_counter() - t0
        size_mb = os.path.getsize(path) / 1e6
        t0 = time.perf_counter()
        art = load_predictor(path)
        load_s = time.perf_counter() - t0
    out = {"batch": art.batch, "max_batch": art.max_batch,
           "meta": art.meta, "export_s": export_s, "load_s": load_s,
           "artifact_mb": size_mb, "agreement": {}}
    for n in sorted({frames.shape[0], 3}):
        got = art.predict(frames[:n])
        if art.batch == "dynamic" and n != predictor.batch_size:
            # the dynamic artifact runs n frames where Predictor.predict
            # pads them to its batch, and cuDNN picks its conv algorithms
            # by batch: hold the artifact to the predictor's computation
            # at n frames, and record the padded call's agreement
            with torch.inference_mode():
                want = predictor.masks(torch.from_numpy(
                    frames[:n]).cuda()).cpu().numpy().astype(np.int32)
            out["agreement"][f"b{n}_padded_predict"] = float(
                (got == predictor.predict(frames[:n])).mean())
        else:
            want = predictor.predict(frames[:n])
        out["agreement"][f"b{n}"] = _agreement(got, want, f"{what} b{n}",
                                               least)
    if art.batch == "dynamic" and art.max_batch is not None \
            and art.max_batch < CHECKED_BATCH_BOUND:
        # a batch past the program's bound runs in chunks of the bound,
        # each held against the predictor's computation at that batch
        many = np.concatenate([frames] * (art.max_batch // len(frames) + 1))
        many = many[:art.max_batch + 1]
        got = art.predict(many)
        with torch.inference_mode():
            want = np.concatenate([
                predictor.masks(torch.from_numpy(c).cuda()).cpu().numpy()
                for c in (many[:art.max_batch], many[art.max_batch:])])
        out["agreement"][f"b{len(many)}_in_chunks"] = _agreement(
            got, want.astype(np.int32), f"{what} b{len(many)}", least)
    if time_it:
        # in turns (artifact, predictor, predictor, artifact), one p50 each
        b = frames[:BATCH]
        calls = {"artifact": art.predict, "predictor": predictor.predict}
        for key in calls:
            out[f"{key}_predict_p50_ms"] = []
        for key in ("artifact", "predictor", "predictor", "artifact"):
            out[f"{key}_predict_p50_ms"].append(cuda_ms(
                lambda: calls[key](b), reps=ARTIFACT_TIMING_REPS))
    del art
    torch.cuda.empty_cache()
    return out


def phase_serving_artifact(tree: dict, frames: np.ndarray, dl_tree: dict,
                           dl_frames: np.ndarray) -> None:
    """Serving artifacts at full width (``serve_export.py``): BiSeNet-R18 at
    1024x2048 bf16 with a dynamic batch, predicting b8 and b3, its
    ``predict`` p50 at b8 beside ``Predictor.predict``'s; DeepLabV2-R101 at
    512x1024 bf16; the int8 BiSeNet (>= 0.99 of pixels, JAX's caveat); a
    sliding-protocol BiSeNet with a static batch.  Each artifact's masks
    are held against ``Predictor.predict`` on the same frames.  No
    hand-written kernel runs on this path."""
    out = {}
    bisenet = Predictor(variables=tree, image_size=SIZE, batch_size=BATCH,
                        device="cuda")
    out["bisenet_bf16"] = _export_and_check(bisenet, frames[:BATCH],
                                            "bisenet bf16", time_it=True)
    int8 = Predictor(variables=tree, image_size=SIZE, batch_size=BATCH,
                     quantize="int8", calib_frames=frames[:BATCH],
                     device="cuda")
    out["bisenet_int8"] = _export_and_check(
        int8, frames[:BATCH], "bisenet int8",
        least=MIN_INT8_ARTIFACT_AGREEMENT)
    del int8
    sliding = Predictor(variables=tree, image_size=SIZE,
                        batch_size=SLIDING_ARTIFACT_BATCH,
                        protocol="sliding",
                        protocol_kwargs={"window": DEEPLAB_SIZE},
                        device="cuda")
    out["bisenet_sliding"] = _export_and_check(
        sliding, frames[:SLIDING_ARTIFACT_BATCH * 2], "bisenet sliding",
        batch=SLIDING_ARTIFACT_BATCH)
    del sliding, bisenet
    torch.cuda.empty_cache()
    deeplab = Predictor(model_name="deeplab", variables=dl_tree,
                        image_size=DEEPLAB_SIZE, batch_size=BATCH,
                        device="cuda")
    out["deeplab_bf16"] = _export_and_check(deeplab, dl_frames[:BATCH],
                                            "deeplab bf16", time_it=True)
    del deeplab
    torch.cuda.empty_cache()
    emit({"phase": "serving_artifact", "image_size": list(SIZE),
          "deeplab_image_size": list(DEEPLAB_SIZE), "dtype": "bfloat16",
          **out})


class _Recorder(Callback):
    """Each batch's loss; ``at_start()`` called when the run's first epoch
    begins; and (``sigterm_at``) SIGTERM sent to this process at batch
    ``sigterm_at[1]`` of epoch ``sigterm_at[0]``, counting epochs from the
    first this callback sees."""

    def __init__(self, sigterm_at=None, at_start=None):
        self.losses, self.epochs_done = [], 0
        self.sigterm_at = sigterm_at
        self.at_start = at_start

    def on_train_begin(self, logs=None):
        if self.at_start is not None and not self.losses:
            self.at_start()

    def on_epoch_end(self, epoch, logs=None):
        self.epochs_done += 1

    def on_batch_end(self, batch, logs=None):
        self.losses.append(logs["train_loss"])
        if self.sigterm_at == (self.epochs_done, batch):
            os.kill(os.getpid(), signal.SIGTERM)


def _fake_wandb():
    """A stand-in ``wandb`` module recording its calls (W&B is not
    installed on the card's machine, and a run must not reach the
    network)."""
    import types

    calls = []

    class Run:
        def log(self, payload):
            calls.append(("log", sorted(payload)))

        def finish(self):
            calls.append(("finish",))

    module = types.ModuleType("wandb")
    module.init = lambda **kw: calls.append(("init", kw["project"])) or Run()
    module.Table = lambda columns, data: {"columns": columns, "data": data}
    return module, calls


def _renderer() -> str | None:
    for name in ("matplotlib", "PIL"):
        try:
            __import__(name)
            return name
        except ImportError:
            pass
    return None


def _tooling_config(root: str, plots: bool) -> str:
    import yaml

    config = {
        "data": {
            "cityscapes": {"image_size": "512, 1024", "batch_size": BATCH,
                           "num_workers": 4},
            "gta5_modified": {"image_size": "720, 1280",
                              "batch_size": TRAIN_BATCH, "num_workers": 4,
                              "decode_label_colors": True}},
        "precision": {"compute_dtype": "bfloat16"},
        "training": {"segmentation": {"epochs": 2, "do_validation": 1}},
        "augmentation": {
            "p": 1.0, "GaussianBlur": {"kernel_size": "5, 9",
                                       "sigma": "0.1, 5"},
            "RandomHorizontalFlip": {"p": 0.5},
            "ColorJitter": {"brightness": 0.4, "contrast": 0.4,
                            "saturation": 0.4, "hue": 0.1},
            "RandomZoom": {"max": 1.5, "p": 0.5}},
        "callbacks": {
            "model_checkpoint": {"save_dir": os.path.join(root, "ckpt"),
                                 "save_name": "tooling", "save_best": False,
                                 "save_freq": 1},
            "early_stopping": None,
            "history": {"path": os.path.join(root, "history.jsonl")},
            "images_plots": ({"save_dir": os.path.join(root, "images"),
                              "number_of_samples": 2} if plots else None),
            "logging": {"wandb": {"project_name": "smoke",
                                  "run_name": "tooling", "note": "card"}}}}
    path = os.path.join(root, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def _state_dicts_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a.cpu(), b.cpu()))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_state_dicts_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_state_dicts_equal, a, b))
    return a == b


def _augment_ms(images: torch.Tensor, labels: torch.Tensor) -> dict:
    """One batch's augmentation with the gate open and every zoom coin
    fired: blur + flip, and blur + flip + ColorJitter + RandomZoom."""
    from rtsds_tpu_torch.ops.augment import AugmentDraws, apply_augment

    n, h, w = labels.shape
    full = AugmentConfig(color_jitter=(0.4, 0.4, 0.4, 0.1), zoom_max=1.5)
    draws = AugmentDraws(gate=True, sigma=2.0, flip=True, brightness=1.2,
                         contrast=0.8, saturation=1.1, hue=0.05,
                         zoom_scale=(1.3,) * n, zoom_fire=(True,) * n,
                         zoom_ty=(-0.15 * h,) * n, zoom_tx=(-0.15 * w,) * n)
    return {"blur_flip_ms": cuda_ms(lambda: apply_augment(
                AugmentConfig(), draws, images, labels)),
            "blur_flip_jitter_zoom_ms": cuda_ms(lambda: apply_augment(
                full, draws, images, labels))}


def _snapshot_cost(state) -> dict:
    """The epoch-start snapshot of ``state`` on the card: its bytes and
    the time of the copy."""
    from rtsds_tpu_torch.callbacks.checkpoint import snapshot_states

    states = {"model": state}
    snap = snapshot_states(states)
    nbytes = 0
    stack = [snap["model"].state_dict()]
    while stack:
        item = stack.pop()
        if isinstance(item, torch.Tensor):
            nbytes += item.numel() * item.element_size()
        elif isinstance(item, dict):
            stack.extend(item.values())
        elif isinstance(item, (list, tuple)):
            stack.extend(item)
    del snap
    return {"snapshot_gb": nbytes / 1e9,
            "snapshot_ms": cuda_ms(lambda: snapshot_states(states), reps=5,
                                   warmup=1)}


def phase_training_tooling() -> dict:
    """The training tooling through the port's CLI on the card: BiSeNet-R18
    on 16 synthetic GTA5 frames at 720x1280 b8 bf16 with colour-coded
    labels (K2 in the transform), augmented with blur + flip + ColorJitter +
    RandomZoom, validated at 512x1024 b8 (K1), with the history, image-plot
    (where matplotlib or PIL imports), TensorBoard and W&B (a stub module)
    callbacks.  A callback sends SIGTERM to this process in epoch 1: the
    emergency checkpoint must be the epoch-start state bit for bit and
    reported by ``ckpt_info``; ``--resume`` replays epoch 1 from it (the
    restored tensors equal to it bit for bit).  Then one ``--debug`` step
    with a NaN planted in one conv: it must raise, naming that conv.
    Returns the path's launches."""
    from rtsds_tpu_torch import ckpt_info, cli
    from rtsds_tpu_torch.callbacks.checkpoint import CheckpointManager
    from rtsds_tpu_torch.callbacks.history import read_history
    from rtsds_tpu_torch.callbacks.logging import TensorBoardCallback
    from rtsds_tpu_torch.callbacks.plots import ImagePlotsCallback
    from rtsds_tpu_torch.train import factory

    renderer = _renderer()
    print(f"training_tooling: image plots rendered with {renderer}"
          if renderer else "training_tooling: neither matplotlib nor PIL "
          "imports; the plot callback collects without rendering",
          flush=True)
    tmp = tempfile.TemporaryDirectory(prefix="rtsds_smoke_tool_")
    config = _tooling_config(tmp.name, plots=renderer is not None)
    wandb, wandb_calls = _fake_wandb()
    seen = {"states": [], "samples": [], "emergency_s": []}
    plain = {"build_callbacks": cli.build_callbacks,
             "build_supervised": factory.build_supervised,
             "wandb": sys.modules.get("wandb")}

    def recording_build(*args, **kwargs):
        state = plain["build_supervised"](*args, **kwargs)
        seen["states"].append(state)
        return state

    def build_callbacks(*args, sigterm_at=None, **kwargs):
        callbacks, checkpoint = plain["build_callbacks"](*args, **kwargs)
        plot = next((cb for cb in callbacks
                     if isinstance(cb, ImagePlotsCallback)), None)
        if plot is None:   # no renderer: collect only
            plot = ImagePlotsCallback(number_of_samples=2)
            plot.on_validation_end = lambda logs=None, data=None: None
            callbacks.append(plot)
        add = plot.add_sample

        def add_sample(*arrays):
            seen["samples"].append(arrays)
            add(*arrays)
        plot.add_sample = add_sample
        save = checkpoint.save_emergency

        def save_emergency():
            t0 = time.perf_counter()
            ok = save()
            seen["emergency_s"].append(time.perf_counter() - t0)
            return ok
        checkpoint.save_emergency = save_emergency
        recorder = _Recorder(sigterm_at, at_start=lambda: seen.setdefault(
            "resumed", _copy_state(seen["states"][-1])))
        seen["recorder"] = recorder
        return [*callbacks, recorder,
                TensorBoardCallback(os.path.join(tmp.name, "tb"))], \
            checkpoint

    def _copy_state(state):
        return {k: v.detach().clone() if isinstance(v, torch.Tensor) else v
                for k, v in state.model.state_dict().items()}

    argv = ["--config", config, "--synthetic", "--dataset", "gta5",
            "--augmented", "--wandb"]
    out = {}

    def run():
        factory.build_supervised = recording_build
        sys.modules["wandb"] = wandb
        try:
            cli.build_callbacks = lambda *a, **k: build_callbacks(
                *a, sigterm_at=(1, 0), **k)
            if cli.main(argv) is not None:
                raise AssertionError("the preempted run did not stop")
            out["preempted_losses"] = seen["recorder"].losses
            out["ckpt_info"] = ckpt_info.describe_checkpoint(run_dir)
            mgr = CheckpointManager(run_dir)
            out["snapshot"] = mgr.load(1)
            # the emergency save is epoch 1's start: the state saved
            # after epoch 0
            if (out["ckpt_info"]["emergency_step"] != 1
                    or not _state_dicts_equal(out["snapshot"], mgr.load(0))):
                raise AssertionError(f"emergency checkpoint: "
                                     f"{out['ckpt_info']}")
            seen.pop("resumed", None)
            cli.build_callbacks = build_callbacks
            out["resumed_history"] = cli.main(argv + ["--resume"])
            out["resumed_losses"] = seen["recorder"].losses
        finally:
            cli.build_callbacks = plain["build_callbacks"]
            factory.build_supervised = plain["build_supervised"]
            if plain["wandb"] is None:
                sys.modules.pop("wandb", None)
            else:
                sys.modules["wandb"] = plain["wandb"]

    run_dir = os.path.join(tmp.name, "ckpt", "tooling")
    t0 = time.perf_counter()
    _, launches, checked = on_main_path(run)
    cli_s = time.perf_counter() - t0
    if ckpt_info.describe_checkpoint(run_dir)["emergency_step"] is not None:
        raise AssertionError("the replayed epoch left the EMERGENCY marker")
    if [h["epoch"] for h in out["resumed_history"]] != [1]:
        raise AssertionError(f"resumed history {out['resumed_history']}")
    # the resumed model, as epoch 1 begins again, is the snapshot
    if not _state_dicts_equal(seen["resumed"],
                              out["snapshot"]["model"]["model"]):
        raise AssertionError("the resumed model is not the epoch-start "
                             "snapshot")
    losses = out["preempted_losses"] + out["resumed_losses"]
    if len(out["resumed_losses"]) != TOOLING_STEPS or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"losses {losses}")
    events = read_history(os.path.join(tmp.name, "history.jsonl"))
    epochs = [r["epoch"] for r in events if r["event"] == "epoch"]
    if epochs != [0, 1]:
        raise AssertionError(f"history epochs {epochs}")
    final = seen["states"][-1]
    eval_step = cli.build_eval_step(load_config(config), final, (512, 1024),
                                    CLASSES, return_preds=True)
    images, labels, preds = seen["samples"][-1]
    if preds.shape != (BATCH, 512, 1024):
        raise AssertionError(f"plot samples {preds.shape}")
    final.model.eval()
    hist = torch.zeros((CLASSES, CLASSES), dtype=torch.int32, device="cuda")
    _, want = eval_step(torch.from_numpy(images).cuda(),
                        torch.from_numpy(labels).cuda(), hist)
    plot_agreement = float((want.cpu().numpy() == preds).mean())
    if plot_agreement != 1.0:
        raise AssertionError(f"plotted predictions agree with the eval "
                             f"step's argmax on {plot_agreement}")
    if not wandb_calls or wandb_calls[0] != ("init", "smoke") \
            or wandb_calls[-1] != ("finish",):
        raise AssertionError(f"W&B calls {wandb_calls[:3]}")
    images_written = (sorted(os.listdir(os.path.join(tmp.name, "images")))
                      if renderer else [])
    tb_dir = os.path.join(tmp.name, "tb")
    tb_written = sorted(os.listdir(tb_dir)) if os.path.isdir(tb_dir) else []

    # the ColorJitter + RandomZoom batch against blur + flip alone
    loader, transform = _gta5_stream(TRAIN_BATCH, SEED + 60)
    host_images, host_rgb = next(iter(loader))
    images_dev = torch.from_numpy(host_images).cuda().float()
    ids = rgb_to_train_ids(torch.from_numpy(host_rgb).cuda())
    augment = _augment_ms(images_dev, ids)
    snapshot = {"bisenet_r18_adam": _snapshot_cost(final)}
    del final, seen["states"][:]
    # DeepLabV2-R101 with Adam's moments: one step at a small size first
    deeplab = build_supervised(load_config(overrides={
        "precision": {"compute_dtype": "bfloat16"}}), "deeplab", 1,
        torch.device("cuda"), seed=SEED)
    make_train_step(19)(deeplab, torch.zeros(2, 128, 256, 3, device="cuda"),
                        torch.zeros(2, 128, 256, dtype=torch.int32,
                                    device="cuda"))
    snapshot["deeplab_r101_adam"] = _snapshot_cost(deeplab)
    del deeplab
    torch.cuda.empty_cache()

    # --debug: a NaN planted in one conv stops the first forward
    debug_dir = tempfile.TemporaryDirectory(prefix="rtsds_smoke_dbg_")
    debug_config = _tooling_config(debug_dir.name, plots=False)

    def planted(*args, **kwargs):
        state = plain["build_supervised"](*args, **kwargs)
        with torch.no_grad():
            state.model.ffm.conv1.weight[0, 0] = float("nan")
        return state

    factory.build_supervised = planted
    try:
        cli.main(["--config", debug_config, "--synthetic", "--dataset",
                  "gta5", "--debug"])
        raise AssertionError("--debug did not stop at the planted NaN")
    except FloatingPointError as e:
        debug_message = str(e)
    finally:
        factory.build_supervised = plain["build_supervised"]
        debug_dir.cleanup()
    if "'ffm.conv1'" not in debug_message or torch.is_anomaly_enabled():
        raise AssertionError(f"--debug: {debug_message}")
    tmp.cleanup()
    emit({"phase": "training_tooling", "model": "bisenet-resnet18",
          "image_size": list(TRAIN_SIZE), "batch": TRAIN_BATCH,
          "dtype": "bfloat16", "augmentation": "blur+flip+ColorJitter+"
          "RandomZoom", "steps_per_epoch": TOOLING_STEPS,
          "preempted_losses": out["preempted_losses"],
          "resumed_losses": out["resumed_losses"],
          "resumed_history": out["resumed_history"],
          "emergency_save_s": seen["emergency_s"],
          "resumed_equals_snapshot": True, "history_epochs": epochs,
          "plot_samples": len(seen["samples"]),
          "plot_preds_equal_eval_argmax": plot_agreement,
          "renderer": renderer, "images_written": images_written,
          "tensorboard_files": len(tb_written),
          "wandb_calls": len(wandb_calls), "debug": debug_message,
          "k2_outputs_checked": checked, "cli_s": cli_s,
          "ckpt_info_after_sigterm": out["ckpt_info"],
          "augment_ms_gate_open": augment, "epoch_start_snapshot": snapshot,
          "launches": launches})
    return launches


def phase_convert_gta5() -> dict:
    """``data/convert_gta5.convert_labels`` on the card (K2) over
    CONVERT_FRAMES GTA5-size (1052x1914) colour-coded labels made from the
    colour table (5% of pixels another colour), each held exactly against
    the host LUT (``build_lut``); frames/s with the host-device transfers
    counted, beside the LUT's on the host.  Returns the path's
    launches."""
    from rtsds_tpu_torch.data.convert_gta5 import build_lut, convert_labels

    gen = torch.Generator(device="cuda").manual_seed(SEED + 70)
    frames = [gta5_label_batch(gen, GTA5_LABEL_SIZE).cpu().numpy()
              for _ in range(CONVERT_FRAMES)]
    lut = build_lut()

    def host(rgb):
        packed = ((rgb[..., 0].astype(np.uint32) << 16)
                  | (rgb[..., 1].astype(np.uint32) << 8) | rgb[..., 2])
        return lut[packed]

    def run():
        convert_labels(frames[0], "cuda")   # warm-up
        t0 = time.perf_counter()
        got = [convert_labels(f, "cuda") for f in frames]
        return got, time.perf_counter() - t0

    (got, card_s), launches, _ = on_main_path(run)
    t0 = time.perf_counter()
    want = [host(f) for f in frames]
    host_s = time.perf_counter() - t0
    for g, w in zip(got, want):
        if g.dtype != np.uint8 or not np.array_equal(g, w):
            raise AssertionError("convert_labels on the card != host LUT")
    void = float(np.mean([(w == 255).mean() for w in want]))
    emit({"phase": "convert_gta5", "frames": CONVERT_FRAMES,
          "label_size": list(GTA5_LABEL_SIZE), "equal_to_host_lut": True,
          "void_fraction": void,
          "card_frames_per_s_with_transfers": CONVERT_FRAMES / card_s,
          "host_lut_frames_per_s": CONVERT_FRAMES / host_s,
          "launches": launches})
    return launches


# --- the parallel phase: the data axis over processes, the batch mesh and
# the pipe -------------------------------------------------------------------

PAR_WORLD = 2
PAR_F64_SIZE = (64, 128)   # the float64 checks: b2 per rank
PAR_STEPS = 4              # per epoch, 2 epochs, global b8
PAR_TIMEOUT_S = 240        # each spawn of the two ranks
PIPE_F64_SIZE = (64, 96)   # the pipelined float64 check: b4, M = 2
PIPE_STEPS = 3             # the bf16 pipelined run, one epoch


def _par_f64_inputs() -> tuple:
    """The float64 checks' global batch 4 at PAR_F64_SIZE: frames, labels
    (shard 0, frames 0-1, with half its pixels void; shard 1 none) and
    target frames."""
    ds = SyntheticSegDataset(8, PAR_F64_SIZE, CLASSES, seed=SEED + 80,
                             fixed_tints=True)
    frames = np.stack([ds[i][0] for i in range(8)])
    images = normalize(torch.from_numpy(frames[:4])).double()
    labels = torch.from_numpy(np.stack([ds[i][1] for i in range(4)])).long()
    labels[:2, :, : PAR_F64_SIZE[1] // 2] = 19
    target = normalize(torch.from_numpy(frames[4:])).double()
    return images, labels, target


def _par_f64_steps(rank: int, world: int, mesh=None, bands: int = 0
                   ) -> dict:
    """One float64 supervised step of BiSeNet-R18 and one DA v1 step (the
    Tiny discriminator) on this rank's shard of :func:`_par_f64_inputs`,
    on the card; with ``world`` 1, the whole global batch.  The states are
    replicated over the ranks, or with ``mesh`` placed on it
    (``place_state``: a model axis shards them); ``bands`` splits the
    shard's rows (source and target apart) over that many bands of
    cuda:0.  Returns the losses, the states before and after (whole, CPU
    tensors)."""
    from rtsds_tpu_torch.parallel.distributed import replicate
    from rtsds_tpu_torch.parallel.mesh import place_state

    def placed(*states):
        for st in states:
            if mesh is None:
                replicate(st.model)
            else:
                place_state(st, mesh)

    images, labels, target = _par_f64_inputs()
    n = images.shape[0] // world
    part = slice(rank * n, (rank + 1) * n)
    x, y, t = (a[part].cuda() for a in (images, labels, target))
    if bands:
        from rtsds_tpu_torch.parallel.spatial import split_batch

        devices = ["cuda:0"] * bands
        x, y = split_batch(x, y, devices)
        t, _ = split_batch(t, torch.zeros(t.shape[:3], dtype=torch.long,
                                          device=t.device), devices)
    config = load_config()
    out = {}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        model, _ = make_segmentor(config, "bisenet", seed=SEED)
        model.to("cuda", torch.float64)
        before = {k: v.detach().cpu().clone()
                  for k, v in model.named_parameters()}
        state = TrainState(model, make_optimizer(
            "SGD", model.parameters(), 0.01, momentum=0.9))
        placed(state)
        loss = float(make_train_step(19)(state, x, y)["train_loss"])
        out["supervised"] = {
            "losses": {"train_loss": loss}, "before": [before],
            "after": [{k: v.detach().cpu() for k, v in
                       state.state_dict()["model"].items()}]}
        gen, _ = make_segmentor(config, "bisenet", seed=SEED)
        gen.to("cuda", torch.float64)
        dis = make_discriminator(
            config.model["adversarial_model"]["discriminator"],
            seed=SEED + 1).to("cuda", torch.float64)
        before = [{k: v.detach().cpu().clone() for k, v in
                   m.named_parameters()} for m in (gen, dis)]
        g = TrainState(gen, make_optimizer("SGD", gen.parameters(), 0.01,
                                           momentum=0.0))
        d = TrainState(dis, make_optimizer("SGD", dis.parameters(), 0.02,
                                           momentum=0.0))
        placed(g, d)
        metrics = make_adversarial_step(0.1, DA_ITERATIONS, DA_EPOCHS, 19,
                                        "v1")(g, d, x, y, t)
        out["da_v1"] = {
            "losses": {k: float(v) for k, v in metrics.items()
                       if k.startswith("loss_")},
            "before": before,
            "after": [{k: v.detach().cpu() for k, v in
                       st.state_dict()["model"].items()} for st in (g, d)]}
    return out


def _held_to(got: dict, want: dict) -> dict:
    """Two runs of one float64 step held to the card-vs-CPU limits: each
    loss within 1e-4 relative, the BN running statistics within rtol 1e-4 /
    atol 1e-5, each parameter's update within 1e-3 of its largest update +
    1e-6.  Returns the worst of each over its limit."""
    loss_err = max(abs(got["losses"][k] - v) / max(abs(v), 1e-12)
                   for k, v in want["losses"].items())
    stats_err, ratios = 0.0, {}
    for i, (g, w, start) in enumerate(zip(got["after"], want["after"],
                                          want["before"])):
        stats_err = max([stats_err] + [
            float(((g[k] - v).abs() / (1e-5 + 1e-4 * v.abs())).max())
            for k, v in w.items() if "running_" in k])
        ratios.update(_update_ratios({k: (w[k], g[k]) for k in start},
                                     start, "GD"[i]))
    result = {"loss_rel_diff": loss_err, "bn_stats_err_over_limit": stats_err,
              "tensors_over_limit": sum(r > 1.0 for r in ratios.values()),
              "worst_update_err_over_limit": max(ratios.values())}
    if loss_err > 1e-4 or stats_err > 1.0 or result["tensors_over_limit"]:
        raise AssertionError(f"2 ranks differ from one process: {result}")
    return result


def _par_loader(n: int, size: tuple, seed: int, colour: bool,
                infinite: bool = False, shuffle: bool = True,
                drop_last: bool = True, micro_batches: int = 1):
    """This rank's MultiHostDataLoader (global batch TRAIN_BATCH) over ``n``
    synthetic frames at ``size`` (colour-coded labels with ``colour``;
    ``micro_batches``: this rank's share of each of a K-step
    accumulation's micro-batches)."""
    from rtsds_tpu_torch.data.multihost import MultiHostDataLoader

    ds = SyntheticSegDataset(n, size, CLASSES, seed=seed, fixed_tints=True)
    if colour:
        ds = ColorCodedLabels(ds, class_colors_for_remap(),
                              unmatched=UNMATCHED, seed=SEED)
    return MultiHostDataLoader(ds, TRAIN_BATCH, shuffle=shuffle,
                               num_workers=4, seed=SEED, infinite=infinite,
                               drop_last=drop_last,
                               micro_batches=micro_batches)


class _StepClock(Callback):
    """Each step's loss logs and the host time between steps (the loops
    read a step's metrics after launching the next one, so in steady
    state that is one step's time)."""

    def __init__(self):
        self.logs, self.stamps = [], []

    def on_batch_end(self, batch, logs=None):
        self.logs.append(dict(logs))
        self.stamps.append(time.perf_counter())

    def step_ms(self) -> float:
        gaps = [(b - a) * 1e3 for a, b in zip(self.stamps, self.stamps[1:])]
        return statistics.median(gaps[1:] or gaps)


def _par_validation_spy():
    """Records each validation's own (this rank's) K1 matrix and the
    all-reduced one ``validate`` reads."""
    from rtsds_tpu_torch.eval import validate as val_mod

    seen, reduce = [], val_mod.global_sum

    def spy(hist):
        total = reduce(hist)
        seen.append((hist.cpu().numpy().copy(), total.cpu().numpy().copy()))
        return total
    return val_mod, reduce, spy, seen


def _param_bits(*models) -> torch.Tensor:
    """Per parameter, the sum of its float32 bit patterns as int64: equal on
    two ranks when their parameters are bit-identical."""
    return torch.stack([p.detach().float().contiguous().view(torch.int32)
                        .long().sum() for m in models
                        for p in m.parameters()])


def _par_rank(rank: int, world: int) -> dict:
    """One rank of the shared-card phase (gloo on CUDA tensors): the
    float64 steps, then bf16 at full width through the trainers on this
    rank's shards of global b8: supervised (GTA5 720x1280, colour-coded
    labels, K2) and DA v1 (target 512x1024), each 2 epochs of PAR_STEPS
    steps validated at 512x1024 (K1), with every K1 matrix recorded, the
    launches counted and the parameters' bit checksum compared across the
    ranks."""
    import torch.distributed as dist

    from rtsds_tpu_torch.parallel.distributed import data_group, replicate

    torch.cuda.set_device(0)
    _build.load()
    out = {"f64": _par_f64_steps(rank, world)}
    dev = torch.device("cuda")
    val_mod, reduce, spy, seen = _par_validation_spy()
    val_mod.global_sum = spy
    val_loader = _par_loader(TRAIN_VAL_BATCHES * TRAIN_BATCH, TRAIN_VAL_SIZE,
                             SEED + 5, False, shuffle=False,
                             drop_last=False)
    val_tf = make_transform(TRAIN_VAL_SIZE, CLASSES, antialias=True)

    def val_batches(epoch):
        return device_batches(val_loader, val_tf, dev)

    aug = AugmentConfig.from_config(load_config())
    src_tf = make_transform(TRAIN_SIZE, CLASSES, antialias=False,
                            augment_cfg=aug, decode_label_colors=True)
    try:
        # supervised
        config = train_config()
        loader = _par_loader(PAR_STEPS * TRAIN_BATCH, TRAIN_SIZE, SEED + 81,
                             True)
        state = build_supervised(config, "bisenet", len(loader), dev,
                                 seed=SEED)
        replicate(state.model)
        clock = _StepClock()
        fast_hist_cuda.launches = rgb_to_train_ids_cuda.launches = 0
        _, history = supervised_fit(
            state, make_train_step(19),
            lambda epoch: device_batches(loader, src_tf, dev, seed=SEED,
                                         epoch=epoch),
            val_batches, epochs=TRAIN_EPOCHS, num_classes=CLASSES,
            callbacks=[clock], device=dev)
        torch.cuda.synchronize()
        out["supervised"] = {
            "losses": [e["train_loss"] for e in clock.logs],
            "miou": [h["validation_mIoU"] for h in history],
            "step_ms": clock.step_ms(),
            "launches": {"fast_hist_cuda": fast_hist_cuda.launches,
                         "rgb_to_train_ids_cuda":
                             rgb_to_train_ids_cuda.launches}}
        bits = [_param_bits(state.model)]
        del state
        # DA v1
        config = da_config()
        tcfg = config.training["domain_adaptation"]
        src = _par_loader(PAR_STEPS * TRAIN_BATCH, TRAIN_SIZE, SEED + 82,
                          True, infinite=True)
        tgt = _par_loader(PAR_STEPS * TRAIN_BATCH, DA_TGT_SIZE, SEED + 83,
                          False, infinite=True)
        tgt_tf = make_transform(DA_TGT_SIZE, CLASSES, antialias=True)
        gen, dis = build_adversarial(config, dev, seed=SEED)
        replicate(gen.model, dis.model)
        clock = _StepClock()
        source_iter = device_batches(src, src_tf, dev, seed=SEED)
        target_iter = device_batches(tgt, tgt_tf, dev)
        fast_hist_cuda.launches = rgb_to_train_ids_cuda.launches = 0
        with contextlib.closing(source_iter), \
                contextlib.closing(target_iter):
            _, _, history = adversarial_fit(
                gen, dis, make_adversarial_step(
                    float(tcfg["lambda"]), PAR_STEPS, DA_EPOCHS, 19, "v1"),
                source_iter, target_iter, val_batches, iterations=PAR_STEPS,
                epochs=DA_EPOCHS, num_classes=CLASSES, callbacks=[clock],
                device=dev)
        torch.cuda.synchronize()
        out["da"] = {
            "losses": clock.logs,
            "miou": [h["validation_mIoU"] for h in history],
            "step_ms": clock.step_ms(),
            "launches": {"fast_hist_cuda": fast_hist_cuda.launches,
                         "rgb_to_train_ids_cuda":
                             rgb_to_train_ids_cuda.launches}}
        bits.append(_param_bits(gen.model, dis.model))
    finally:
        val_mod.global_sum = reduce
    # bit-identical parameters on every rank: the checksums' max == min
    flat = torch.cat(bits)
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=data_group())
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=data_group())
    out["params_bit_identical"] = bool(torch.equal(hi, lo))
    out["validations"] = seen
    return out


def phase_parallel_shared_card() -> dict:
    """(a) Two ranks share the card under gloo (CUDA tensors on cuda:0):
    the float64 supervised and DA v1 steps held against one process's step
    on the global batch, then bf16 at full width (global b8) through the
    trainers; returns the K1/K2 launches of each path, summed over the
    ranks."""
    from rtsds_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    ranks = run_ranks(_par_rank, PAR_WORLD, timeout_s=PAR_TIMEOUT_S,
                      threads=None)
    ranks_s = time.perf_counter() - t0
    one = _par_f64_steps(0, 1)
    held = {name: _held_to(ranks[0]["f64"][name], one[name])
            for name in ("supervised", "da_v1")}
    for name in held:  # the ranks' own results agree exactly
        for a, b in zip(ranks[0]["f64"][name]["after"],
                        ranks[1]["f64"][name]["after"]):
            if any(not torch.equal(a[k], b[k]) for k in a):
                raise AssertionError(f"{name}: the ranks' states differ")
    launches = {}
    for path in ("supervised", "da"):
        runs = [r[path] for r in ranks]
        losses = [v for r in runs for e in r["losses"]
                  for v in ([e] if isinstance(e, float) else
                            [e[k] for k in e if k.startswith("loss_")])]
        if len(runs[0]["losses"]) != TRAIN_EPOCHS * PAR_STEPS or not all(
                math.isfinite(x) for x in losses):
            raise AssertionError(f"{path}: losses {runs[0]['losses']}")
        if runs[0]["losses"] != runs[1]["losses"] or \
                runs[0]["miou"] != runs[1]["miou"]:
            raise AssertionError(f"{path}: the ranks report different "
                                 f"metrics")
        launches[path] = {k: sum(r["launches"][k] for r in runs)
                          for k in runs[0]["launches"]}
    if not all(r["params_bit_identical"] for r in ranks):
        raise AssertionError("the ranks' parameters are not bit-identical")
    checked = 0
    for v0, v1 in zip(ranks[0]["validations"], ranks[1]["validations"]):
        if not (np.array_equal(v0[0] + v1[0], v0[1])
                and np.array_equal(v0[1], v1[1])
                and not np.array_equal(v0[0], v1[0])):
            raise AssertionError("a validation's rank matrices do not sum "
                                 "to the all-reduced one")
        checked += 1
    emit({"phase": "parallel_shared_card", "ranks": PAR_WORLD,
          "backend": "gloo on CUDA tensors, both ranks on cuda:0",
          "float64_vs_one_process": held,
          "bf16": {"image_size": list(TRAIN_SIZE),
                   "target_size": list(DA_TGT_SIZE),
                   "global_batch": TRAIN_BATCH,
                   "steps": TRAIN_EPOCHS * PAR_STEPS},
          "supervised_losses": ranks[0]["supervised"]["losses"],
          "supervised_miou": ranks[0]["supervised"]["miou"],
          "da_miou": ranks[0]["da"]["miou"],
          "params_bit_identical_across_ranks": True,
          "validations_checked": checked,
          "shared_card_step_ms_not_a_scaling_figure": {
              "supervised": [r["supervised"]["step_ms"] for r in ranks],
              "da_v1": [r["da"]["step_ms"] for r in ranks]},
          "ranks_s": ranks_s, "launches": launches})
    return launches


@contextlib.contextmanager
def forced_data_axis():
    """The data axis forced on at world size 1, where every collective of
    ``parallel/distributed.py`` would skip itself: ``data_parallel`` (as
    ``cli.main --multihost`` enters it) names the whole process group
    whatever its size.  Yields the count of each collective called."""
    import torch.distributed as dist

    from rtsds_tpu_torch.parallel import distributed

    calls = {"all_reduce": 0, "broadcast": 0, "barrier": 0}
    plain = {name: getattr(dist, name) for name in calls}

    def counted(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return plain[name](*args, **kwargs)
        return call

    @contextlib.contextmanager
    def forced(group=None, model_group=None):
        previous = distributed._GROUP, distributed._JOB
        distributed._GROUP = group if group is not None else dist.group.WORLD
        distributed._JOB = dist.group.WORLD
        try:
            yield
        finally:
            distributed._GROUP, distributed._JOB = previous

    plain_context = distributed.data_parallel
    distributed.data_parallel = forced
    for name in calls:
        setattr(dist, name, counted(name))
    try:
        yield calls
    finally:
        distributed.data_parallel = plain_context
        for name, fn in plain.items():
            setattr(dist, name, fn)


def _nccl_forced_sync_check() -> dict:
    """NCCL at world size 1 with the data axis forced on (the collectives
    skip themselves at one rank otherwise): the global-batch BN's output,
    statistics and gradients against ``nn.BatchNorm2d`` on the card in
    float64, a gradient all-reduce and a metrics reduction, and one bf16
    step of BiSeNet-R18 at 720x1280 b8 with every collective of the data
    axis (global-batch BN, the gradient all-reduce, the metrics
    reduction), timed beside the plain step (cuDNN's BN, no collective)."""
    import torch.distributed as dist

    from rtsds_tpu_torch.parallel import distributed
    from rtsds_tpu_torch.parallel.mesh import initialize_multihost

    os.environ["RTSDS_NUM_PROCESSES"] = "1"
    initialize_multihost(device_type="cuda")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}")
        distributed._GROUP = distributed._JOB = dist.group.WORLD
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        x = torch.randn(4, 8, 9, 11, device="cuda", dtype=torch.float64,
                        generator=gen)
        dy = torch.randn(x.shape, device="cuda", dtype=torch.float64,
                         generator=gen)
        plain = torch.nn.BatchNorm2d(8).cuda().double()
        synced = distributed.convert_global_batchnorm(
            torch.nn.Sequential(torch.nn.BatchNorm2d(8))).cuda().double()
        errs = {}
        xs = [x.clone().requires_grad_(True) for _ in range(2)]
        ys = [plain(xs[0]), synced(xs[1])]
        for y in ys:
            (y * dy).sum().backward()
        pairs = {"y": (ys[1], ys[0]), "x_grad": (xs[1].grad, xs[0].grad),
                 "running_var": (synced[0].running_var, plain.running_var),
                 "weight_grad": (synced[0].weight.grad, plain.weight.grad)}
        for k, (a, b) in pairs.items():
            errs[k] = float((a - b).detach().abs().max())
            if not torch.allclose(a, b, rtol=1e-9, atol=1e-12):
                raise AssertionError(f"global BN under NCCL: {k} {errs[k]}")
        p = torch.nn.Parameter(torch.ones(3, device="cuda"))
        p.grad = torch.full((3,), 2.0, device="cuda")
        distributed.all_reduce_gradients([p])
        reduced = distributed.reduce_metrics(
            {"train_loss": torch.tensor(1.5, device="cuda"), "total": 4})
        if not (torch.equal(p.grad, torch.full((3,), 2.0, device="cuda"))
                and float(reduced["train_loss"]) == 1.5
                and reduced["total"] == 4):
            raise AssertionError("NCCL all-reduces at world size 1")
        config = train_config()
        batch = _full_size_batch()
        times = {}
        for name, sync in (("plain", False), ("data_axis_forced", True)):
            state = build_supervised(config, "bisenet", 1, "cuda",
                                     seed=SEED)
            if sync:
                distributed.convert_global_batchnorm(state.model)
            else:
                distributed._GROUP = distributed._JOB = None
            step = make_train_step(19)
            times[name] = cuda_ms(lambda: step(state, *batch), reps=10)
            distributed._GROUP = distributed._JOB = dist.group.WORLD
            del state
        return {"bn_max_abs_err": errs, "step_ms": times}
    finally:
        distributed._GROUP = distributed._JOB = None
        dist.destroy_process_group()
        os.environ.pop("RTSDS_NUM_PROCESSES", None)


def _full_size_batch() -> tuple:
    """One normalized GTA5-size batch (b8, 720x1280) with its labels, on
    the card."""
    ds = SyntheticSegDataset(TRAIN_BATCH, TRAIN_SIZE, CLASSES,
                             seed=SEED + 84, fixed_tints=True)
    images = normalize(torch.from_numpy(np.stack(
        [ds[i][0] for i in range(TRAIN_BATCH)])).cuda())
    labels = torch.from_numpy(np.stack(
        [ds[i][1] for i in range(TRAIN_BATCH)])).cuda()
    return images, labels


def phase_parallel_nccl_cli() -> dict:
    """(b) NCCL at world size 1: ``python -m rtsds_tpu_torch.cli
    --multihost`` (``RTSDS_NUM_PROCESSES=1``) trains BiSeNet-R18 at
    720x1280 b8 bf16 on colour-coded labels (K2) for 2 steps and validates
    at 512x1024 (K1), rank 0 saving the checkpoint, with the data axis
    forced on (:func:`forced_data_axis`), so that the broadcast of the
    initial state, the global-batch BN, the gradient and metrics
    all-reduces, the confusion matrix's all-reduce and the barriers after
    the saves run under NCCL through the CLI; then
    :func:`_nccl_forced_sync_check`, whose step times are the phase's.
    Returns the CLI path's launches."""
    from rtsds_tpu_torch import cli

    tmp = tempfile.TemporaryDirectory(prefix="rtsds_smoke_nccl_")
    config = os.path.join(tmp.name, "config.yaml")
    with open(config, "w") as f:
        f.write(f"""
precision: {{compute_dtype: bfloat16}}
data:
  cityscapes: {{image_size: "{TRAIN_VAL_SIZE[0]}, {TRAIN_VAL_SIZE[1]}",
               batch_size: {TRAIN_BATCH}, num_workers: 4}}
  gta5_modified: {{image_size: "{TRAIN_SIZE[0]}, {TRAIN_SIZE[1]}",
                  batch_size: {TRAIN_BATCH}, num_workers: 4,
                  decode_label_colors: true}}
training:
  segmentation: {{epochs: 1, do_validation: 1}}
callbacks:
  model_checkpoint: {{save_dir: "{tmp.name}", save_name: "m",
                     save_best: true}}
""")
    os.environ["RTSDS_NUM_PROCESSES"] = "1"
    try:
        with forced_data_axis() as collectives:
            t0 = time.perf_counter()
            history, launches, _ = on_main_path(lambda: cli.main(
                ["--config", config, "--synthetic", "--dataset", "gta5",
                 "--multihost"]))
            cli_s = time.perf_counter() - t0
    finally:
        os.environ.pop("RTSDS_NUM_PROCESSES", None)
    saved = sorted(os.listdir(os.path.join(tmp.name, "m")))
    if len(history) != 1 or not math.isfinite(history[0]["train_loss"]) \
            or "epoch_0.pt" not in saved:
        raise AssertionError(f"the --multihost run: {history}, {saved}")
    if not all(collectives.values()):
        raise AssertionError(f"the --multihost run's collectives under "
                             f"NCCL: {collectives}")
    torch.cuda.empty_cache()
    forced = _nccl_forced_sync_check()
    tmp.cleanup()
    emit({"phase": "parallel_nccl_world1", "cli": "--multihost",
          "backend": "nccl", "world_size": 1, "data_axis": "forced on",
          "history": history, "rank0_saved": saved, "cli_s": cli_s,
          "cli_collectives": collectives,
          "step_p50_ms": forced.pop("step_ms"), "forced_sync": forced,
          "launches": launches})
    return launches


def phase_parallel_serving(tree: dict, frames: np.ndarray) -> dict:
    """(c) A batch mesh of two replicas on cuda:0: BiSeNet-R18 at
    1024x2048 b8, its masks exactly those of one device at the per-device
    batch (b4) in bf16 and in float32, in float32 agreeing with one device
    at b8 on at least 0.999 of pixels (cuDNN picks algorithms per batch);
    in bf16 its ``predict_iter`` equal to ``predict`` and both timed in
    turns, and served through the HTTP server, each reply equal to
    ``predict``."""
    from rtsds_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(["cuda:0"] * 2)
    out = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        meshed = Predictor(variables=tree, image_size=SIZE,
                           batch_size=BATCH, dtype=dtype, mesh=mesh)
        per_device = Predictor(variables=tree, image_size=SIZE,
                               batch_size=BATCH // 2, dtype=dtype)
        got = meshed.predict(frames[:BATCH])
        if not np.array_equal(got, per_device.predict(frames[:BATCH])):
            raise AssertionError(f"{name}: the mesh's masks differ from one "
                                 f"device's at the per-device batch")
        out[f"{name}_predict_ms"] = cuda_ms(
            lambda: meshed.predict(frames[:BATCH]), reps=5)
        if dtype == torch.float32:
            single = Predictor(variables=tree, image_size=SIZE,
                               batch_size=BATCH, dtype=dtype)
            agree = float((got == single.predict(frames[:BATCH])).mean())
            out["f32_agreement_with_one_device_b8"] = agree
            out["f32_single_b8_predict_ms"] = cuda_ms(
                lambda: single.predict(frames[:BATCH]), reps=5)
            if agree < 0.999:
                raise AssertionError(f"f32 mesh vs b8: {agree}")
            del single
        else:
            batches = [frames[:BATCH], frames[BATCH:2 * BATCH]]
            streamed = list(meshed.predict_iter(iter(batches)))
            if not all(np.array_equal(g, meshed.predict(b))
                       for g, b in zip(streamed, batches)):
                raise AssertionError("the mesh's predict_iter != predict")
            out["bf16_ms_per_batch"] = stream_ms(meshed, batches)
            out["http"] = serve_over_http(meshed, frames)
        del meshed, per_device
        torch.cuda.empty_cache()
    emit({"phase": "parallel_serving", "model": "bisenet-resnet18",
          "image_size": list(SIZE), "batch": BATCH, "replicas": 2,
          "devices": "cuda:0 twice", **out})
    return out


def phase_parallel_pipe() -> dict:
    """(d) The pipelined DeepLabV2-R101 step, pipe 2 with both stages on
    cuda:0, M = 2: one float64 step at PIPE_F64_SIZE (b4) held against the
    accumulating step over the same 2 microbatches, then bf16 through
    ``supervised_fit`` at 720x1280 b8 on colour-coded labels (K2) for
    PIPE_STEPS steps, validated at 512x1024 on the placed model (K1), and
    the pipelined step timed beside the accumulating step.  Returns the
    path's launches."""
    from rtsds_tpu_torch.parallel.mesh import Mesh
    from rtsds_tpu_torch.train.accumulate import (
        make_accumulating_train_step, split_microbatches)
    from rtsds_tpu_torch.train.pipelined import make_pipelined_train_step

    mesh = Mesh(["cuda:0"] * 2, ("pipe",))
    config = load_config()
    ds = SyntheticSegDataset(4, PIPE_F64_SIZE, CLASSES, seed=SEED + 85,
                             fixed_tints=True)
    images = normalize(torch.from_numpy(np.stack(
        [ds[i][0] for i in range(4)]))).double().cuda()
    labels = torch.from_numpy(np.stack([ds[i][1] for i in range(4)])).cuda()
    labels[:, :3] = 19
    runs = {}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        for name in ("pipelined", "accumulate"):
            model, frozen = make_segmentor(config, "deeplab", seed=SEED)
            model.to("cuda", torch.float64)
            state = TrainState(model, make_optimizer(
                "SGD", model.parameters(), 0.01, momentum=0.9,
                frozen=frozen))
            before = {k: v.detach().cpu().clone()
                      for k, v in model.named_parameters()}
            if name == "pipelined":
                loss = make_pipelined_train_step(model, mesh, 19, 2)(
                    state, images, labels)["train_loss"]
            else:
                loss = make_accumulating_train_step(19)(
                    state, split_microbatches(images, 2),
                    split_microbatches(labels, 2))["train_loss"]
            runs[name] = {"losses": {"train_loss": float(loss)},
                          "before": [before],
                          "after": [{k: v.detach().cpu() for k, v in
                                     model.state_dict().items()}]}
            del model, state
    held = _held_to(runs["pipelined"], runs["accumulate"])
    torch.cuda.empty_cache()

    dev = torch.device("cuda")
    config = load_config(overrides={
        "precision": {"compute_dtype": "bfloat16"},
        "training": {"segmentation": {"epochs": 1, "do_validation": 1}}})
    loader, transform = _gta5_stream(PIPE_STEPS * TRAIN_BATCH, SEED + 86)
    state = build_supervised(config, "deeplab", len(loader), dev, seed=SEED)
    step = make_pipelined_train_step(state.model, mesh, 19, 2)
    clock = _StepClock()
    torch.cuda.reset_peak_memory_stats()
    (_, history), launches, checked = on_main_path(lambda: supervised_fit(
        state, step, lambda epoch: device_batches(loader, transform, dev,
                                                  seed=SEED, epoch=epoch),
        _val_stream(), epochs=1, num_classes=CLASSES, callbacks=[clock],
        device=dev))
    losses = [e["train_loss"] for e in clock.logs]
    if len(losses) != PIPE_STEPS or not all(map(math.isfinite, losses)) \
            or not 0.0 <= history[0]["validation_mIoU"] <= 1.0:
        raise AssertionError(f"pipelined run: {losses} {history}")
    batch = _full_size_batch()
    pipe_ms = cuda_ms(lambda: step(state, *batch), reps=5)
    acc = make_accumulating_train_step(19)
    acc_ms = cuda_ms(lambda: acc(state, split_microbatches(batch[0], 2),
                                 split_microbatches(batch[1], 2)), reps=5)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, step
    torch.cuda.empty_cache()
    emit({"phase": "parallel_pipe", "model": "deeplabv2-resnet101",
          "stages": 2, "stage_devices": "cuda:0 twice", "microbatches": 2,
          "float64_vs_accumulate": held, "image_size": list(TRAIN_SIZE),
          "batch": TRAIN_BATCH, "dtype": "bfloat16", "losses": losses,
          "validation_mIoU": history[0]["validation_mIoU"],
          "k2_outputs_checked": checked, "pipelined_step_p50_ms": pipe_ms,
          "accumulate_step_p50_ms": acc_ms, "peak_gb": peak_gb,
          "launches": launches})
    return launches


# --- the parallel phase, continued: self-training, distillation and QAT on
# two ranks and under NCCL through the CLI (ROADMAP 17.1); spatial serving
# on a 2-band mesh (ROADMAP 17.2) ---------------------------------------------

EXTRA_STEPS = 2            # per path, one epoch, global b8
EXTRA_TIMEOUT_S = 480      # the spawn of the two ranks
SPATIAL_F64_SIZE = (256, 512)
SPATIAL_REPS = 10          # per timed b1 predict
# least share of equal mask pixels, bands against one device, in float32
# (TF32 off).  In bf16 and int8 the first card runs read 0.9763 (BiSeNet
# bf16) and 0.7851 (DeepLab bf16; PERF.md): random weights leave
# near-tied top-two logits, and any other rounding of a conv (cuDNN picks
# its algorithm by the band's shape) flips their argmax, as a yardstick
# shows: one device at b1 against itself at b2 (another cuDNN algorithm,
# the same frame) read 0.8344 for DeepLab bf16.  So the bands must agree
# within SPATIAL_YARDSTICK_MARGIN of the yardstick; a broken band path
# agrees on about one pixel in CLASSES.  The served int8 masks (0.5986 for
# DeepLab in the first run, where the yardstick's bf16 convs happened to
# round alike: 1.0) are held to MIN_INT8_AGREEMENT, the int8-vs-bf16
# floor of the same random nets, and the int8 wiring on bands to its
# float64 walk (spatial_int8_walk_check)
MIN_SPATIAL_AGREEMENT = 0.999
SPATIAL_YARDSTICK_MARGIN = 0.1


def _f64_model(config, name: str, seed: int):
    model, frozen = make_segmentor(config, name, seed=seed)
    return model.to("cuda", torch.float64), frozen


def _states(*models) -> list:
    return [{k: v.detach().cpu().clone() for k, v in m.state_dict().items()}
            for m in models]


def _named(*models) -> list:
    return [{k: v.detach().cpu().clone() for k, v in m.named_parameters()}
            for m in models]


def _extras_f64(rank: int, world: int, qat_scales: dict) -> dict:
    """Float64 steps on the card at PAR_F64_SIZE, on this rank's shard of
    :func:`_par_f64_inputs` (with ``world`` 1, the global batch): the
    self-training step (ClassMix on scores drawn for the global target
    batch, FDA, MinEnt), distillation under a float DeepLabV2-R101
    teacher, the int8-teacher step and the QAT step on ``qat_scales``;
    and, from the shards, the CBST thresholds and the int8 teacher's
    activation scales under max and percentile."""
    from rtsds_tpu_torch.parallel.distributed import replicate
    from rtsds_tpu_torch.train.distill import (
        make_distill_step, quantize_teacher)
    from rtsds_tpu_torch.train.ema import ema_init
    from rtsds_tpu_torch.train.qat import QATSegmentor
    from rtsds_tpu_torch.train.self_training import (
        calibrate_class_thresholds, classmix_scores, make_self_training_step)

    images, labels, target = _par_f64_inputs()
    n = images.shape[0] // world
    part = slice(rank * n, (rank + 1) * n)
    x, y, t = (a[part].cuda() for a in (images, labels, target))
    config = load_config()
    out = {}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        gen, _ = _f64_model(config, "bisenet", SEED)
        dis = make_discriminator(
            config.model["adversarial_model"]["discriminator"],
            seed=SEED + 1).to("cuda", torch.float64)
        replicate(gen, dis)
        out["cbst"] = calibrate_class_thresholds(gen, [t], CLASSES).tolist()
        g = TrainState(gen, make_optimizer("SGD", gen.parameters(), 0.01,
                                           momentum=0.0))
        d = TrainState(dis, make_optimizer("SGD", dis.parameters(), 0.02,
                                           momentum=0.0))
        before = _named(gen, dis)
        ema = ema_init(gen)
        metrics = make_self_training_step(
            0.1, DA_ITERATIONS, 19, threshold=0.1, ema_decay=0.99,
            lambda_ent=0.05, fda_beta=0.05, classmix=True,
            classmix_seed=SEED)(g, d, ema, x, y, t,
                                scores=classmix_scores(SEED, 0, 4, CLASSES))
        out["self_training"] = {
            "losses": {k: float(v) for k, v in metrics.items()
                       if k.startswith("loss_") or k.endswith("coverage")},
            "before": before, "after": _states(gen, dis)}
        del gen, dis, g, d, ema

        teacher, _ = _f64_model(config, "deeplab", SEED + 22)
        teacher.eval()
        t32 = {k: v.float() for k, v in teacher.state_dict().items()}
        calib = [x.float().permute(0, 3, 1, 2)]
        out["int8_scales"] = {
            stat: quant.quantize_model(
                "deeplab", t32, calib, calib_stat=stat,
                calib_percentile=99.0, device="cuda").act_scales
            for stat in ("max", "percentile")}
        int8_teacher = quantize_teacher("deeplab", t32, calib,
                                        device="cuda")
        for name, tch in (("distillation", teacher),
                          ("distillation_int8", int8_teacher)):
            student, _ = _f64_model(config, "bisenet", SEED)
            replicate(student)
            s = TrainState(student, make_optimizer(
                "SGD", student.parameters(), 0.01, momentum=0.0))
            before = _named(student)
            metrics = make_distill_step(tch, 19)(s, x, y)
            out[name] = {"losses": {k: float(metrics[k]) for k in (
                "train_loss", "loss_ce", "loss_distill")},
                "before": before, "after": _states(student)}
            del student, s
        del teacher, int8_teacher

        student, _ = make_segmentor(config, "bisenet", seed=SEED)
        prep = prepare_qat("bisenet", student.state_dict(), calib,
                           device="cuda")
        out["qat_scales"] = dict(prep.act_scales)
        qat = QATSegmentor(prep._replace(act_scales=qat_scales)).to(
            torch.float64)
        s = TrainState(qat, make_optimizer("SGD", qat.parameters(), 0.1,
                                           momentum=0.0))
        before = _named(qat)
        metrics = make_train_step(19)(s, x, y)
        out["qat"] = {"losses": {"train_loss": float(metrics["train_loss"])},
                      "before": before, "after": _states(qat)}
    return out


def _extras_fit(run, clock) -> dict:
    """``run()`` (a trainer's fit) with K1's and K2's counts from zero:
    its losses, mIoU, step time and launches."""
    fast_hist_cuda.launches = rgb_to_train_ids_cuda.launches = 0
    history = run()[-1]
    torch.cuda.synchronize()
    return {"losses": clock.logs,
            "miou": [h["validation_mIoU"] for h in history],
            "launches": {"fast_hist_cuda": fast_hist_cuda.launches,
                         "rgb_to_train_ids_cuda":
                             rgb_to_train_ids_cuda.launches}}


def _extras_rank(rank: int, world: int, qat_scales: dict) -> dict:
    """One rank of the 17.1 phase (gloo on CUDA tensors, both ranks on
    cuda:0): the float64 steps, then bf16 at full width through the
    trainers on this rank's shards of global b8 (GTA5 720x1280 with
    colour-coded labels, K2; target 512x1024), each one epoch of
    EXTRA_STEPS steps validated at 512x1024 (K1): self-training (CBST on
    the rank's shards of 2 target batches, ClassMix, FDA, MinEnt, EMA),
    distillation under a bf16 DeepLabV2-R101 teacher and under its int8
    form (calibrated over the ranks), and the QAT step of BiSeNet-R18."""
    import torch.distributed as dist

    from rtsds_tpu_torch.parallel.distributed import data_group, replicate
    from rtsds_tpu_torch.train.distill import (
        make_distill_step, quantize_teacher)
    from rtsds_tpu_torch.train.self_training import (
        calibrate_class_thresholds, make_self_training_step)

    torch.cuda.set_device(0)
    _build.load()
    out = {"f64": _extras_f64(rank, world, qat_scales)}
    dev = torch.device("cuda")
    val_loader = _par_loader(TRAIN_VAL_BATCHES * TRAIN_BATCH, TRAIN_VAL_SIZE,
                             SEED + 5, False, shuffle=False, drop_last=False)
    val_tf = make_transform(TRAIN_VAL_SIZE, CLASSES, antialias=True)

    def val_batches(epoch):
        return device_batches(val_loader, val_tf, dev)

    aug = AugmentConfig.from_config(load_config())
    src_tf = make_transform(TRAIN_SIZE, CLASSES, antialias=False,
                            augment_cfg=aug, decode_label_colors=True)
    tgt_tf = make_transform(DA_TGT_SIZE, CLASSES, antialias=True)
    bits = []

    # self-training
    config = _extras_config(domain_adaptation={
        "epochs": 1, "iterations": EXTRA_STEPS, "do_validation": 1})
    gen, dis = build_adversarial(config, dev, seed=SEED)
    replicate(gen.model, dis.model)
    cal = _par_loader(2 * TRAIN_BATCH, DA_TGT_SIZE, SEED + 87, False)
    thr = calibrate_class_thresholds(
        gen.model, device_batches(cal, tgt_tf, dev), CLASSES,
        compute_dtype=gen.compute_dtype)
    src = _par_loader(EXTRA_STEPS * TRAIN_BATCH, TRAIN_SIZE, SEED + 88,
                      True, infinite=True)
    tgt = _par_loader(EXTRA_STEPS * TRAIN_BATCH, DA_TGT_SIZE, SEED + 89,
                      False, infinite=True)
    step = make_self_training_step(
        float(config.training["domain_adaptation"]["lambda"]), EXTRA_STEPS,
        19, threshold=thr, ema_decay=0.999, lambda_ent=0.005, fda_beta=0.01,
        classmix=True, classmix_seed=SEED)
    clock = _StepClock()
    source_iter = device_batches(src, src_tf, dev, seed=SEED)
    target_iter = device_batches(tgt, tgt_tf, dev)
    with contextlib.closing(source_iter), contextlib.closing(target_iter):
        out["self_training"] = _extras_fit(lambda: adversarial_fit(
            gen, dis, step, source_iter, target_iter, val_batches,
            iterations=EXTRA_STEPS, epochs=1, num_classes=CLASSES,
            callbacks=[clock], device=dev, ema_decay=0.999,
            ema_in_step=True), clock)
    out["self_training"]["thresholds"] = thr.tolist()
    bits.append(_param_bits(gen.model, dis.model))
    del gen, dis, step

    # distillation: the bf16 teacher, its int8 form, then QAT
    config = load_config(overrides={
        "precision": {"compute_dtype": "bfloat16"},
        "training": {"segmentation": {"epochs": 1, "do_validation": 1}}})
    teacher, _ = make_segmentor(config, "deeplab", seed=SEED + 22)
    teacher.to(dev).eval()
    loader = _par_loader(EXTRA_STEPS * TRAIN_BATCH, TRAIN_SIZE, SEED + 90,
                         True)

    def batches(epoch):
        return device_batches(loader, src_tf, dev, seed=SEED, epoch=epoch)

    calib = []
    for images, _ in batches(0):
        calib.append(images.permute(0, 3, 1, 2))
    loader.set_epoch(0)
    teachers = {"distillation": teacher,
                "distillation_int8": quantize_teacher(
                    "deeplab", teacher.state_dict(), calib, device=dev)}
    for name, tch in teachers.items():
        state = build_supervised(config, "bisenet", len(loader), dev,
                                 seed=SEED)
        replicate(state.model)
        clock = _StepClock()
        out[name] = _extras_fit(lambda: supervised_fit(
            state, make_distill_step(tch, 19), batches, val_batches,
            epochs=1, num_classes=CLASSES, callbacks=[clock], device=dev),
            clock)
        bits.append(_param_bits(state.model))
        del state
    del teachers, teacher
    student, _ = make_segmentor(config, "bisenet", seed=SEED)
    prep = prepare_qat("bisenet", student.state_dict(), calib, device=dev)
    state = create_qat_state(prep, 1e-5, "SGD")
    clock = _StepClock()
    out["qat"] = _extras_fit(lambda: supervised_fit(
        state, make_train_step(19), batches, val_batches, epochs=1,
        num_classes=CLASSES, callbacks=[clock], device=dev), clock)
    bits.append(_param_bits(state.model))
    flat = torch.cat(bits)
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=data_group())
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=data_group())
    out["params_bit_identical"] = bool(torch.equal(hi, lo))
    return out


EXTRA_PATHS = ("self_training", "distillation", "distillation_int8", "qat")


def _scales_rel_diff(a: dict, b: dict) -> float:
    if sorted(a) != sorted(b):
        raise AssertionError("the activation scales name other convs")
    return max(abs(a[k] - b[k]) / b[k] for k in b)


def phase_parallel_extras() -> dict:
    """(e) Self-training, distillation (bf16 and int8 teachers) and QAT on
    two ranks sharing the card under gloo: the float64 steps held against
    one process's on the global batch at the card-vs-CPU limits, the CBST
    thresholds equal, the int8 teacher's scales (gloo's MAX on CUDA
    tensors, the summed percentile histogram) against one process's; then
    bf16 at full width through the trainers (:func:`_extras_rank`), the
    ranks' metrics equal and parameters bit-identical.  Returns each
    path's K1/K2 launches, summed over the ranks."""
    from rtsds_tpu_torch.parallel.launch import run_ranks

    student, _ = make_segmentor(load_config(), "bisenet", seed=SEED)
    images, _, _ = _par_f64_inputs()
    qat_scales = dict(prepare_qat(
        "bisenet", student.state_dict(),
        [images.float().permute(0, 3, 1, 2).cuda()],
        device="cuda").act_scales)
    del student
    t0 = time.perf_counter()
    ranks = run_ranks(_extras_rank, PAR_WORLD, (qat_scales,),
                      timeout_s=EXTRA_TIMEOUT_S, threads=None)
    ranks_s = time.perf_counter() - t0
    one = _extras_f64(0, 1, qat_scales)
    got = ranks[0]["f64"]
    held = {name: _held_to(got[name], one[name])
            for name in ("self_training", "distillation",
                         "distillation_int8", "qat")}
    for name in held:
        for a, b in zip(got[name]["after"], ranks[1]["f64"][name]["after"]):
            if any(not torch.equal(a[k], b[k]) for k in a):
                raise AssertionError(f"{name}: the ranks' states differ")
    if got["cbst"] != one["cbst"] or ranks[1]["f64"]["cbst"] != one["cbst"]:
        raise AssertionError("CBST thresholds of 2 ranks != one process's")
    scales = {stat: _scales_rel_diff(got["int8_scales"][stat],
                                     one["int8_scales"][stat])
              for stat in ("max", "percentile")}
    scales["qat"] = _scales_rel_diff(got["qat_scales"], one["qat_scales"])
    if max(scales.values()) > 2.0 ** -6:
        raise AssertionError(f"activation scales of 2 ranks: {scales}")
    launches = {}
    for path in EXTRA_PATHS:
        runs = [r[path] for r in ranks]
        losses = [v for r in runs for e in r["losses"] for k, v in e.items()
                  if k.startswith("loss") or k == "train_loss"]
        if len(runs[0]["losses"]) != EXTRA_STEPS or not all(
                math.isfinite(v) for v in losses):
            raise AssertionError(f"{path}: losses {runs[0]['losses']}")
        if runs[0]["losses"] != runs[1]["losses"] or \
                runs[0]["miou"] != runs[1]["miou"]:
            raise AssertionError(f"{path}: the ranks report different "
                                 f"metrics")
        launches[path] = {k: sum(r["launches"][k] for r in runs)
                          for k in runs[0]["launches"]}
    if not all(r["params_bit_identical"] for r in ranks):
        raise AssertionError("the ranks' parameters are not bit-identical")
    emit({"phase": "parallel_extras", "ranks": PAR_WORLD,
          "backend": "gloo on CUDA tensors, both ranks on cuda:0",
          "float64_vs_one_process": held,
          "cbst_thresholds_equal": True,
          "scales_rel_diff_vs_one_process": scales,
          "bf16": {"image_size": list(TRAIN_SIZE),
                   "target_size": list(DA_TGT_SIZE),
                   "global_batch": TRAIN_BATCH, "steps": EXTRA_STEPS,
                   "teacher": "deeplabv2-resnet101",
                   "qat": "bisenet-resnet18, float32 fake-quant"},
          "losses": {p: ranks[0][p]["losses"] for p in EXTRA_PATHS},
          "miou": {p: ranks[0][p]["miou"] for p in EXTRA_PATHS},
          "params_bit_identical_across_ranks": True,
          "ranks_s": ranks_s, "launches": launches})
    return launches


def phase_parallel_extras_nccl_cli() -> dict:
    """(f) NCCL at world size 1 through the CLI with the data axis forced
    on (:func:`forced_data_axis`): ``--multihost --domain_adaptation`` with
    self-training (CBST over 2 target batches, ClassMix, FDA, MinEnt,
    EMA), and ``--multihost --dataset gta5`` distilling from the int8 form
    of a DeepLabV2-R101 teacher checkpoint (calibrated on 2 batches, the
    percentile histogram and max over the forced axis); each at 720x1280
    b8 bf16 (target 512x1024), colour-coded labels (K2), validated at
    512x1024 (K1).  Returns each path's launches."""
    from rtsds_tpu_torch import cli
    from rtsds_tpu_torch.callbacks.checkpoint import CheckpointManager

    tmp = tempfile.TemporaryDirectory(prefix="rtsds_smoke_nccl_x_")
    teacher, _ = make_segmentor(train_config(), "deeplab", seed=SEED + 22)
    teacher_dir = os.path.join(tmp.name, "teacher")
    CheckpointManager(teacher_dir).save(0, {"model": TrainState(
        teacher, make_optimizer("SGD", teacher.parameters(), 0.01))},
        monitor=0.5)
    del teacher
    base = f"""
precision: {{compute_dtype: bfloat16}}
data:
  cityscapes: {{image_size: "{TRAIN_VAL_SIZE[0]}, {TRAIN_VAL_SIZE[1]}",
               batch_size: {TRAIN_BATCH}, num_workers: 4}}
  gta5_modified: {{image_size: "{TRAIN_SIZE[0]}, {TRAIN_SIZE[1]}",
                  batch_size: {TRAIN_BATCH}, num_workers: 4,
                  decode_label_colors: true}}
callbacks:
  model_checkpoint: {{save_dir: "{tmp.name}", save_name: "m",
                     save_best: true}}
"""
    runs = {
        "self_training": ("""
training:
  domain_adaptation:
    epochs: 1
    iterations: 2
    do_validation: 1
    ema: {enabled: true}
    entropy_min: {enabled: true}
    fda: {enabled: true, beta: 0.01}
    self_training: {enabled: true, classmix: {enabled: true},
                    calibration: {enabled: true, batches: 2}}
""", ["--domain_adaptation"]),
        "distillation_int8": (f"""
training:
  segmentation:
    epochs: 1
    do_validation: 1
    distillation: {{enabled: true, teacher: {{model: deeplab,
                   checkpoint_dir: "{teacher_dir}", quantize: int8,
                   calib_batches: 2}}}}
""", ["--dataset", "gta5"])}
    out, launches = {}, {}
    os.environ["RTSDS_NUM_PROCESSES"] = "1"
    try:
        for name, (section, argv) in runs.items():
            config = os.path.join(tmp.name, f"{name}.yaml")
            with open(config, "w") as f:
                f.write(base + section)
            with forced_data_axis() as collectives:
                t0 = time.perf_counter()
                history, launches[name], _ = on_main_path(lambda: cli.main(
                    ["--config", config, "--synthetic", "--multihost",
                     *argv]))
                seconds = time.perf_counter() - t0
            torch.cuda.empty_cache()
            if len(history) != 1 or not all(
                    math.isfinite(v) for k, v in history[0].items()
                    if isinstance(v, float)):
                raise AssertionError(f"the --multihost {name} run: "
                                     f"{history}")
            if not all(collectives.values()):
                raise AssertionError(f"the --multihost {name} run's "
                                     f"collectives under NCCL: "
                                     f"{collectives}")
            out[name] = {"history": history, "cli_s": seconds,
                         "cli_collectives": dict(collectives),
                         "launches": launches[name]}
    finally:
        os.environ.pop("RTSDS_NUM_PROCESSES", None)
        tmp.cleanup()
    emit({"phase": "parallel_extras_nccl_world1", "cli": "--multihost",
          "backend": "nccl", "world_size": 1, "data_axis": "forced on",
          **out})
    return launches


def _spatial_pair(model: str, tree: dict, size, dtype, **kw) -> tuple:
    """A 2-band spatial Predictor on cuda:0 and its one-device twin (int8:
    the twin's calibrated scales served by both)."""
    from rtsds_tpu_torch.parallel.mesh import Mesh

    common = dict(model_name=model, variables=tree, image_size=size,
                  batch_size=1, dtype=dtype)
    one = Predictor(**common, **kw)
    if kw.get("quantize"):
        kw = {"quantize": kw["quantize"], "act_scales": one.act_scales}
    return (Predictor(mesh=Mesh(["cuda:0"] * 2), sharding="spatial",
                      **common, **kw), one)


def spatial_int8_walk_check(banded: Predictor, one: Predictor,
                            frame: np.ndarray) -> dict:
    """The served quantized tree's int8 walk with its dequantization and
    bf16-policy convs in float64 (``make_quant_op(out_dtype=float64)``) on
    one full-width frame, on 2 bands against one device.  In float32 the
    walk is chaotic on random weights: cuDNN picks another algorithm for a
    band's shape, and a conv's output 1e-5 apart flips int8 codes layer
    after layer (the first card run read 0.112 of the peak apart).  In
    float64 the quantizers' float32 inputs come out the same, so the
    walks must agree within INT8_WALK_ATOL_SHARE of their peak and on
    INT8_WALK_MIN_ARGMAX of the pixels (the card-vs-CPU walk's limits)."""
    from rtsds_tpu_torch.parallel import spatial

    eng = banded._spatial
    f64 = torch.float64
    ops = [quant.make_quant_op(r.qtree, f64) for r in eng.replicas]

    def op(name, h, stride, padding, dilation):
        if not isinstance(h, spatial.Bands):
            return ops[0](name, h, stride, padding, dilation)
        return spatial.banded_conv(
            h, eng._kernel_h[name], stride, padding, dilation,
            lambda rows, i, pad: ops[i](name, rows, stride, pad, dilation))

    with torch.inference_mode():
        x = torch.from_numpy(frame)
        got = spatial.gather(eng.replicas[0]._walk(
            op, banded._bands(x).to(f64)))
        want = one.model._walk(
            quant.make_quant_op(one.model.qtree, f64),
            normalize(x.cuda()).permute(0, 3, 1, 2).to(f64))
    peak = float(want.abs().max())
    result = {"dtype": "float64",
              "max_abs_err_over_peak": float((got - want).abs().max())
              / peak,
              "argmax_agreement": float((got.argmax(1) == want.argmax(1))
                                        .float().mean())}
    if (result["max_abs_err_over_peak"] > INT8_WALK_ATOL_SHARE
            or result["argmax_agreement"] < INT8_WALK_MIN_ARGMAX):
        raise AssertionError(f"float64 int8 walk on bands: {result}")
    return result


def _agreement_k1(a: np.ndarray, b: np.ndarray) -> float:
    """The share of equal pixels of two masks, from K1's confusion matrix
    of the pair on the card."""
    hist = fast_hist_cuda(torch.from_numpy(a).cuda(),
                          torch.from_numpy(b).cuda(), CLASSES)
    return float(hist.diagonal().sum()) / float(hist.sum())


def phase_spatial_serving(tree: dict, frames: np.ndarray, dl_tree: dict,
                          dl_frames: np.ndarray) -> dict:
    """(g) Spatial serving on a 2-band mesh on cuda:0 (ROADMAP 17.2), each
    model from its seeded tree at b1: BiSeNet-R18 at 1024x2048 and
    DeepLabV2-R101 at 512x1024.  Float64 at SPATIAL_F64_SIZE: the logits
    within 1e-10 of their peak of one device's; float32 at full size (TF32
    off) on ATen's convs: within 1e-4 of the peak, masks >= 0.999 equal;
    float32 on cuDNN: the same masks rule, the logits' gap measured; bf16
    and int8 (the one-device int8 predictor, the same scales): the masks'
    agreement, read from K1's confusion matrices, beside a yardstick (one
    device at b1 against b2): bf16 within SPATIAL_YARDSTICK_MARGIN of it,
    int8 above MIN_INT8_AGREEMENT and its float64 walk on bands held to
    one device's (:func:`spatial_int8_walk_check`); ``predict``
    at b1 timed beside one device's (one card: not a scaling figure).
    Returns K1's launches on the path (the agreements)."""
    out = {}
    fast_hist_cuda.launches = 0
    for model, t, fr, size in (("bisenet", tree, frames, SIZE),
                               ("deeplab", dl_tree, dl_frames,
                                DEEPLAB_SIZE)):
        res = {}
        small = np.ascontiguousarray(
            fr[:1, :SPATIAL_F64_SIZE[0], :SPATIAL_F64_SIZE[1]])
        # float32 twice: on ATen's own convs, whose sums do not depend on
        # the band's shape (the engine's check), and on cuDNN, which picks
        # another algorithm for a band's shape (as served; TF32 off)
        for name, dtype, x, cudnn, limit in (
                ("float64", torch.float64, small, True, 1e-10),
                ("float32_aten_convs", torch.float32, fr[:1], False, 1e-4),
                ("float32", torch.float32, fr[:1], True, None)):
            with torch.backends.cudnn.flags(enabled=cudnn, benchmark=False,
                                            deterministic=False,
                                            allow_tf32=False):
                banded, one = _spatial_pair(model, t, x.shape[1:3], dtype)
                got = banded.spatial_logits(x)
                with torch.inference_mode():
                    want = one.model(normalize(torch.from_numpy(x).cuda())
                                     .permute(0, 3, 1, 2).to(dtype))
            err = float((got - want).abs().max() / want.abs().max())
            masks = (got.argmax(1) == want.argmax(1)).float().mean()
            res[name] = {"size": list(x.shape[1:3]),
                         "max_err_over_peak": err,
                         "argmax_equal": float(masks)}
            if (limit is not None and err > limit) or (
                    dtype == torch.float32
                    and masks < MIN_SPATIAL_AGREEMENT):
                raise AssertionError(f"spatial {model} {name}: {res}")
            del banded, one, got, want
            torch.cuda.empty_cache()
        for name, kw in (("bfloat16", {}),
                         ("int8", {"quantize": "int8",
                                   "calib_frames": fr[:INT8_CALIB_BATCHES]})):
            banded, one = _spatial_pair(model, t, size, torch.bfloat16, **kw)
            want = one.predict(fr[:1])
            agree = _agreement_k1(banded.predict(fr[:1]), want)
            if kw:
                kw = {"quantize": "int8", "act_scales": one.act_scales}
            b2 = Predictor(model_name=model, variables=t, image_size=size,
                           batch_size=2, dtype=torch.bfloat16, **kw)
            res[name] = {"mask_agreement": agree,
                         "yardstick_one_device_b1_vs_b2": _agreement_k1(
                             b2.predict(fr[:1]), want)}
            del b2
            if name == "int8":
                res[name]["float64_walk"] = spatial_int8_walk_check(
                    banded, one, fr[:1])
                floor = MIN_INT8_AGREEMENT[model]
            else:
                floor = res[name]["yardstick_one_device_b1_vs_b2"] \
                    - SPATIAL_YARDSTICK_MARGIN
            if agree < floor:
                raise AssertionError(f"spatial {model} {name}: {res}")
            if name == "bfloat16":
                res["predict_b1_ms_one_card_not_a_scaling_figure"] = {
                    "two_bands": cuda_ms(lambda: banded.predict(fr[:1]),
                                         reps=SPATIAL_REPS),
                    "one_device": cuda_ms(lambda: one.predict(fr[:1]),
                                          reps=SPATIAL_REPS)}
            del banded, one
            torch.cuda.empty_cache()
        out[model] = res
    launches = fast_hist_cuda.launches
    emit({"phase": "spatial_serving", "bands": 2,
          "devices": "cuda:0 twice", "batch": 1,
          "bisenet_size": list(SIZE), "deeplab_size": list(DEEPLAB_SIZE),
          "k1_agreement_launches": launches, **out})
    return {"fast_hist_cuda": launches}


MODEL_WORLD = 2            # the model axis: two gloo ranks on cuda:0
MODEL_TIMEOUT_S = 600      # the spawn of the two ranks
MODEL_DL_BATCH = 2         # DeepLabV2-R101 on the model axis: global b2
MODEL_DL_STEPS = 2         # one epoch
MODEL_SERVE_SIZE = (512, 1024)
MODEL_RANK_LOSS_RTOL = 1e-4  # two ranks' bf16 forwards of one batch
SPATIAL_BANDS = 2
SPATIAL_STEP_REPS = 5      # per timed banded / one-device step
SPATIAL_DA_STEPS = 2       # one epoch
SPATIAL_DL_F64_SIZE = (64, 96)
SPATIAL_DL_BATCH = 2
SPATIAL_DL_STEPS = 2       # one epoch
SLIDING_WINDOW = (512, 1024)
SLIDING_REPS = 3           # per timed b1 sliding predict
F64_UPDATE_SHARE = 1e-10   # bands vs one device: of the largest update


def _gathered_bits(state) -> torch.Tensor:
    """:func:`_param_bits` of a train state's whole parameters (a model
    axis gathers its shards)."""
    sd = state.state_dict()["model"]
    return torch.stack([sd[k].detach().float().contiguous().view(
        torch.int32).long().sum() for k, _ in state.model.named_parameters()])


def _fsdp_bytes(state, model_name: str, config, world: int) -> dict:
    """A sharded state's resident bytes of parameters and Adam moments
    beside the replicated figure and the placement rule's reckoning."""
    from rtsds_tpu_torch.parallel.fsdp import placement_bytes

    whole, _ = make_segmentor(config, model_name, seed=SEED)
    return {"resident": state.optimizer.sharded.resident_bytes(
                state.optimizer),
            "placement_rule": placement_bytes(whole, world, moments=2),
            "replicated": placement_bytes(whole, 1, moments=2)}


def _model_rank(rank: int, world: int, ckpt_dir: str) -> dict:
    """One rank of the model-axis phase (gloo on CUDA tensors, both ranks
    on cuda:0, ``{model: world}``): the float64 steps, then bf16 at full
    width through ``supervised_fit`` on the same frames as the other rank:
    BiSeNet-R18 (GTA5 720x1280, global b8, colour-coded labels, K2; 2
    epochs of PAR_STEPS steps validated at 512x1024, K1; rank 0 writes the
    checkpoint) and DeepLabV2-R101 (global b2, one epoch); each with its
    bytes, launches and the gathered parameters' checksums."""
    import torch.distributed as dist

    from rtsds_tpu_torch.parallel.distributed import (
        axis_groups, data_parallel, job_group)
    from rtsds_tpu_torch.parallel.mesh import (
        make_mesh_from_config, place_state)

    torch.cuda.set_device(0)
    _build.load()
    dev = torch.device("cuda")
    out = {}
    with data_parallel(*axis_groups(world)):
        mesh = make_mesh_from_config({"model": world})
        out["f64"] = _par_f64_steps(0, 1, mesh)
        val_batches = _val_stream()
        runs = (("bisenet", train_config(), PAR_STEPS * TRAIN_BATCH,
                 TRAIN_BATCH, TRAIN_EPOCHS),
                ("deeplab", deeplab_config(), MODEL_DL_STEPS * MODEL_DL_BATCH,
                 MODEL_DL_BATCH, 1))
        bits = []
        for name, config, n, batch, epochs in runs:
            ds = ColorCodedLabels(SyntheticSegDataset(
                n, TRAIN_SIZE, CLASSES, seed=SEED + 91, fixed_tints=True),
                class_colors_for_remap(), unmatched=UNMATCHED, seed=SEED)
            loader = DataLoader(ds, batch, shuffle=True, num_workers=4,
                                seed=SEED)
            tf = make_transform(TRAIN_SIZE, CLASSES, antialias=False,
                                augment_cfg=AugmentConfig.from_config(
                                    config), decode_label_colors=True)
            state = place_state(build_supervised(
                config, name, len(loader), dev, seed=SEED), mesh)
            clock = _StepClock()
            checkpoint = ModelCheckpoint(save_dir=ckpt_dir, save_name=name,
                                         save_best=False) \
                if name == "bisenet" else None
            torch.cuda.reset_peak_memory_stats()
            (_, history), launches, checked = on_main_path(
                lambda: supervised_fit(
                    state, make_train_step(19),
                    lambda epoch: device_batches(
                        loader, tf, dev, seed=SEED, epoch=epoch),
                    val_batches, epochs=epochs, num_classes=CLASSES,
                    callbacks=[clock], checkpoint=checkpoint, device=dev))
            out[name] = {
                "losses": [e["train_loss"] for e in clock.logs],
                "miou": [h["validation_mIoU"] for h in history],
                "step_ms": clock.step_ms(), "launches": launches,
                "k2_checked": checked,
                "bytes": _fsdp_bytes(state, name, config, world),
                "peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20}
            bits.append(_gathered_bits(state))
            if name == "bisenet":
                out["served_state"] = {k: v.detach().cpu() for k, v in
                                       state.state_dict()["model"].items()}
            del state
            torch.cuda.empty_cache()
        flat = torch.cat(bits)
        hi, lo = flat.clone(), flat.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=job_group())
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=job_group())
        out["params_bit_identical"] = bool(torch.equal(hi, lo))
    if rank:
        out.pop("served_state")
    return out


def phase_parallel_model_axis(frames: np.ndarray) -> dict:
    """(h) The model axis (FSDP, ROADMAP 17.3): two gloo ranks on cuda:0
    with ``mesh: {model: 2}``, the all_reduce forms of the gather and the
    reduce-scatter; the float64 supervised and DA v1 steps against one
    process's replicated steps at the shared-card limits, then the bf16
    runs of :func:`_model_rank`; every rank's resident bytes equal to the
    placement rule's, the ranks' gathered parameters bit-identical, and
    the BiSeNet checkpoint served by ``Predictor.from_checkpoint`` with
    exactly the masks of a predictor of the gathered (replicated)
    weights.  Returns the K1/K2 launches of each path, summed over the
    ranks."""
    from rtsds_tpu_torch.parallel.launch import run_ranks

    tmp = tempfile.TemporaryDirectory(prefix="rtsds_smoke_fsdp_")
    t0 = time.perf_counter()
    ranks = run_ranks(_model_rank, MODEL_WORLD, (tmp.name,),
                      timeout_s=MODEL_TIMEOUT_S, threads=None)
    ranks_s = time.perf_counter() - t0
    one = _par_f64_steps(0, 1)
    held = {name: _held_to(ranks[0]["f64"][name], one[name])
            for name in ("supervised", "da_v1")}
    launches, bytes_, gaps = {}, {}, {}
    for name in ("bisenet", "deeplab"):
        runs = [r[name] for r in ranks]
        # each rank runs its own forward of the same batch, which cuDNN may
        # round apart on a shared card; the reductions make the parameters
        # and BN statistics one (bit-identical, below)
        gaps[name] = max(abs(a - b) / abs(b) for a, b in zip(
            runs[0]["losses"], runs[1]["losses"]))
        if gaps[name] > MODEL_RANK_LOSS_RTOL or not all(
                math.isfinite(x) for x in runs[0]["losses"]):
            raise AssertionError(f"model axis {name}: {runs[0]['losses']} "
                                 f"vs {runs[1]['losses']}")
        for r in runs:
            b = r["bytes"]
            if b["resident"] != b["placement_rule"] or \
                    b["resident"] >= b["replicated"]:
                raise AssertionError(f"model axis {name} bytes: {b}")
        launches[name] = {k: sum(r["launches"][k] for r in runs)
                          for k in runs[0]["launches"]}
        bytes_[name] = [r["bytes"] for r in runs]
    if not all(r["params_bit_identical"] for r in ranks):
        raise AssertionError("the model axis ranks' gathered parameters "
                             "are not bit-identical")
    kw = dict(image_size=MODEL_SERVE_SIZE, batch_size=2,
              dtype=torch.bfloat16)
    served = Predictor.from_checkpoint(
        os.path.join(tmp.name, "bisenet"), **kw).predict(
        frames[:2, :MODEL_SERVE_SIZE[0], :MODEL_SERVE_SIZE[1]])
    replicated = Predictor(state=ranks[0]["served_state"], **kw).predict(
        frames[:2, :MODEL_SERVE_SIZE[0], :MODEL_SERVE_SIZE[1]])
    if not np.array_equal(served, replicated):
        raise AssertionError("the model-axis checkpoint serves other masks")
    tmp.cleanup()
    emit({"phase": "parallel_model_axis", "ranks": MODEL_WORLD,
          "mesh": {"model": MODEL_WORLD},
          "backend": "gloo on CUDA tensors, both ranks on cuda:0 "
                     "(all_reduce forms of the gather and reduce-scatter)",
          "float64_vs_one_process": held,
          "bf16": {"image_size": list(TRAIN_SIZE),
                   "bisenet_global_batch": TRAIN_BATCH,
                   "bisenet_steps": TRAIN_EPOCHS * PAR_STEPS,
                   "deeplab_global_batch": MODEL_DL_BATCH,
                   "deeplab_steps": MODEL_DL_STEPS},
          "bisenet_losses": ranks[0]["bisenet"]["losses"],
          "ranks_loss_max_rel_gap": gaps,
          "bisenet_miou": ranks[0]["bisenet"]["miou"],
          "deeplab_losses": ranks[0]["deeplab"]["losses"],
          "bytes_params_and_adam_moments_per_rank": bytes_,
          "params_bit_identical_across_ranks": True,
          "checkpoint_served_masks_equal_replicated": True,
          "shared_card_step_ms_not_a_scaling_figure": {
              "bisenet": [r["bisenet"]["step_ms"] for r in ranks]},
          "peak_mb_per_rank": {name: [r[name]["peak_mb"] for r in ranks]
                               for name in ("bisenet", "deeplab")},
          "ranks_s": ranks_s, "launches": launches})
    return launches


def phase_parallel_model_nccl_world1() -> dict:
    """(i) NCCL at world size 1 with the model axis forced on: the whole
    job is one model group of one rank, so the shards are the whole
    tensors and ``all_gather_into_tensor`` and ``reduce_scatter_tensor``
    run under NCCL.  A float64 BiSeNet-R18 step (b2 at PAR_F64_SIZE) must
    equal the plain step exactly; then a bf16 step at 720x1280 b8 timed
    beside the plain step."""
    import torch.distributed as dist

    from rtsds_tpu_torch.parallel import distributed
    from rtsds_tpu_torch.parallel.fsdp import shard_state
    from rtsds_tpu_torch.parallel.mesh import initialize_multihost

    os.environ["RTSDS_NUM_PROCESSES"] = "1"
    initialize_multihost(device_type="cuda")
    calls = {"all_gather_into_tensor": 0, "reduce_scatter_tensor": 0}
    plain = {name: getattr(dist, name) for name in calls}

    def counted(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return plain[name](*args, **kwargs)
        return call
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}")
        for name in calls:
            setattr(dist, name, counted(name))
        images, labels, _ = _par_f64_inputs()
        x, y = images[:2].cuda(), labels[:2].cuda()
        after = []
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True,
                                        allow_tf32=False):
            for forced in (False, True):
                model, _ = make_segmentor(load_config(), "bisenet",
                                          seed=SEED)
                model.to("cuda", torch.float64)
                before = {k: v.detach().clone()
                          for k, v in model.state_dict().items()}
                state = TrainState(model, make_optimizer(
                    "SGD", model.parameters(), 0.01, momentum=0.9))
                if forced:
                    sharded = shard_state(state, dist.group.WORLD)
                    if not sharded.native:
                        raise AssertionError("NCCL took the all_reduce "
                                             "forms")
                make_train_step(19)(state, x, y)
                after.append(state.state_dict()["model"])
        # the upsample's backward adds with atomics: each tensor within
        # F64_UPDATE_SHARE of its largest update (of its magnitude, for the
        # BN statistics)
        err = 0.0
        for k, v in after[0].items():
            if v.is_floating_point():
                scale = v.abs().max() if "running" in k \
                    else (v - before[k]).abs().max()
                err = max(err, float((after[1][k] - v).abs().max())
                          / (F64_UPDATE_SHARE * float(scale) + 1e-15))
        config = train_config()
        batch = _full_size_batch()
        times = {}
        for name, forced in (("plain", False), ("model_axis_forced", True)):
            state = build_supervised(config, "bisenet", 1, "cuda",
                                     seed=SEED)
            if forced:
                shard_state(state, dist.group.WORLD)
            step = make_train_step(19)
            times[name] = cuda_ms(lambda: step(state, *batch), reps=10)
            del state
            torch.cuda.empty_cache()
        if err > 1.0 or not all(calls.values()):
            raise AssertionError(f"model axis under NCCL: err {err}, "
                                 f"calls {calls}")
    finally:
        for name, fn in plain.items():
            setattr(dist, name, fn)
        distributed._GROUP = distributed._JOB = distributed._MODEL = None
        dist.destroy_process_group()
        os.environ.pop("RTSDS_NUM_PROCESSES", None)
    emit({"phase": "parallel_model_nccl_world1", "backend": "nccl",
          "world_size": 1, "model_axis": "forced on (one rank)",
          "float64_step_worst_err_over_limit_vs_plain": err,
          "collective_calls": calls, "image_size": list(TRAIN_SIZE),
          "batch": TRAIN_BATCH, "step_p50_ms": times})
    return calls


def _band_devices() -> list:
    return ["cuda:0"] * SPATIAL_BANDS


def _f64_step_on_bands(model_name: str, size: tuple, batch: int) -> dict:
    """One float64 SGD step of ``model_name`` (full depth; DeepLab's BN
    affines frozen) at ``size`` on the card, on one device and on
    SPATIAL_BANDS bands of cuda:0; fails unless the loss agrees to 1e-10
    relative and every tensor (parameters and BN statistics) to
    F64_UPDATE_SHARE of its largest update (or of its magnitude, for the
    statistics).  Returns the worst of each over its limit."""
    from rtsds_tpu_torch.parallel.spatial import split_batch

    ds = SyntheticSegDataset(batch, size, CLASSES, seed=SEED + 95,
                             fixed_tints=True)
    x = normalize(torch.from_numpy(np.stack(
        [ds[i][0] for i in range(batch)])).cuda()).double()
    y = torch.from_numpy(np.stack([ds[i][1] for i in range(batch)])).cuda()
    y[:, : size[0] // 4] = 19
    runs = []
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        for banded in (False, True):
            model, frozen = make_segmentor(load_config(), model_name,
                                           seed=SEED)
            model.to("cuda", torch.float64)
            before = {k: v.detach().clone()
                      for k, v in model.state_dict().items()}
            state = TrainState(model, make_optimizer(
                "SGD", model.parameters(), 0.01, momentum=0.9,
                frozen=frozen))
            xi, yi = split_batch(x, y, _band_devices()) if banded else (x, y)
            loss = float(make_train_step(19)(state, xi, yi)["train_loss"])
            runs.append((loss, before, {k: v.detach().clone() for k, v in
                                        model.state_dict().items()}))
    (loss0, before, one), (loss1, _, bands) = runs
    worst = 0.0
    for k, v in one.items():
        if not v.is_floating_point():
            continue
        scale = (v - before[k]).abs().max() if "running" not in k \
            else v.abs().max()
        limit = F64_UPDATE_SHARE * float(scale) + 1e-15
        worst = max(worst, float((bands[k] - v).abs().max()) / limit)
    result = {"loss_rel_diff": abs(loss1 - loss0) / abs(loss0),
              "worst_err_over_limit": worst}
    if result["loss_rel_diff"] > 1e-10 or worst > 1.0:
        raise AssertionError(f"{model_name} float64 step on bands: {result}")
    return result


def _banded_hist_check(checks: list):
    """``validate``'s banded K1 with each summed matrix held against the
    plain version over the gathered labels and masks."""
    from rtsds_tpu_torch.eval import validate as val_mod
    from rtsds_tpu_torch.parallel.spatial import gather

    banded = val_mod.banded_hist

    def checked(labels, preds, n):
        got = banded(labels, preds, n)
        want = fast_hist(gather(labels), gather(preds), n)
        if not torch.equal(got.cpu(), want.cpu().to(got.dtype)):
            raise AssertionError("a banded K1 matrix differs from the "
                                 "plain one over the gathered masks")
        checks.append(int(got.sum()))
        return got
    return val_mod, banded, checked


def phase_parallel_spatial_training(frames: np.ndarray) -> dict:
    """(j) The spatial axis in training (ROADMAP 17.4): SPATIAL_BANDS bands
    on cuda:0 in one process.  Float64 steps of BiSeNet-R18 (b2 at
    PAR_F64_SIZE) and DeepLabV2-R101 (b2 at SPATIAL_DL_F64_SIZE) held to
    one device's; then bf16 at full width through the trainers, K2 in the
    transform on the whole batch before banding and K1 per band in the
    validations (each summed matrix held against the plain version over
    the gathered masks): BiSeNet-R18 supervised (720x1280 b8, 2 x 4
    steps), DA v1 (source 720x1280, target 512x1024, b8, 1 x 2 steps) and
    DeepLabV2-R101 supervised (512x1024 b2, 1 x 2 steps); the bf16 step
    timed on bands beside one device, with the peak memory.  Returns the
    K1/K2 launches of each path."""
    from rtsds_tpu_torch.parallel.spatial import BandedBatches, split_batch

    dev = torch.device("cuda")
    f64 = {"bisenet": _f64_step_on_bands("bisenet", PAR_F64_SIZE, 2),
           "deeplab": _f64_step_on_bands("deeplab", SPATIAL_DL_F64_SIZE, 2)}
    checks = []
    val_mod, banded_hist, checked = _banded_hist_check(checks)
    val_mod.banded_hist = checked
    launches, out = {}, {}
    try:
        val = _val_stream()

        def val_batches(epoch):
            return BandedBatches(val(epoch), _band_devices())

        # BiSeNet-R18 supervised
        config = train_config()
        loader, transform = _gta5_stream(TRAIN_STEPS * TRAIN_BATCH,
                                         SEED + 96)
        state = build_supervised(config, "bisenet", len(loader), dev,
                                 seed=SEED)
        clock = _StepClock()
        (_, history), launches["bisenet"], checked_k2 = on_main_path(
            lambda: supervised_fit(
                state, make_train_step(19),
                lambda epoch: BandedBatches(device_batches(
                    loader, transform, dev, seed=SEED, epoch=epoch),
                    _band_devices()),
                val_batches, epochs=TRAIN_EPOCHS, num_classes=CLASSES,
                callbacks=[clock], device=dev))
        losses = [e["train_loss"] for e in clock.logs]
        if len(losses) != TRAIN_EPOCHS * TRAIN_STEPS or not all(
                math.isfinite(v) for v in losses):
            raise AssertionError(f"spatial BiSeNet losses {losses}")
        batch = _full_size_batch()
        step = make_train_step(19)
        timed = {}
        for name, banded in (("one_device", False), ("two_bands", True)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            args = split_batch(*batch, _band_devices()) if banded else batch
            timed[name] = {"step_p50_ms": cuda_ms(lambda: step(state, *args),
                                                  reps=SPATIAL_STEP_REPS),
                           "peak_mb": torch.cuda.max_memory_allocated()
                           / 2 ** 20}
        out["bisenet"] = {"losses": losses,
                          "miou": [h["validation_mIoU"] for h in history],
                          "k2_checked": checked_k2,
                          "one_card_not_a_scaling_figure": timed}
        del state, batch
        torch.cuda.empty_cache()

        # DA v1, source and target banded apart
        config = da_config()
        tcfg = config.training["domain_adaptation"]
        src_loader, src_tf = _gta5_stream(SPATIAL_DA_STEPS * TRAIN_BATCH,
                                          SEED + 97, infinite=True)
        tgt_loader, tgt_tf = _target_stream(SPATIAL_DA_STEPS * TRAIN_BATCH,
                                            SEED + 98)
        gen, dis = build_adversarial(config, dev, seed=SEED)
        source = BandedBatches(device_batches(src_loader, src_tf, dev,
                                              seed=SEED), _band_devices())
        target = BandedBatches(device_batches(tgt_loader, tgt_tf, dev),
                               _band_devices())
        clock = _StepClock()
        with contextlib.closing(source), contextlib.closing(target):
            (_, _, history), launches["da"], _ = on_main_path(
                lambda: adversarial_fit(
                    gen, dis, make_adversarial_step(
                        float(tcfg["lambda"]), SPATIAL_DA_STEPS, 1, 19,
                        "v1"), iter(source), iter(target), val_batches,
                    iterations=SPATIAL_DA_STEPS, epochs=1,
                    num_classes=CLASSES, callbacks=[clock], device=dev))
        out["da_v1"] = {"losses": clock.logs,
                        "miou": [h["validation_mIoU"] for h in history]}
        del gen, dis
        torch.cuda.empty_cache()

        # DeepLabV2-R101 supervised at 512x1024 b2
        config = deeplab_config()
        ds = ColorCodedLabels(SyntheticSegDataset(
            SPATIAL_DL_STEPS * SPATIAL_DL_BATCH, DEEPLAB_SIZE, CLASSES,
            seed=SEED + 99, fixed_tints=True), class_colors_for_remap(),
            unmatched=UNMATCHED, seed=SEED)
        loader = DataLoader(ds, SPATIAL_DL_BATCH, shuffle=True,
                            num_workers=4, seed=SEED)
        tf = make_transform(DEEPLAB_SIZE, CLASSES, antialias=False,
                            augment_cfg=AugmentConfig.from_config(config),
                            decode_label_colors=True)
        state = build_supervised(config, "deeplab", len(loader), dev,
                                 seed=SEED)
        clock = _StepClock()
        (_, history), launches["deeplab"], _ = on_main_path(
            lambda: supervised_fit(
                state, make_train_step(19),
                lambda epoch: BandedBatches(device_batches(
                    loader, tf, dev, seed=SEED, epoch=epoch),
                    _band_devices()),
                val_batches, epochs=1, num_classes=CLASSES,
                callbacks=[clock], device=dev))
        dl_batch = next(iter(device_batches(loader, tf, dev, seed=SEED)))
        timed = {}
        for name, banded in (("one_device", False), ("two_bands", True)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            args = split_batch(*dl_batch, _band_devices()) if banded \
                else dl_batch
            timed[name] = {"step_p50_ms": cuda_ms(lambda: step(state, *args),
                                                  reps=SPATIAL_STEP_REPS),
                           "peak_mb": torch.cuda.max_memory_allocated()
                           / 2 ** 20}
        out["deeplab"] = {"losses": [e["train_loss"] for e in clock.logs],
                          "miou": [h["validation_mIoU"] for h in history],
                          "one_card_not_a_scaling_figure": timed}
        del state
        torch.cuda.empty_cache()
    finally:
        val_mod.banded_hist = banded_hist
    if not checks:
        raise AssertionError("no banded K1 matrix was checked")
    emit({"phase": "parallel_spatial_training", "bands": SPATIAL_BANDS,
          "devices": "cuda:0 twice", "float64_vs_one_device": f64,
          "bisenet_size": list(TRAIN_SIZE), "batch": TRAIN_BATCH,
          "da_target_size": list(DA_TGT_SIZE),
          "deeplab_size": list(DEEPLAB_SIZE),
          "deeplab_batch": SPATIAL_DL_BATCH,
          "banded_k1_matrices_checked": len(checks), **out,
          "launches": launches})
    return launches


def phase_spatial_sliding(frames: np.ndarray, dl_tree: dict) -> dict:
    """(k) The sliding protocol on 2 bands of cuda:0 (ROADMAP 17.2b):
    DeepLabV2-R101 from its seeded tree on 1024x2048 frames at b1 with a
    512x1024 window (stride 3/4 of it).  Float64 masks equal to one
    device's; the bf16 masks' agreement with one device (read from K1's
    confusion matrix) beside spatial serving's yardstick, one device at
    b1 against b2, and beside one device whose forwards group the windows
    as the bands do (``window_chunk``), which the bands must match on
    MIN_SPATIAL_AGREEMENT of the pixels; the bf16 predict at b1 timed
    beside one device's.  Returns K1's launches on the path."""
    from rtsds_tpu_torch.eval.sliding import _grid
    from rtsds_tpu_torch.parallel.mesh import Mesh

    fast_hist_cuda.launches = 0
    frame = np.ascontiguousarray(frames[:1])
    # the first band runs the windows whose first row it holds, in one
    # forward: a one-device twin with that chunk groups them alike
    _, tiles = _grid(SIZE, SLIDING_WINDOW, None)
    first_band = sum(y < SIZE[0] // SPATIAL_BANDS for y, _ in tiles)
    res = {}
    for name, dtype in (("float64", torch.float64),
                        ("bfloat16", torch.bfloat16)):
        kw = dict(model_name="deeplab", variables=dl_tree, image_size=SIZE,
                  dtype=dtype, protocol="sliding",
                  protocol_kwargs={"window": SLIDING_WINDOW})
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False,
                                        allow_tf32=False):
            one = Predictor(batch_size=1, **kw)
            banded = Predictor(batch_size=1, mesh=Mesh(_band_devices()),
                               sharding="spatial", **kw)
            want, got = one.predict(frame), banded.predict(frame)
        if name == "float64":
            res[name] = {"masks_equal": bool(np.array_equal(got, want))}
            if not res[name]["masks_equal"]:
                raise AssertionError("float64 sliding masks on bands differ "
                                     "from one device's")
        else:
            b2 = Predictor(batch_size=2, **kw)
            twin = Predictor(batch_size=1, **{**kw, "protocol_kwargs": {
                "window": SLIDING_WINDOW, "window_chunk": first_band}})
            res[name] = {
                "mask_agreement": _agreement_k1(got, want),
                "yardstick_one_device_b1_vs_b2": _agreement_k1(
                    b2.predict(frame), want),
                "yardstick_one_device_window_chunk": _agreement_k1(
                    twin.predict(frame), want),
                "vs_one_device_same_window_groups": _agreement_k1(
                    got, twin.predict(frame)),
                "window_chunk_of_the_groups": first_band,
                "predict_b1_ms_one_card_not_a_scaling_figure": {
                    "two_bands": cuda_ms(lambda: banded.predict(frame),
                                         reps=SLIDING_REPS, warmup=1),
                    "one_device": cuda_ms(lambda: one.predict(frame),
                                          reps=SLIDING_REPS, warmup=1)}}
            del b2, twin
            # cuDNN rounds a forward of 6 windows apart from one of 9 (on
            # random weights, near-tied logits flip): the bands are held to
            # the one-device twin that groups the windows as they do
            if res[name]["vs_one_device_same_window_groups"] < \
                    MIN_SPATIAL_AGREEMENT:
                raise AssertionError(f"bf16 sliding on bands: {res}")
        del one, banded
        torch.cuda.empty_cache()
    launches = fast_hist_cuda.launches
    emit({"phase": "spatial_sliding", "bands": SPATIAL_BANDS,
          "devices": "cuda:0 twice", "model": "deeplabv2-resnet101",
          "image_size": list(SIZE), "window": list(SLIDING_WINDOW),
          "batch": 1, **res, "k1_agreement_launches": launches})
    return {"fast_hist_cuda": launches}


# --- the training extras and the validation protocols on bands (ROADMAP
# 17.5b) ----------------------------------------------------------------------

SPATIAL_EXTRA_STEPS = 2     # bf16 steps of each extra's path, one epoch
SPATIAL_EXTRA_REPS = 3      # per timed banded / one-device step
SPATIAL_PROTOCOL_BATCH = 2  # the protocols' validation batch at SIZE
# the LR schedules' length in steps: the fits take SPATIAL_EXTRA_STEPS,
# the timings some more, all inside the schedule
SPATIAL_SCHEDULE_STEPS = 1000
EMA_F32_SHARE = 2.0 ** -22  # the EMA, float32 arithmetic: one rounding
SPATIAL_F64_CASES = ("ema", "accumulate", "remat", "minent_fda", "v2",
                     "grl", "self_training", "distillation",
                     "distillation_int8")


def _held_to_one_device(got: dict, want: dict, name: str) -> dict:
    """A float64 extra's step on bands held to the one-device step at the
    limits of the spatial training phase: each loss within 1e-10
    relative, each tensor within F64_UPDATE_SHARE of its largest update
    (BN statistics: of their magnitude; integer counters equal), the EMA
    (float32 arithmetic, as the JAX package's) within EMA_F32_SHARE of its
    magnitude.  Returns the worst of each over its limit."""
    loss_err = max(abs(got["losses"][k] - v) / max(abs(v), 1e-12)
                   for k, v in want["losses"].items())
    worst = 0.0
    for i, (g, w) in enumerate(zip(got["after"], want["after"])):
        start = want["before"][i]
        for k, v in w.items():
            if not v.is_floating_point():
                if not torch.equal(g[k], v):
                    raise AssertionError(f"{name} {k}: {g[k]} vs {v}")
                continue
            if name == "ema":
                limit = EMA_F32_SHARE * float(v.abs().max())
            elif k in start:
                limit = F64_UPDATE_SHARE * float((v - start[k]).abs().max())
            else:
                limit = F64_UPDATE_SHARE * float(v.abs().max())
            worst = max(worst, float((g[k] - v).abs().max())
                        / (limit + 1e-15))
    result = {"loss_rel_diff": loss_err, "worst_err_over_limit": worst}
    if loss_err > 1e-10 or worst > 1.0:
        raise AssertionError(f"float64 {name} on bands: {result}")
    return result


def _beside_one_device(step, plain_args: tuple, banded_args: tuple
                       ) -> dict:
    """``step(*args)`` timed on one device and on the bands of the same
    card, each with its peak device memory (GB): not a scaling figure."""
    out = {}
    for name, args in (("one_device", plain_args),
                       ("two_bands", banded_args)):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out[name] = {"ms": cuda_ms(lambda: step(*args),
                                   reps=SPATIAL_EXTRA_REPS, warmup=1),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    return out


def _banded(*batch) -> tuple:
    """A (frames, labels) batch, or a target batch alone, cut into
    SPATIAL_BANDS bands of cuda:0."""
    from rtsds_tpu_torch.parallel.spatial import split_batch

    if len(batch) == 1:
        t = batch[0]
        return split_batch(t, torch.zeros(t.shape[:3], dtype=torch.long,
                                          device=t.device),
                           _band_devices())[:1]
    return split_batch(*batch, _band_devices())


def _target_batch() -> torch.Tensor:
    """A normalized DA target batch (b8, 512x1024) on the card."""
    ds = SyntheticSegDataset(TRAIN_BATCH, DA_TGT_SIZE, CLASSES,
                             seed=SEED + 85, fixed_tints=True)
    return normalize(torch.from_numpy(np.stack(
        [ds[i][0] for i in range(TRAIN_BATCH)])).cuda())


def _banded_da_fit(config, make_step, seed: int, **fit_kwargs) -> tuple:
    """One epoch of SPATIAL_EXTRA_STEPS DA steps of a fresh BiSeNet-R18 and
    Tiny discriminator through ``adversarial_fit`` as a main path, source
    (colour-coded, K2) and target banded apart, validated on bands (K1 per
    band).  Returns ``(gen, dis, step, history, launches, losses)``."""
    from rtsds_tpu_torch.parallel.spatial import BandedBatches

    dev = torch.device("cuda")
    n = SPATIAL_EXTRA_STEPS * TRAIN_BATCH
    src_loader, src_tf = _gta5_stream(n, seed, infinite=True)
    tgt_loader, tgt_tf = _target_stream(n, seed + 1)
    gen, dis = build_adversarial(config, dev, seed=SEED)
    step = make_step(gen)
    val = _val_stream()
    recorder = _DALossRecorder()
    source = BandedBatches(device_batches(src_loader, src_tf, dev,
                                          seed=SEED), _band_devices())
    target = BandedBatches(device_batches(tgt_loader, tgt_tf, dev),
                           _band_devices())
    with contextlib.closing(source), contextlib.closing(target):
        (_, _, history), launches, checked = on_main_path(
            lambda: adversarial_fit(
                gen, dis, step, iter(source), iter(target),
                lambda epoch: BandedBatches(val(epoch), _band_devices()),
                iterations=SPATIAL_EXTRA_STEPS, epochs=1,
                num_classes=CLASSES, callbacks=[recorder], device=dev,
                **fit_kwargs))
    if checked != SPATIAL_EXTRA_STEPS or len(history) != 1:
        raise AssertionError(f"{checked} K2 calls checked, {history}")
    return gen, dis, step, history, launches, recorder.losses


def _protocols_on_bands(tree: dict) -> tuple:
    """Validation of BiSeNet-R18 (the seeded serving tree) at SIZE, batch
    SPATIAL_PROTOCOL_BATCH, bf16, under the sliding protocol (a
    SLIDING_WINDOW window) and the ensemble (DEEPLAB_SCALES with flip) on
    SPATIAL_BANDS bands, each a main path through ``validate`` (K1 per
    band, each summed matrix held against the plain version over the
    gathered masks by the caller's check); the mIoU beside one device's,
    the eval step timed beside one device's.  Returns ``(report,
    launches)``."""
    from rtsds_tpu_torch.eval.ensemble import make_ensemble_eval_step

    dev = torch.device("cuda")
    model = load_flax_variables(BiSeNet(), tree).to(dev).eval()
    ds = SyntheticSegDataset(SPATIAL_PROTOCOL_BATCH, SIZE, CLASSES,
                             seed=SEED + 86, fixed_tints=True)
    tf = make_transform(SIZE, CLASSES, antialias=True)
    images, labels = tf(
        torch.from_numpy(np.stack([ds[i][0] for i in
                                   range(SPATIAL_PROTOCOL_BATCH)])).to(dev),
        torch.from_numpy(np.stack([ds[i][1] for i in
                                   range(SPATIAL_PROTOCOL_BATCH)])).to(dev))
    report, launches = {}, {}
    for name, step in (
            ("sliding", make_sliding_eval_step(
                model, SIZE, CLASSES, window=SLIDING_WINDOW,
                compute_dtype=torch.bfloat16)),
            ("ensemble", make_ensemble_eval_step(
                model, SIZE, CLASSES, scales=DEEPLAB_SCALES, flip=True,
                compute_dtype=torch.bfloat16))):
        (miou, _), launches[name], _ = on_main_path(lambda: validate(
            model, [_banded(images, labels)], CLASSES, eval_step=step,
            device=dev))
        one, _ = validate(model, [(images, labels)], CLASSES, eval_step=step,
                          device=dev)
        zero = torch.zeros((CLASSES, CLASSES), dtype=torch.int32,
                           device=dev)
        report[name] = {"miou": miou, "miou_one_device": one,
                        "one_card_not_a_scaling_figure": _beside_one_device(
                            step, (images, labels, zero),
                            (*_banded(images, labels), zero))}
    del model
    return report, launches


def spatial_extras_launched(tree: dict) -> dict:
    """:func:`phase_spatial_extras`, failing unless K1 and K2 launched on
    each of its training paths and K1 on each validation path."""
    launches = phase_spatial_extras(tree)
    for path, counts in launches.items():
        need = (("fast_hist_cuda",) if path.startswith("validation_")
                else ("fast_hist_cuda", "rgb_to_train_ids_cuda"))
        missed = [k for k in need if counts[k] < 1]
        if missed:
            raise AssertionError(f"spatial extras: {path} never launched "
                                 f"{missed}")
    return launches


def phase_spatial_extras(tree: dict) -> dict:
    """(k2) The training extras and the validation protocols on the
    spatial axis (ROADMAP 17.5b), SPATIAL_BANDS bands of cuda:0 in one
    process.  Float64 steps of the extras (EMA, accumulation, remat,
    MinEnt + FDA, v2, the reversal step, self-training, distillation under
    a float DeepLabV2-R101 teacher and under its int8 form, whose bf16
    walk on the bands the first card run read equal to the whole frame's;
    PAR_F64_SIZE, b4) on bands held to one device's at the spatial phase's
    limits, CBST's thresholds equal; then bf16
    at full width through the trainers, K2 before banding and K1 per band
    (each summed matrix held against the plain version over the gathered
    masks), each step timed beside its one-device step with the peak
    memory: BiSeNet-R18 720x1280 b8 with EMA + accumulation 2 + remat; DA
    v1 (target 512x1024) with MinEnt + FDA + the reversal step; DA v2;
    self-training with CBST (calibrated on banded target batches) and
    ClassMix; DeepLabV2-R101 512x1024 b2 distilled from an int8
    DeepLabV2-R101 teacher; validation at 1024x2048 under the sliding and
    the ensemble protocols.  Returns the K1/K2 launches of each path."""
    from rtsds_tpu_torch.parallel.spatial import BandedBatches, gathered
    from rtsds_tpu_torch.train.accumulate import (
        make_accumulating_train_step, split_microbatches)
    from rtsds_tpu_torch.train.distill import (
        make_distill_step, quantize_teacher)
    from rtsds_tpu_torch.train.ema import ema_init
    from rtsds_tpu_torch.train.self_training import (
        calibrate_class_thresholds, make_self_training_step)

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    one = _axis_extras_f64()
    bands = _axis_extras_f64(bands=SPATIAL_BANDS)
    f64 = {name: _held_to_one_device(bands[name], one[name], name)
           for name in SPATIAL_F64_CASES}
    if bands["cbst"] != one["cbst"]:
        raise AssertionError(f"CBST on bands {bands['cbst']} vs "
                             f"{one['cbst']}")
    f64["cbst_thresholds_equal"] = True
    del one, bands
    torch.cuda.empty_cache()
    f64_s = time.perf_counter() - t0

    checks = []
    val_mod, banded_hist, checked_hist = _banded_hist_check(checks)
    val_mod.banded_hist = checked_hist
    launches, out = {}, {}
    try:
        val = _val_stream()

        def val_batches(epoch):
            return BandedBatches(val(epoch), _band_devices())

        # BiSeNet-R18 with EMA + accumulation over 2 micro-batches + remat
        config = load_config(overrides={
            "precision": {"compute_dtype": "bfloat16"},
            "model": {"bisenet": {"remat": True}},
            "training": {"segmentation": {
                "epochs": 1, "do_validation": 1, "accumulate_steps": 2,
                "ema": {"enabled": True, "decay": 0.999}}}})
        loader, transform = _gta5_stream(SPATIAL_EXTRA_STEPS * TRAIN_BATCH,
                                         SEED + 101)
        state = build_supervised(config, "bisenet", SPATIAL_SCHEDULE_STEPS,
                                 dev, seed=SEED)
        acc = make_accumulating_train_step(19)

        def acc_step(st, images, labels):
            return acc(st, split_microbatches(images, 2),
                       split_microbatches(labels, 2))
        clock = _StepClock()
        (_, history), launches["ema_accumulate_remat"], _ = on_main_path(
            lambda: supervised_fit(
                state, acc_step, lambda epoch: BandedBatches(device_batches(
                    loader, transform, dev, seed=SEED, epoch=epoch),
                    _band_devices()), val_batches, epochs=1,
                num_classes=CLASSES, callbacks=[clock], device=dev,
                ema_decay=0.999))
        losses = [e["train_loss"] for e in clock.logs]
        if len(losses) != SPATIAL_EXTRA_STEPS or not all(
                math.isfinite(v) for v in losses):
            raise AssertionError(f"EMA + accumulation + remat: {losses}")
        batch = _full_size_batch()
        out["ema_accumulate_remat"] = {
            "losses": losses, "miou_on_ema": history[0]["validation_mIoU"],
            "one_card_not_a_scaling_figure": _beside_one_device(
                lambda *a: acc_step(state, *a), batch, _banded(*batch))}
        del state
        torch.cuda.empty_cache()

        # DA v1 with MinEnt + FDA + the reversal step, then DA v2
        src = _full_size_batch()
        tgt = _target_batch()
        da_args = (*src, tgt)
        da_banded = (*_banded(*src), *_banded(tgt))
        for name, da in (("da_v1_minent_fda_grl", {
                "entropy_min": {"enabled": True, "lambda": 0.005},
                "fda": {"enabled": True, "beta": 0.01}}),
                         ("da_v2", {"variant": "v2"})):
            config = _extras_config(domain_adaptation={
                "epochs": 1, "iterations": SPATIAL_SCHEDULE_STEPS,
                "do_validation": 1, **da})
            kw = (dict(lambda_ent=0.005, fda_beta=0.01, grl_alpha=0.1)
                  if name.startswith("da_v1") else dict(variant="v2"))
            step = make_adversarial_step(
                float(config.training["domain_adaptation"]["lambda"]),
                SPATIAL_EXTRA_STEPS, 1, 19, **kw)
            gen, dis, step, history, launches[name], losses = \
                _banded_da_fit(config, lambda g, s=step: s,
                               SEED + 102 + len(out))
            check_da_losses(losses, SPATIAL_EXTRA_STEPS, tuple(losses[0]))
            out[name] = {"losses": losses,
                         "miou": history[0]["validation_mIoU"],
                         "one_card_not_a_scaling_figure": _beside_one_device(
                             lambda *a: step(gen, dis, *a), da_args,
                             da_banded)}
            del gen, dis, step
            torch.cuda.empty_cache()

        # self-training: CBST on banded target batches, ClassMix, the EMA
        # teacher
        config = _extras_config(domain_adaptation={
            "epochs": 1, "iterations": SPATIAL_SCHEDULE_STEPS,
            "do_validation": 1, "ema": {"enabled": True, "decay": 0.999},
            "self_training": {"enabled": True, "classmix": {"enabled": True},
                              "calibration": {"enabled": True,
                                              "batches": 2}}})
        calibrated = {}

        def build(gen):
            cal_loader, cal_tf = _target_stream(2 * TRAIN_BATCH, SEED + 108)
            cal = BandedBatches(device_batches(cal_loader, cal_tf, dev),
                                _band_devices())
            with contextlib.closing(cal):
                drawn = iter(cal)
                thr = calibrate_class_thresholds(
                    gen.model, [next(drawn) for _ in range(2)],
                    CLASSES, portion=0.5, compute_dtype=gen.compute_dtype)
            calibrated["thresholds"] = [float(v) for v in thr]
            return make_self_training_step(
                float(config.training["domain_adaptation"]["lambda"]),
                SPATIAL_EXTRA_STEPS, 19, threshold=thr, ema_decay=0.999,
                classmix=True, classmix_seed=SEED)
        gen, dis, step, history, launches["self_training"], losses = \
            _banded_da_fit(config, build, SEED + 106, ema_in_step=True)
        check_da_losses(losses, SPATIAL_EXTRA_STEPS, tuple(losses[0]))
        ema = ema_init(gen.model)
        out["self_training"] = {
            "losses": losses, "miou": history[0]["validation_mIoU"],
            **calibrated,
            "one_card_not_a_scaling_figure": _beside_one_device(
                lambda *a: step(gen, dis, ema, *a), da_args, da_banded)}
        del gen, dis, step, ema, src, tgt, da_args, da_banded
        torch.cuda.empty_cache()

        # DeepLabV2-R101 at 512x1024 b2, distilled from its int8 form
        config = load_config(overrides={
            "precision": {"compute_dtype": "bfloat16"},
            "training": {"segmentation": {"epochs": 1,
                                          "do_validation": 1}}})
        ds = ColorCodedLabels(SyntheticSegDataset(
            SPATIAL_EXTRA_STEPS * SPATIAL_DL_BATCH, DEEPLAB_SIZE, CLASSES,
            seed=SEED + 109, fixed_tints=True), class_colors_for_remap(),
            unmatched=UNMATCHED, seed=SEED)
        loader = DataLoader(ds, SPATIAL_DL_BATCH, shuffle=True,
                            num_workers=4, seed=SEED)
        tf = make_transform(DEEPLAB_SIZE, CLASSES, antialias=False,
                            augment_cfg=AugmentConfig.from_config(config),
                            decode_label_colors=True)
        teacher_model, _ = make_segmentor(config, "deeplab", seed=SEED + 22)
        # the calibration sees the frames one device sees: the bands
        # gathered, as the CLI hands them to it
        calib = [gathered(images).permute(0, 3, 1, 2) for images, _ in
                 BandedBatches(device_batches(loader, tf, dev, seed=SEED),
                               _band_devices())]
        teacher = quantize_teacher("deeplab", teacher_model.state_dict(),
                                   calib, device=dev)
        del teacher_model, calib
        state = build_supervised(config, "deeplab", SPATIAL_SCHEDULE_STEPS,
                                 dev, seed=SEED)
        step = make_distill_step(teacher, 19)
        clock = _StepClock()
        (_, history), launches["deeplab_distill_int8"], _ = on_main_path(
            lambda: supervised_fit(
                state, step, lambda epoch: BandedBatches(device_batches(
                    loader, tf, dev, seed=SEED, epoch=epoch),
                    _band_devices()), val_batches, epochs=1,
                num_classes=CLASSES, callbacks=[clock], device=dev))
        losses = [{k: e[k] for k in ("train_loss", "loss_ce", "loss_distill")}
                  for e in clock.logs]
        if len(losses) != SPATIAL_EXTRA_STEPS or not all(
                math.isfinite(v) for row in losses for v in row.values()):
            raise AssertionError(f"int8-teacher distillation: {losses}")
        dl_batch = next(iter(device_batches(loader, tf, dev, seed=SEED)))
        out["deeplab_distill_int8"] = {
            "losses": losses, "miou": history[0]["validation_mIoU"],
            "one_card_not_a_scaling_figure": _beside_one_device(
                lambda *a: step(state, *a), dl_batch, _banded(*dl_batch))}
        del state, teacher, step, dl_batch
        torch.cuda.empty_cache()

        # the validation protocols at 1024x2048
        out["protocols"], protocol_launches = _protocols_on_bands(tree)
        launches.update({f"validation_{k}": v
                         for k, v in protocol_launches.items()})
        torch.cuda.empty_cache()
    finally:
        val_mod.banded_hist = banded_hist
    if not checks:
        raise AssertionError("no banded K1 matrix was checked")
    emit({"phase": "spatial_extras", "bands": SPATIAL_BANDS,
          "devices": "cuda:0 twice",
          "float64_vs_one_device": f64, "float64_s": f64_s,
          "bisenet_size": list(TRAIN_SIZE), "batch": TRAIN_BATCH,
          "da_target_size": list(DA_TGT_SIZE),
          "deeplab_size": list(DEEPLAB_SIZE),
          "deeplab_batch": SPATIAL_DL_BATCH, "protocol_size": list(SIZE),
          "protocol_batch": SPATIAL_PROTOCOL_BATCH,
          "steps": SPATIAL_EXTRA_STEPS,
          "banded_k1_matrices_checked": len(checks), **out,
          "launches": launches, "seconds": time.perf_counter() - t0})
    return launches


# --- composed meshes and the model axis's extras (ROADMAP 17.5a) -----------

COMPOSED_STEPS = 2          # bf16 steps of each composed path, one epoch
COMPOSED_TIMEOUT_S = 720    # each spawn of the ranks
COMPOSED_QUAD = {"data": 2, "spatial": 2, "model": 2}   # 4 gloo ranks
COMPOSED_PAIRS = ({"data": 2, "spatial": 2}, {"spatial": 2, "model": 2})
AXIS_EXTRA_STEPS = 2        # bf16 steps of each model-axis extra's path
AXIS_F64_CASES = ("ema", "accumulate", "remat", "minent_fda", "v2", "grl",
                  "self_training", "distillation", "distillation_int8")


def _spec_name(spec: dict) -> str:
    return "_".join(f"{k}{v}" for k, v in spec.items())


def _axis_extras_f64(mesh=None, bands: int = 0) -> dict:
    """Float64 steps of every training extra of ROADMAP 17.5a on the card
    at PAR_F64_SIZE on the global batch 4 of :func:`_par_f64_inputs`
    (a model group's ranks take the same frames; ``bands``: the frames cut
    into that many height bands of cuda:0, source and target apart), each
    state placed on ``mesh`` (``{model: 2}``: sharded) or, without one,
    whole: the EMA
    after a supervised step (its chunks gathered whole), 2-micro-batch
    accumulation, remat, DA v1 with MinEnt + FDA, v2 with both, the
    reversal step, self-training (ClassMix, FDA, MinEnt, the EMA teacher),
    distillation under a float DeepLabV2-R101 teacher and under its int8
    form; and the CBST thresholds of the (sharded) generator.  Each entry
    holds the losses and the tensors before and after, for
    :func:`_held_to`."""
    from rtsds_tpu_torch.parallel.fsdp import sharded_of
    from rtsds_tpu_torch.parallel.mesh import place_state
    from rtsds_tpu_torch.train.accumulate import (
        make_accumulating_train_step, split_microbatches)
    from rtsds_tpu_torch.train.distill import (
        make_distill_step, quantize_teacher)
    from rtsds_tpu_torch.train.ema import EMA, ema_init, ema_update
    from rtsds_tpu_torch.train.self_training import (
        calibrate_class_thresholds, classmix_scores, make_self_training_step)

    from rtsds_tpu_torch.parallel.spatial import gathered, split_batch

    images, labels, target = _par_f64_inputs()
    x, y, t = (a.cuda() for a in (images, labels, target))
    if bands:
        x, y = split_batch(x, y, ["cuda:0"] * bands)
        t, _ = split_batch(t, torch.zeros(t.shape[:3], dtype=torch.long,
                                          device=t.device), ["cuda:0"] * bands)
    config = load_config()
    out = {}

    def sgd(model, lr=0.01, momentum=0.0):
        st = TrainState(model, make_optimizer("SGD", model.parameters(), lr,
                                              momentum=momentum))
        return place_state(st, mesh) if mesh is not None else st

    def losses(metrics):
        return {k: float(v) for k, v in metrics.items()
                if k.startswith("loss_") or k.endswith("coverage")
                or k == "train_loss"}

    def pair():
        gen, _ = _f64_model(config, "bisenet", SEED)
        dis = make_discriminator(
            config.model["adversarial_model"]["discriminator"],
            seed=SEED + 1).to("cuda", torch.float64)
        before = _named(gen, dis)
        return sgd(gen), sgd(dis, lr=0.02), before

    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        # the EMA of a supervised step
        model, _ = _f64_model(config, "bisenet", SEED)
        before = _named(model)
        st = sgd(model, momentum=0.9)
        ema = EMA(ema_init(st.model), sharded_of(st.model))
        metrics = make_train_step(19)(st, x, y)
        ema_update(ema.params, st.model, 0.99, st.step)
        out["ema"] = {"losses": losses(metrics), "before": before,
                      "after": [{k: v.cpu() for k, v in
                                 ema.state_dict()["params"].items()}]}
        out["ema_bytes"] = sum(v.numel() * v.element_size()
                               for v in ema.params.values())
        # accumulation, remat
        for name, cfg, step in (
                ("accumulate", config, lambda st: make_accumulating_train_step(
                    19)(st, split_microbatches(x, 2),
                        split_microbatches(y, 2))),
                ("remat", load_config(overrides={
                    "model": {"bisenet": {"remat": True}}}),
                 lambda st: make_train_step(19)(st, x, y))):
            model, _ = _f64_model(cfg, "bisenet", SEED)
            before = _named(model)
            st = sgd(model, momentum=0.9)
            metrics = step(st)
            out[name] = {"losses": losses(metrics), "before": before,
                         "after": _states(st.model) if mesh is None else
                         [{k: v.cpu() for k, v in
                           st.state_dict()["model"].items()}]}
        # the DA extras
        for name, kw in (("minent_fda", dict(lambda_ent=0.05,
                                             fda_beta=0.05)),
                         ("v2", dict(variant="v2", lambda_ent=0.05,
                                     fda_beta=0.05)),
                         ("grl", dict(grl_alpha=0.5))):
            g, d, before = pair()
            metrics = make_adversarial_step(0.1, DA_ITERATIONS, DA_EPOCHS,
                                            19, **kw)(g, d, x, y, t)
            out[name] = {"losses": losses(metrics), "before": before,
                         "after": [{k: v.cpu() for k, v in
                                    s.state_dict()["model"].items()}
                                   for s in (g, d)]}
        g, d, before = pair()
        out["cbst"] = calibrate_class_thresholds(g.model, [t],
                                                 CLASSES).tolist()
        ema = ema_init(g.model)
        metrics = make_self_training_step(
            0.1, DA_ITERATIONS, 19, threshold=0.1, ema_decay=0.99,
            lambda_ent=0.05, fda_beta=0.05, classmix=True,
            classmix_seed=SEED)(g, d, ema, x, y, t,
                                scores=classmix_scores(SEED, 0, 4, CLASSES))
        out["self_training"] = {
            "losses": losses(metrics), "before": before,
            "after": [{k: v.cpu() for k, v in s.state_dict()["model"].items()}
                      for s in (g, d)]}
        del g, d, ema
        # distillation: a float DeepLabV2-R101 teacher and its int8 form,
        # replicated
        teacher, _ = _f64_model(config, "deeplab", SEED + 22)
        teacher.eval()
        t32 = {k: v.float() for k, v in teacher.state_dict().items()}
        int8_teacher = quantize_teacher(
            "deeplab", t32, [gathered(x).float().permute(0, 3, 1, 2)],
            device="cuda")
        for name, tch in (("distillation", teacher),
                          ("distillation_int8", int8_teacher)):
            model, _ = _f64_model(config, "bisenet", SEED)
            before = _named(model)
            st = sgd(model)
            metrics = make_distill_step(tch, 19)(st, x, y)
            out[name] = {"losses": losses(metrics), "before": before,
                         "after": [{k: v.cpu() for k, v in
                                    st.state_dict()["model"].items()}]}
    return out


def _ranks_bit_identical(states: list) -> bool:
    """Whether every rank of the job holds the same whole parameters of
    ``states`` (a collective: the model axis gathers its shards)."""
    import torch.distributed as dist

    from rtsds_tpu_torch.parallel.distributed import job_group

    flat = torch.cat([_gathered_bits(st) for st in states])
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=job_group())
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=job_group())
    return bool(torch.equal(hi, lo))


def _banded_val(dev):
    """The trainers' validation batches on this rank's data shard, banded
    over _band_devices()."""
    from rtsds_tpu_torch.parallel.spatial import BandedBatches

    loader = _par_loader(TRAIN_VAL_BATCHES * TRAIN_BATCH, TRAIN_VAL_SIZE,
                         SEED + 5, False, shuffle=False, drop_last=False)
    tf = make_transform(TRAIN_VAL_SIZE, CLASSES, antialias=True)
    return lambda epoch: BandedBatches(device_batches(loader, tf, dev),
                                       _band_devices())


def _composed_fit(out: dict, name: str, run, clock, states) -> None:
    """``run()``, a trainer's fit, as a main path of this rank (K1's and
    K2's counts from zero, every K2 output held against the plain remap):
    its losses, mIoU, launches and whether the ranks' gathered parameters
    are bit-identical after it."""
    result, launches, checked = on_main_path(run)
    history = result[-1]
    losses = [v for e in clock.logs for k, v in e.items()
              if k.startswith("loss_gen") or k == "train_loss"]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: losses {clock.logs}")
    out[name] = {"losses": clock.logs,
                 "miou": [h["validation_mIoU"] for h in history],
                 "launches": launches, "k2_checked": checked,
                 "params_bit_identical": _ranks_bit_identical(states)}


@contextlib.contextmanager
def _one_process():
    """Inside the block this rank's collectives skip themselves, as in a
    process of its own: for a one-process reference step beside the
    ranks' steps."""
    from rtsds_tpu_torch.parallel import distributed

    saved = distributed._GROUP, distributed._MODEL, distributed._JOB
    distributed._GROUP = distributed._MODEL = distributed._JOB = None
    try:
        yield
    finally:
        distributed._GROUP, distributed._MODEL, distributed._JOB = saved


def _composed_pair_rank(rank: int, world: int) -> dict:
    """One of two gloo ranks on cuda:0: the float64 composed steps on
    ``{data: 2, spatial: 2}`` and ``{spatial: 2, model: 2}`` (2 bands
    each), then the bf16 DeepLabV2-R101 run on ``{spatial: 2, model: 2}``
    (512x1024, global b2, K2 before banding, K1 per band), then on
    ``{model: 2}`` the float64 steps of every extra (the int8-teacher
    distillation among them) and the bf16 runs of two of them at full
    width: EMA + accumulation, and self-training.  Rank 0 then takes the
    one-process float64 steps and holds its own to them
    (:func:`_held_to`)."""
    from rtsds_tpu_torch.parallel import distributed
    from rtsds_tpu_torch.parallel.mesh import (
        make_mesh_from_config, place_state)
    from rtsds_tpu_torch.parallel.spatial import BandedBatches
    from rtsds_tpu_torch.train.accumulate import (
        make_accumulating_train_step, split_microbatches)
    from rtsds_tpu_torch.train.self_training import (
        calibrate_class_thresholds, make_self_training_step)

    torch.cuda.set_device(0)
    _build.load()
    dev = torch.device("cuda")
    out = {"f64": {}, "seconds": {}}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        now = time.perf_counter()
        out["seconds"][name] = now - t0
        t0 = now
    spec = COMPOSED_PAIRS[0]
    out["f64"][_spec_name(spec)] = _par_f64_steps(
        distributed.rank(), distributed.world_size(),
        make_mesh_from_config(spec), bands=SPATIAL_BANDS)
    with distributed.data_parallel(*distributed.axis_groups(2)):
        spec = COMPOSED_PAIRS[1]
        mesh = make_mesh_from_config(spec)
        out["f64"][_spec_name(spec)] = _par_f64_steps(
            0, 1, mesh, bands=SPATIAL_BANDS)
        lap("float64_composed")

        # DeepLabV2-R101 on {spatial: 2, model: 2}
        config = deeplab_config()
        ds = ColorCodedLabels(SyntheticSegDataset(
            MODEL_DL_STEPS * MODEL_DL_BATCH, DEEPLAB_SIZE, CLASSES,
            seed=SEED + 99, fixed_tints=True), class_colors_for_remap(),
            unmatched=UNMATCHED, seed=SEED)
        loader = DataLoader(ds, MODEL_DL_BATCH, shuffle=True, num_workers=4,
                            seed=SEED)
        tf = make_transform(DEEPLAB_SIZE, CLASSES, antialias=False,
                            augment_cfg=AugmentConfig.from_config(config),
                            decode_label_colors=True)
        state = place_state(build_supervised(config, "deeplab", len(loader),
                                             dev, seed=SEED), mesh)
        clock = _StepClock()
        torch.cuda.reset_peak_memory_stats()
        _composed_fit(out, "deeplab_spatial2_model2", lambda: supervised_fit(
            state, make_train_step(19), lambda epoch: BandedBatches(
                device_batches(loader, tf, dev, seed=SEED, epoch=epoch),
                _band_devices()), _banded_val(dev), epochs=1,
            num_classes=CLASSES, callbacks=[clock], device=dev), clock,
            [state])
        out["deeplab_spatial2_model2"]["peak_mb"] = \
            torch.cuda.max_memory_allocated() / 2 ** 20
        del state
        torch.cuda.empty_cache()
        lap("deeplab_spatial2_model2")

        # the extras on {model: 2}
        mesh = make_mesh_from_config({"model": 2})
        out["f64_extras"] = _axis_extras_f64(mesh)
        lap("float64_extras")
        val = _val_stream()
        aug = AugmentConfig.from_config(load_config())
        src_tf = make_transform(TRAIN_SIZE, CLASSES, antialias=False,
                                augment_cfg=aug, decode_label_colors=True)
        tgt_tf = make_transform(DA_TGT_SIZE, CLASSES, antialias=True)

        def loader_of(n, size, seed, colour, infinite=False):
            ds = SyntheticSegDataset(n, size, CLASSES, seed=seed,
                                     fixed_tints=True)
            if colour:
                ds = ColorCodedLabels(ds, class_colors_for_remap(),
                                      unmatched=UNMATCHED, seed=SEED)
            return DataLoader(ds, TRAIN_BATCH, shuffle=True, num_workers=4,
                              seed=SEED, infinite=infinite)

        # EMA + accumulation
        config = _extras_config(segmentation={"epochs": 1,
                                              "do_validation": 1})
        loader = loader_of(AXIS_EXTRA_STEPS * TRAIN_BATCH, TRAIN_SIZE,
                           SEED + 92, True)
        state = place_state(build_supervised(config, "bisenet", len(loader),
                                             dev, seed=SEED), mesh)
        acc = make_accumulating_train_step(19)
        clock = _StepClock()
        _composed_fit(out, "model2_ema_accumulate", lambda: supervised_fit(
            state, lambda st, xb, yb: acc(st, split_microbatches(xb, 2),
                                          split_microbatches(yb, 2)),
            lambda epoch: device_batches(loader, src_tf, dev, seed=SEED,
                                         epoch=epoch),
            val, epochs=1, num_classes=CLASSES, callbacks=[clock],
            device=dev, ema_decay=0.999), clock, [state])
        del state
        lap("ema_accumulate")

        # self-training: CBST on the sharded generator, ClassMix, the EMA
        # teacher gathered for its forward
        config = _extras_config(domain_adaptation={
            "epochs": 1, "iterations": AXIS_EXTRA_STEPS, "do_validation": 1})
        gen, dis = build_adversarial(config, dev, seed=SEED)
        place_state(gen, mesh)
        place_state(dis, mesh)
        cal = loader_of(2 * TRAIN_BATCH, DA_TGT_SIZE, SEED + 87, False)
        thr = calibrate_class_thresholds(
            gen.model, device_batches(cal, tgt_tf, dev), CLASSES,
            compute_dtype=gen.compute_dtype)
        src = loader_of(AXIS_EXTRA_STEPS * TRAIN_BATCH, TRAIN_SIZE,
                        SEED + 88, True, infinite=True)
        tgt = loader_of(AXIS_EXTRA_STEPS * TRAIN_BATCH, DA_TGT_SIZE,
                        SEED + 89, False, infinite=True)
        step = make_self_training_step(
            float(config.training["domain_adaptation"]["lambda"]),
            AXIS_EXTRA_STEPS, 19, threshold=thr, ema_decay=0.999,
            lambda_ent=0.005, fda_beta=0.01, classmix=True,
            classmix_seed=SEED)
        clock = _StepClock()
        source_iter = device_batches(src, src_tf, dev, seed=SEED)
        target_iter = device_batches(tgt, tgt_tf, dev)
        with contextlib.closing(source_iter), contextlib.closing(target_iter):
            _composed_fit(out, "model2_self_training", lambda: adversarial_fit(
                gen, dis, step, source_iter, target_iter, val,
                iterations=AXIS_EXTRA_STEPS, epochs=1, num_classes=CLASSES,
                callbacks=[clock], device=dev, ema_decay=0.999,
                ema_in_step=True), clock, [gen, dis])
        out["model2_self_training"]["thresholds"] = thr.tolist()
        del gen, dis, step
        torch.cuda.empty_cache()
        lap("self_training")
    f64, extras = out.pop("f64"), out.pop("f64_extras")
    out["cbst"], out["ema_bytes"] = extras["cbst"], extras["ema_bytes"]
    if rank == 0:
        # the float64 states stay in this process: shipping them to the
        # parent (GBs through a pipe) took minutes
        with _one_process():
            one = _par_f64_steps(0, 1)
            one_extras = _axis_extras_f64()
        out["held"] = {mesh: {name: _held_to(f64[mesh][name], one[name])
                              for name in ("supervised", "da_v1")}
                       for mesh in f64}
        out["held"]["model2_extras"] = {
            name: _held_to(extras[name], one_extras[name])
            for name in AXIS_F64_CASES}
        out["one_process"] = {"cbst": one_extras["cbst"],
                              "ema_bytes": one_extras["ema_bytes"]}
        lap("one_process_references")
    return out


def _composed_quad_rank(rank: int, world: int) -> dict:
    """One of four gloo ranks on cuda:0, ``{data: 2, spatial: 2, model:
    2}`` (2 bands each): BiSeNet-R18 supervised at 720x1280, global b8 (4
    frames a data shard), and DA v1 (target 512x1024) through the
    trainers on MultiHostDataLoader shards, K2 in the transforms before
    banding, K1 per band in the validations (each summed matrix held
    against the plain version over the gathered masks)."""
    from rtsds_tpu_torch.parallel import distributed
    from rtsds_tpu_torch.parallel.mesh import (
        make_mesh_from_config, place_state)
    from rtsds_tpu_torch.parallel.spatial import BandedBatches

    torch.cuda.set_device(0)
    _build.load()
    dev = torch.device("cuda")
    out = {}
    checks = []
    val_mod, banded_hist, checked = _banded_hist_check(checks)
    val_mod.banded_hist = checked
    try:
        with distributed.data_parallel(*distributed.axis_groups(
                COMPOSED_QUAD["model"])):
            mesh = make_mesh_from_config(COMPOSED_QUAD)
            val = _banded_val(dev)
            aug = AugmentConfig.from_config(load_config())
            src_tf = make_transform(TRAIN_SIZE, CLASSES, antialias=False,
                                    augment_cfg=aug, decode_label_colors=True)
            config = train_config()
            loader = _par_loader(COMPOSED_STEPS * TRAIN_BATCH, TRAIN_SIZE,
                                 SEED + 93, True)
            state = place_state(build_supervised(config, "bisenet",
                                                 len(loader), dev,
                                                 seed=SEED), mesh)
            clock = _StepClock()
            torch.cuda.reset_peak_memory_stats()
            _composed_fit(out, "bisenet", lambda: supervised_fit(
                state, make_train_step(19), lambda epoch: BandedBatches(
                    device_batches(loader, src_tf, dev, seed=SEED,
                                   epoch=epoch), _band_devices()),
                val, epochs=1, num_classes=CLASSES, callbacks=[clock],
                device=dev), clock, [state])
            out["bisenet"]["peak_mb"] = \
                torch.cuda.max_memory_allocated() / 2 ** 20
            del state
            torch.cuda.empty_cache()

            config = da_config()
            tcfg = config.training["domain_adaptation"]
            gen, dis = build_adversarial(config, dev, seed=SEED)
            place_state(gen, mesh)
            place_state(dis, mesh)
            src = _par_loader(COMPOSED_STEPS * TRAIN_BATCH, TRAIN_SIZE,
                              SEED + 94, True, infinite=True)
            tgt = _par_loader(COMPOSED_STEPS * TRAIN_BATCH, DA_TGT_SIZE,
                              SEED + 95, False, infinite=True)
            tgt_tf = make_transform(DA_TGT_SIZE, CLASSES, antialias=True)
            source = BandedBatches(device_batches(src, src_tf, dev,
                                                  seed=SEED), _band_devices())
            target = BandedBatches(device_batches(tgt, tgt_tf, dev),
                                   _band_devices())
            clock = _StepClock()
            with contextlib.closing(source), contextlib.closing(target):
                _composed_fit(out, "da_v1", lambda: adversarial_fit(
                    gen, dis, make_adversarial_step(
                        float(tcfg["lambda"]), COMPOSED_STEPS, 1, 19, "v1"),
                    iter(source), iter(target), val,
                    iterations=COMPOSED_STEPS, epochs=1, num_classes=CLASSES,
                    callbacks=[clock], device=dev), clock, [gen, dis])
            del gen, dis
            torch.cuda.empty_cache()
            _composed_extras(out, mesh, dev, val, src_tf, tgt_tf)
    finally:
        val_mod.banded_hist = banded_hist
    # the hybrid mesh over the four ranks
    with distributed.data_parallel():
        out["hybrid"] = _hybrid_shards(dev)
    if not checks:
        raise AssertionError("no banded K1 matrix was checked")
    out["banded_k1_matrices_checked"] = len(checks)
    return out


def _composed_extras(out: dict, mesh, dev, val, src_tf, tgt_tf) -> None:
    """On ``{data: 2, spatial: 2, model: 2}`` (ROADMAP 17.5b): DA v1 with
    MinEnt and FDA, and the supervised step accumulated over 2
    micro-batches (each rank's loader holding its share of each), through
    the trainers on banded batches, as :func:`_composed_fit` paths."""
    from rtsds_tpu_torch.parallel.mesh import place_state
    from rtsds_tpu_torch.parallel.spatial import BandedBatches
    from rtsds_tpu_torch.train.accumulate import (
        make_accumulating_train_step, split_microbatches)

    config = da_config()
    tcfg = config.training["domain_adaptation"]
    gen, dis = build_adversarial(config, dev, seed=SEED)
    place_state(gen, mesh)
    place_state(dis, mesh)
    src = _par_loader(COMPOSED_STEPS * TRAIN_BATCH, TRAIN_SIZE, SEED + 110,
                      True, infinite=True)
    tgt = _par_loader(COMPOSED_STEPS * TRAIN_BATCH, DA_TGT_SIZE, SEED + 111,
                      False, infinite=True)
    source = BandedBatches(device_batches(src, src_tf, dev, seed=SEED),
                           _band_devices())
    target = BandedBatches(device_batches(tgt, tgt_tf, dev), _band_devices())
    clock = _StepClock()
    with contextlib.closing(source), contextlib.closing(target):
        _composed_fit(out, "da_v1_minent_fda", lambda: adversarial_fit(
            gen, dis, make_adversarial_step(
                float(tcfg["lambda"]), COMPOSED_STEPS, 1, 19, "v1",
                lambda_ent=0.005, fda_beta=0.01),
            iter(source), iter(target), val, iterations=COMPOSED_STEPS,
            epochs=1, num_classes=CLASSES, callbacks=[clock], device=dev),
            clock, [gen, dis])
    del gen, dis
    torch.cuda.empty_cache()

    config = train_config()
    loader = _par_loader(COMPOSED_STEPS * TRAIN_BATCH, TRAIN_SIZE,
                         SEED + 112, True, micro_batches=2)
    tf = make_transform(TRAIN_SIZE, CLASSES, antialias=False,
                        augment_cfg=AugmentConfig.from_config(config),
                        decode_label_colors=True, micro_batches=2)
    state = place_state(build_supervised(config, "bisenet", len(loader), dev,
                                         seed=SEED), mesh)
    acc = make_accumulating_train_step(19)
    clock = _StepClock()
    _composed_fit(out, "accumulate", lambda: supervised_fit(
        state, lambda st, xb, yb: acc(st, split_microbatches(xb, 2),
                                      split_microbatches(yb, 2)),
        lambda epoch: BandedBatches(device_batches(
            loader, tf, dev, seed=SEED, epoch=epoch), _band_devices()),
        val, epochs=1, num_classes=CLASSES, callbacks=[clock], device=dev),
        clock, [state])
    del state
    torch.cuda.empty_cache()


def _hybrid_shards(dev) -> dict:
    """The hybrid mesh (ROADMAP 17.6) on the job's four ranks as 2 nodes x
    2 local GPUs: each rank's shard of a global b8 DA batch (720x1280
    source, 512x1024 target) under ``shard_batch`` over
    ``make_hybrid_mesh(2)``, bit-identical to its shard on the flat data
    mesh of the same ranks.  The step on those shards is the flat data
    group's step (NCCL reduces hierarchically itself), which the phase
    runs above; the float64 2 x 1 grid's DA step against one process is
    tests/test_torch_spatial_extras_composed.py's."""
    from rtsds_tpu_torch.parallel import distributed
    from rtsds_tpu_torch.parallel import mesh as pm

    rank = distributed.rank()
    hybrid = pm.make_hybrid_mesh(2, devices=pm.job_devices(dev))
    flat = pm.make_mesh(pm.job_devices(dev))
    batch = (*_full_size_batch(), _target_batch())
    shards = {name: [pm.shard_batch(a, m)[rank] for a in batch]
              for name, m in (("flat", flat), ("hybrid", hybrid))}
    result = {"grid": list(hybrid.grid.shape),
              "axis_names": list(hybrid.axis_names),
              "spec": [list(hybrid_spec) for hybrid_spec in
                       pm.hybrid_batch_sharding(hybrid).spec],
              "shards_bit_identical": all(
                  torch.equal(a, b) for a, b in
                  zip(shards["flat"], shards["hybrid"]))}
    if not result["shards_bit_identical"] or result["grid"] != [2, 2]:
        raise AssertionError(f"the hybrid mesh's shards: {result}")
    return result


def phase_parallel_composed() -> dict:
    """(l) Composed meshes (ROADMAP 17.5a) on one card, every rank's bands
    on cuda:0, gloo on CUDA tensors: two ranks (:func:`_composed_pair_rank`)
    and four (:func:`_composed_quad_rank`); the float64 composed steps and
    every float64 model-axis extra held to one process's at the
    shared-card limits (:func:`_held_to`), CBST's thresholds exactly one
    process's, each rank's EMA bytes the placement rule's, every bf16
    path's losses finite and its ranks' gathered parameters bit-identical.
    Returns the K1/K2 launches of each bf16 path, summed over the ranks;
    its step times are a shared card's, not scaling figures."""
    from rtsds_tpu_torch.parallel.fsdp import placement_bytes
    from rtsds_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    pair = run_ranks(_composed_pair_rank, 2, timeout_s=COMPOSED_TIMEOUT_S,
                     threads=None)
    pair_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    quad = run_ranks(_composed_quad_rank, 4, timeout_s=COMPOSED_TIMEOUT_S,
                     threads=None)
    quad_s = time.perf_counter() - t0
    held, one = pair[0]["held"], pair[0]["one_process"]
    model, _ = make_segmentor(load_config(), "bisenet", seed=SEED)
    ema_rule = placement_bytes(model.double(), 2, moments=0)
    for r in pair:
        if r["cbst"] != one["cbst"]:
            raise AssertionError(f"CBST on the model axis: {r['cbst']}")
        if r["ema_bytes"] != ema_rule:
            raise AssertionError(f"EMA bytes {r['ema_bytes']} vs the "
                                 f"placement rule's {ema_rule}")
    paths = {}
    for ranks, names, prefix in (
            (pair, ("deeplab_spatial2_model2", "model2_ema_accumulate",
                    "model2_self_training"), ""),
            (quad, ("bisenet", "da_v1", "da_v1_minent_fda", "accumulate"),
             "data2_spatial2_model2_")):
        for name in names:
            runs = [r[name] for r in ranks]
            if not all(r["params_bit_identical"] for r in runs):
                raise AssertionError(f"{name}: the ranks' parameters differ")
            paths[prefix + name] = {
                k: sum(r["launches"][k] for r in runs)
                for k in ("fast_hist_cuda", "rgb_to_train_ids_cuda")}
    emit({"phase": "parallel_composed",
          "backend": "gloo on CUDA tensors, every rank's 2 bands on cuda:0",
          "float64_vs_one_process": held,
          "cbst_thresholds_equal": True,
          "ema_bytes_per_rank": {"model2": pair[0]["ema_bytes"],
                                 "placement_rule": ema_rule,
                                 "replicated": one["ema_bytes"]},
          "quad": {"mesh": COMPOSED_QUAD, "image_size": list(TRAIN_SIZE),
                   "global_batch": TRAIN_BATCH,
                   "da_target_size": list(DA_TGT_SIZE),
                   "steps": COMPOSED_STEPS,
                   **{name: {k: v for k, v in quad[0][name].items()
                             if k != "launches"}
                      for name in ("bisenet", "da_v1", "da_v1_minent_fda",
                                   "accumulate")},
                   "hybrid_2x2_shards": quad[0]["hybrid"],
                   "banded_k1_matrices_checked": [
                       r["banded_k1_matrices_checked"] for r in quad],
                   "peak_mb_per_rank": [r["bisenet"]["peak_mb"]
                                        for r in quad]},
          "pair": {name: {k: v for k, v in pair[0][name].items()
                          if k != "launches"}
                   for name in ("deeplab_spatial2_model2",
                                "model2_ema_accumulate",
                                "model2_self_training")},
          "deeplab_size": list(DEEPLAB_SIZE),
          "deeplab_global_batch": MODEL_DL_BATCH,
          "pair_s": pair_s, "pair_seconds_by_part": pair[0]["seconds"],
          "quad_s": quad_s, "launches": paths})
    return paths


def phase_parallel_composed_nccl_world1() -> dict:
    """(m) NCCL at world size 1 on a composed mesh.  First the CLI:
    ``--multihost`` with ``mesh: {spatial: 2}`` and the data axis forced
    on (:func:`forced_data_axis`), BiSeNet-R18 at 720x1280 b8 bf16 on
    colour-coded labels for 2 steps on 2 bands of cuda:0 (K2 before
    banding; the banded BN's all-reduces under NCCL) and a validation (K1
    per band, the matrix all-reduced), its checkpoint served by
    ``Predictor.from_checkpoint`` with the masks of a predictor of the
    checkpoint's weights.  Then one composed step with every collective
    forced on (the data axis, and the model axis over the one rank, so
    that NCCL's gather and reduce-scatter run) on 2 bands: in float64
    (b2 at PAR_F64_SIZE) against the plain one-device step, within
    F64_UPDATE_SHARE of each update, and in bf16 (b8 at 720x1280) timed
    beside the plain step.  Returns the CLI path's launches."""
    import torch.distributed as dist

    from rtsds_tpu_torch import cli
    from rtsds_tpu_torch.parallel import distributed
    from rtsds_tpu_torch.parallel.fsdp import shard_state
    from rtsds_tpu_torch.parallel.mesh import initialize_multihost
    from rtsds_tpu_torch.parallel.spatial import split_batch

    tmp = tempfile.TemporaryDirectory(prefix="rtsds_smoke_composed_")
    config = os.path.join(tmp.name, "config.yaml")
    with open(config, "w") as f:
        f.write(f"""
precision: {{compute_dtype: bfloat16}}
mesh: {{spatial: {SPATIAL_BANDS}}}
data:
  cityscapes: {{image_size: "{TRAIN_VAL_SIZE[0]}, {TRAIN_VAL_SIZE[1]}",
               batch_size: {TRAIN_BATCH}, num_workers: 4}}
  gta5_modified: {{image_size: "{TRAIN_SIZE[0]}, {TRAIN_SIZE[1]}",
                  batch_size: {TRAIN_BATCH}, num_workers: 4,
                  decode_label_colors: true}}
training:
  segmentation: {{epochs: 1, do_validation: 1}}
callbacks:
  model_checkpoint: {{save_dir: "{tmp.name}", save_name: "m",
                     save_best: true}}
""")
    os.environ["RTSDS_NUM_PROCESSES"] = "1"
    try:
        with forced_data_axis() as collectives:
            t0 = time.perf_counter()
            history, launches, checked = on_main_path(lambda: cli.main(
                ["--config", config, "--synthetic", "--dataset", "gta5",
                 "--multihost"]))
            cli_s = time.perf_counter() - t0
    finally:
        os.environ.pop("RTSDS_NUM_PROCESSES", None)
    if len(history) != 1 or not math.isfinite(history[0]["train_loss"]) \
            or not collectives["all_reduce"]:
        raise AssertionError(f"the composed --multihost run: {history}, "
                             f"{collectives}")
    frames = np.stack([SyntheticSegDataset(
        2, MODEL_SERVE_SIZE, CLASSES, seed=SEED + 3, fixed_tints=True)[i][0]
        for i in range(2)])
    kw = dict(image_size=MODEL_SERVE_SIZE, batch_size=2,
              dtype=torch.bfloat16)
    ckpt = os.path.join(tmp.name, "m")
    served = Predictor.from_checkpoint(ckpt, **kw).predict(frames)
    saved = torch.load(os.path.join(ckpt, "epoch_0.pt"), map_location="cpu",
                       weights_only=True)["model"]["model"]
    if not np.array_equal(served, Predictor(state=saved, **kw).predict(
            frames)):
        raise AssertionError("the composed checkpoint serves other masks")
    tmp.cleanup()
    torch.cuda.empty_cache()

    os.environ["RTSDS_NUM_PROCESSES"] = "1"
    initialize_multihost(device_type="cuda", spatial=SPATIAL_BANDS)
    calls = {"all_reduce": 0, "all_gather_into_tensor": 0,
             "reduce_scatter_tensor": 0}
    plain = {name: getattr(dist, name) for name in calls}

    def counted(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return plain[name](*args, **kwargs)
        return call
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}")
        for name in calls:
            setattr(dist, name, counted(name))
        images, labels, _ = _par_f64_inputs()
        x, y = images[:2].cuda(), labels[:2].cuda()
        after = []
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False,
                                        allow_tf32=False):
            for composed in (False, True):
                distributed._GROUP = distributed._JOB = (
                    dist.group.WORLD if composed else None)
                model, _ = make_segmentor(load_config(), "bisenet",
                                          seed=SEED)
                model.to("cuda", torch.float64)
                before = {k: v.detach().clone()
                          for k, v in model.state_dict().items()}
                state = TrainState(model, make_optimizer(
                    "SGD", model.parameters(), 0.01, momentum=0.9))
                args = (x, y)
                if composed:
                    distributed.convert_global_batchnorm(model)
                    shard_state(state, dist.group.WORLD)
                    args = split_batch(x, y, _band_devices())
                make_train_step(19)(state, *args)
                after.append(state.state_dict()["model"])
        err = 0.0
        for k, v in after[0].items():
            if v.is_floating_point():
                scale = v.abs().max() if "running" in k \
                    else (v - before[k]).abs().max()
                err = max(err, float((after[1][k] - v).abs().max())
                          / (F64_UPDATE_SHARE * float(scale) + 1e-15))
        batch = _full_size_batch()
        times = {}
        for name, composed in (("plain_one_device", False),
                               ("composed_forced_two_bands", True)):
            distributed._GROUP = distributed._JOB = (
                dist.group.WORLD if composed else None)
            state = build_supervised(train_config(), "bisenet", 1, "cuda",
                                     seed=SEED)
            args = batch
            if composed:
                distributed.convert_global_batchnorm(state.model)
                shard_state(state, dist.group.WORLD)
                args = split_batch(*batch, _band_devices())
            step = make_train_step(19)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            times[name] = {
                "step_p50_ms": cuda_ms(lambda: step(state, *args), reps=10),
                "peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20}
            del state
        if err > 1.0 or not all(calls.values()):
            raise AssertionError(f"composed step under NCCL: err {err}, "
                                 f"calls {calls}")
    finally:
        for name, fn in plain.items():
            setattr(dist, name, fn)
        distributed._GROUP = distributed._JOB = distributed._MODEL = None
        dist.destroy_process_group()
        os.environ.pop("RTSDS_NUM_PROCESSES", None)
    emit({"phase": "parallel_composed_nccl_world1", "backend": "nccl",
          "world_size": 1, "bands": SPATIAL_BANDS,
          "cli": {"mesh": {"spatial": SPATIAL_BANDS}, "argv": "--multihost",
                  "data_axis": "forced on", "history": history,
                  "cli_s": cli_s, "collectives": collectives,
                  "k2_checked": checked,
                  "checkpoint_served_masks_equal": True},
          "float64_step_worst_err_over_limit_vs_plain": err,
          "collective_calls": calls, "image_size": list(TRAIN_SIZE),
          "batch": TRAIN_BATCH,
          "one_card_not_a_scaling_figure": times, "launches": launches})
    return launches


def composed_phases() -> dict:
    """The composed meshes (l) and (m); returns the K1 and K2 launches of
    their main paths, by path."""
    t0 = time.perf_counter()
    paths = phase_parallel_composed()
    torch.cuda.empty_cache()
    paths["nccl_world1_cli_spatial2"] = phase_parallel_composed_nccl_world1()
    torch.cuda.empty_cache()
    emit({"phase": "composed", "seconds": time.perf_counter() - t0})
    return paths


def parallel_phases(tree: dict, frames: np.ndarray, dl_tree: dict,
                    dl_frames: np.ndarray) -> dict:
    """The parallel phase (a)-(m); returns the K1 and K2 launches of its
    main paths (the spatial path launches K1 alone)."""
    t0 = time.perf_counter()
    shared = phase_parallel_shared_card()
    torch.cuda.empty_cache()
    nccl = phase_parallel_nccl_cli()
    torch.cuda.empty_cache()
    phase_parallel_serving(tree, frames)
    torch.cuda.empty_cache()
    pipe = phase_parallel_pipe()
    torch.cuda.empty_cache()
    extras = phase_parallel_extras()
    torch.cuda.empty_cache()
    extras_cli = phase_parallel_extras_nccl_cli()
    torch.cuda.empty_cache()
    spatial = phase_spatial_serving(tree, frames, dl_tree, dl_frames)
    torch.cuda.empty_cache()
    model_axis = phase_parallel_model_axis(frames)
    torch.cuda.empty_cache()
    phase_parallel_model_nccl_world1()
    torch.cuda.empty_cache()
    spatial_train = phase_parallel_spatial_training(frames)
    torch.cuda.empty_cache()
    sliding = phase_spatial_sliding(frames, dl_tree)
    torch.cuda.empty_cache()
    extras_on_bands = spatial_extras_launched(tree)
    torch.cuda.empty_cache()
    composed = composed_phases()
    paths = {"dp2_bisenet_training": shared["supervised"],
             "dp2_bisenet_da": shared["da"],
             "nccl_world1_cli_training": nccl,
             "pipe2_deeplab_training": pipe,
             **{f"dp2_bisenet_{k}": n for k, n in extras.items()},
             **{f"nccl_world1_cli_{k}": n for k, n in extras_cli.items()},
             "model2_bisenet_training": model_axis["bisenet"],
             "model2_deeplab_training": model_axis["deeplab"],
             "spatial2_bisenet_training": spatial_train["bisenet"],
             "spatial2_bisenet_da": spatial_train["da"],
             "spatial2_deeplab_training": spatial_train["deeplab"],
             **{f"spatial2_{k}": n for k, n in extras_on_bands.items()
                if not k.startswith("validation_")},
             **composed}
    emit({"phase": "parallel", "seconds": time.perf_counter() - t0})
    launches = {kernel: {path: n[kernel] for path, n in paths.items()}
                for kernel in ("fast_hist_cuda", "rgb_to_train_ids_cuda")}
    launches["fast_hist_cuda"]["bisenet_deeplab_spatial_serving"] = \
        spatial["fast_hist_cuda"]
    launches["fast_hist_cuda"]["deeplab_spatial_sliding"] = \
        sliding["fast_hist_cuda"]
    for k, n in extras_on_bands.items():
        if k.startswith("validation_"):
            launches["fast_hist_cuda"][f"spatial2_bisenet_{k}"] = \
                n["fast_hist_cuda"]
    return launches


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


def tooling_phases(frames, tree, dl_frames, dl_tree) -> dict:
    """The serving artifacts, the training tooling and the GTA5 converter;
    returns the K1 and K2 launches of their main paths."""
    phase_serving_artifact(tree, frames, dl_tree, dl_frames)
    torch.cuda.empty_cache()
    tooling = phase_training_tooling()
    torch.cuda.empty_cache()
    convert = phase_convert_gta5()
    if convert["fast_hist_cuda"]:
        raise AssertionError("the converter launched K1")
    return {"fast_hist_cuda": {
                "bisenet_training_tooling": tooling["fast_hist_cuda"]},
            "rgb_to_train_ids_cuda": {
                "bisenet_training_tooling": tooling["rgb_to_train_ids_cuda"],
                "convert_gta5": convert["rgb_to_train_ids_cuda"]}}


def _check_launched(paths: dict) -> None:
    """Fail unless K1 and K2 launched on every path of ``{path: {kernel:
    launches}}``."""
    for path, counts in paths.items():
        missed = [k for k, n in counts.items() if n < 1]
        if missed:
            raise AssertionError(f"{path} never launched {missed}")


def main() -> int:
    if sys.argv[1:] == ["--kernels-only"]:
        return kernels_only()
    if sys.argv[1:] == ["--composed-only"]:
        phase_device()
        _check_launched(composed_phases())
        print(gpu_name_and_power_limit(), flush=True)
        return 0
    if sys.argv[1:] in (["--int8-only"], ["--tooling-only"],
                        ["--parallel-only"], ["--spatial-only"],
                        ["--axes-only"], ["--spatial-extras-only"]):
        phase_device()
        frames, labels, tree, dl_frames, dl_tree = serving_data()
        if sys.argv[1] == "--axes-only":
            launches = {
                "model2": phase_parallel_model_axis(frames),
                "nccl_world1": phase_parallel_model_nccl_world1(),
                **{f"spatial2_{k}": v for k, v in
                   phase_parallel_spatial_training(frames).items()},
                "sliding": phase_spatial_sliding(frames, dl_tree),
                **{f"spatial2_{k}": v for k, v in
                   spatial_extras_launched(tree).items()}}
            composed = composed_phases()
            _check_launched(composed)
            launches.update(composed)
            emit({"phase": "axes_only", "launches": launches})
        elif sys.argv[1] == "--spatial-extras-only":
            emit({"phase": "spatial_extras_only",
                  "launches": spatial_extras_launched(tree)})
        elif sys.argv[1] == "--int8-only":
            int8_phases(frames, labels, tree, dl_frames, dl_tree)
        elif sys.argv[1] == "--tooling-only":
            tooling_phases(frames, tree, dl_frames, dl_tree)
        elif sys.argv[1] == "--spatial-only":
            if phase_spatial_serving(tree, frames, dl_tree, dl_frames)[
                    "fast_hist_cuda"] < 1:
                raise AssertionError("the spatial path never launched K1")
        else:
            launches = parallel_phases(tree, frames, dl_tree, dl_frames)
            for kernel, paths in launches.items():
                missed = [p for p, n in paths.items() if n < 1]
                if missed:
                    raise AssertionError(f"{kernel} never launched on "
                                         f"{missed}")
        print(gpu_name_and_power_limit(), flush=True)
        return 0
    if sys.argv[1:]:
        raise SystemExit(f"usage: {sys.argv[0]} [--kernels-only | "
                         f"--int8-only | --tooling-only | --parallel-only | "
                         f"--spatial-only | --axes-only | --composed-only | "
                         f"--spatial-extras-only]")
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
    # main paths 18-19: the training tooling through the CLI (K1, K2) and
    # the GTA5 converter (K2); the serving artifacts run no hand-written
    # kernel (counts reset inside each, just before)
    tools = tooling_phases(frames, tree, dl_frames, dl_tree)
    # main paths 20-31: two ranks sharing the card (gloo), training, DA,
    # self-training, distillation (bf16 and int8 teachers) and QAT; the
    # CLI's --multihost under NCCL at world size 1 (training,
    # self-training, int8-teacher distillation); the pipelined DeepLab
    # step; spatial serving, whose mask agreements K1 reads; the model and
    # spatial axes; the composed meshes and the model axis's extras (counts
    # reset inside each, just before, on every rank); the batch-mesh
    # serving runs no hand-written kernel
    par = parallel_phases(tree, frames, dl_tree, dl_frames)

    hist_paths = {"bisenet_serving_validation": serve_launches,
                  "bisenet_training": train_launches["fast_hist_cuda"],
                  "bisenet_da": da_launches["fast_hist_cuda"],
                  **{f"deeplab_validation_{k}": n for k, n in dl_val.items()},
                  "deeplab_training": dl_train["launches"]["fast_hist_cuda"],
                  "deeplab_da": dl_da["launches"]["fast_hist_cuda"],
                  **{f"bisenet_{k}": n["fast_hist_cuda"]
                     for k, n in extras.items()},
                  "bisenet_serving_checkpoint": serve_ckpt["fast_hist_cuda"],
                  **int8["fast_hist_cuda"], **tools["fast_hist_cuda"],
                  **par["fast_hist_cuda"]}
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
        **int8["rgb_to_train_ids_cuda"], **tools["rgb_to_train_ids_cuda"],
        **par["rgb_to_train_ids_cuda"]}
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
