"""RTSDS in PyTorch and CUDA, for one NVIDIA Hopper GPU.

A port of the ``rtsds_tpu`` package (JAX on a TPU).  Module paths mirror
that package, so each counterpart is found by name; the public functions
keep its layouts (frames (N, H, W, 3) uint8, masks (N, H, W), confusion
matrices (n, n) int32) while the models run NCHW inside.

Entry points run on the GPU unless the caller asks for the CPU: see
:func:`rtsds_tpu_torch.device.resolve_device`.  What the port does:

* models: BiSeNet (ResNet-18/101 context path) and DeepLabV2-R101, with
  the weight bridge from the JAX package's Flax trees and its exported
  ``.pth`` files (:mod:`rtsds_tpu_torch.models`);
* serving (:mod:`rtsds_tpu_torch.serve`): trained checkpoints through
  ``Predictor.from_checkpoint`` (the ``ema`` item preferred), batches or a
  stream with one batch in flight (``predict_iter``), under the plain,
  sliding-window or multi-scale + flip protocol, and the serve CLI; the
  micro-batching HTTP server (:mod:`rtsds_tpu_torch.serve_server`);
* mIoU validation (:mod:`rtsds_tpu_torch.eval`) with the confusion-matrix
  CUDA kernel (:mod:`rtsds_tpu_torch.ops.cuda.hist`);
* training through ``python -m rtsds_tpu_torch.cli``
  (:mod:`rtsds_tpu_torch.train`): supervised, and adversarial GTA5 ->
  Cityscapes domain adaptation (v1, its gradient-reversal form, v2), with
  the extras (EMA, gradient accumulation, MinEnt, FDA, mean-teacher
  self-training with CBST and ClassMix, distillation), on raw GTA5 labels
  remapped on the device by the RGB -> trainId CUDA kernel
  (:mod:`rtsds_tpu_torch.ops.cuda.remap`);
* W8A8 int8 (:mod:`rtsds_tpu_torch.ops.quant`): post-training
  quantization of BiSeNet and DeepLabV2 with max-abs or percentile
  calibration, served through ``Predictor(quantize="int8")``, the serve
  CLI and the server; quantization-aware fine-tuning (``python -m
  rtsds_tpu_torch.qat``) with its activation-scale sidecar; the int8
  distillation teacher; the offline pseudo-label sweep (``python -m
  rtsds_tpu_torch.pseudo_label``);
* parallelism (:mod:`rtsds_tpu_torch.parallel`): data-parallel training,
  DA (self-training and distillation included), QAT and validation over
  processes (``--multihost``, one process per GPU: global-batch
  BatchNorm, global loss denominators and calibration statistics, summed
  gradients, rank-0 writes), the model axis over processes (``mesh:
  {model: M}`` or ``{data: D, model: M}``: FSDP, each rank keeping its
  shard of every large parameter and of its moments), the spatial axis in
  training over one process's devices (``mesh: {spatial: S}``: each
  frame's rows in bands), alone and composed with the data and model
  axes, every training extra and validation protocol on each,
  batch-sharded and height-banded (spatial) serving over a mesh of
  devices, under every protocol (``Predictor(mesh=, sharding=)``,
  ``--mesh batch|spatial``), the GPipe-pipelined DeepLabV2 step
  (``mesh: {pipe: N}``), and the hybrid (nodes x local GPUs) mesh of the
  data axis (``parallel.make_hybrid_mesh``, ``hybrid_batch_sharding``);
* tools: ``ckpt_info`` (what a checkpoint directory holds),
  ``export_torch`` (a checkpoint's weights in the reference models'
  layouts), tracing (:mod:`rtsds_tpu_torch.utils.profiling`), and the
  benches (:mod:`rtsds_tpu_torch.bench`; ``python -m
  rtsds_tpu_torch.bench`` prints the one-line record).

It does all that the JAX package does (``ROADMAP.md``, queue A).
"""
