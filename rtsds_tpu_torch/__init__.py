"""RTSDS in PyTorch and CUDA, for one NVIDIA Hopper GPU.

A port of the ``rtsds_tpu`` package (JAX on a TPU).  Module paths mirror
that package, so each counterpart is found by name; the public functions
keep its layouts (frames (N, H, W, 3) uint8, masks (N, H, W), confusion
matrices (n, n) int32) while the models run NCHW inside.

Entry points run on the GPU unless the caller asks for the CPU: see
:func:`rtsds_tpu_torch.device.resolve_device`.  Ported so far: BiSeNet
serving (:mod:`rtsds_tpu_torch.serve`) and mIoU validation
(:mod:`rtsds_tpu_torch.eval.validate`) with the confusion-matrix CUDA
kernel (:mod:`rtsds_tpu_torch.ops.cuda.hist`).
"""
