"""RGB -> trainId label remap on the GPU: the wrapper of ``csrc/remap.cu``.

Counterpart of ``rtsds_tpu/ops/pallas/remap.py``.  On CPU tensors the
wrapper computes the plain PyTorch version
(:func:`rtsds_tpu_torch.ops.remap.rgb_to_train_ids`); on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rtsds_tpu_torch.ops.cuda import _build
from rtsds_tpu_torch.ops.remap import rgb_to_train_ids
from rtsds_tpu_torch.utils.colors import class_colors_for_remap

MAX_KEYS = 128  # the kernel stages the class keys in 512 B of smem
BLOCKS_PER_SM = 8  # 8 x 256 threads fill an SM


def pack_keys(color_table) -> np.ndarray:
    """(C, 3) RGB table -> (C,) int32 keys ``R*65536 + G*256 + B``.

    A row with a channel outside [0, 255] matches no uint8 pixel in the
    plain version's per-channel compare, so its key is -1, which no pixel
    forms."""
    table = np.asarray(color_table, dtype=np.int64).reshape(-1, 3)
    keys = table[:, 0] * 65536 + table[:, 1] * 256 + table[:, 2]
    valid = ((table >= 0) & (table <= 255)).all(axis=1)
    return np.where(valid, keys, -1).astype(np.int32)


@functools.lru_cache(maxsize=16)
def _device_keys(key_bytes: bytes, device: torch.device) -> torch.Tensor:
    keys = np.frombuffer(key_bytes, dtype=np.int32)
    return torch.from_numpy(keys.copy()).to(device)


def rgb_to_train_ids_cuda(rgb: torch.Tensor, color_table=None,
                          default_id: int = 255) -> torch.Tensor:
    """(..., 3) RGB label colours -> (...) int32 trainIds: the index of the
    first matching row of ``color_table``, else ``default_id``.

    On the GPU the input must be uint8, so that the kernel's packed 24-bit
    key and the plain version's per-channel compare always agree.
    """
    if rgb.shape[-1:] != (3,):
        raise ValueError(f"expected (..., 3) RGB, got {tuple(rgb.shape)}")
    if color_table is None:
        color_table = class_colors_for_remap()
    keys = pack_keys(color_table)
    if not 0 < len(keys) <= MAX_KEYS:
        raise ValueError(f"the colour table must have 1 to {MAX_KEYS} rows, "
                         f"got {len(keys)}")
    if not -2**31 <= int(default_id) < 2**31:
        raise ValueError(f"default_id {default_id} does not fit in int32")
    if rgb.device.type == "cpu":
        return rgb_to_train_ids(rgb, color_table, default_id)
    if rgb.device.type != "cuda":
        raise ValueError(f"rgb on {rgb.device}: expected a CPU or CUDA "
                         f"tensor")
    if rgb.dtype != torch.uint8:
        raise TypeError(f"the CUDA remap takes uint8 RGB, got {rgb.dtype}")

    device = rgb.device
    out = torch.empty(rgb.shape[:-1], dtype=torch.int32, device=device)
    n_pixels = out.numel()
    if n_pixels == 0:
        return out
    rgb = rgb.contiguous()
    if rgb.data_ptr() % 4:  # the kernel reads aligned 32-bit words
        rgb = rgb.clone()
    class_keys = _device_keys(keys.tobytes(), device)
    lib = _build.load()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    with torch.cuda.device(device):  # the launch goes to the current device
        code = lib.rtsds_remap_launch(
            rgb.data_ptr(), class_keys.data_ptr(), len(keys), int(default_id),
            out.data_ptr(), n_pixels, sms * BLOCKS_PER_SM,
            torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, code, "RGB remap kernel launch")
    rgb_to_train_ids_cuda.launches += 1
    return out


rgb_to_train_ids_cuda.launches = 0  # kernel launches since the last reset
