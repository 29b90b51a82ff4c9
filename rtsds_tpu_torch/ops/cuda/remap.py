"""RGB -> trainId label remap on the GPU: the wrapper of ``csrc/remap.cu``.

Counterpart of ``rtsds_tpu/ops/pallas/remap.py``.  On CPU tensors the
wrapper computes the plain PyTorch version
(:func:`rtsds_tpu_torch.ops.remap.rgb_to_train_ids`); on CUDA tensors it
launches the kernel or raises.

The kernel looks each pixel's 24-bit key up in a hash table that the host
builds once per colour table (:func:`remap_table`, cached), so a call does
only its checks, the output's allocation and the launch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from rtsds_tpu_torch.ops.cuda import _build
from rtsds_tpu_torch.ops.remap import rgb_to_train_ids
from rtsds_tpu_torch.utils.colors import class_colors_for_remap

MAX_KEYS = 128  # a trainId must fit in the 7 bits above a slot's key
MIN_BITS, MAX_BITS = 5, 9  # 32 to 512 slots: 128 B to 2 KB of parameters
EMPTY = 0xFFFFFFFF  # bit 31 set: no 24-bit key matches an empty slot
SEARCH_SEED = 0
SEARCH_MULTIPLIERS = 8192  # seeded odd candidates tried at each size


def pack_keys(color_table) -> np.ndarray:
    """(C, 3) RGB table -> (C,) int32 keys ``R*65536 + G*256 + B``.

    A row with a channel outside [0, 255] matches no uint8 pixel in the
    plain version's per-channel compare, so its key is -1, which no pixel
    forms."""
    table = np.asarray(color_table, dtype=np.int64).reshape(-1, 3)
    keys = table[:, 0] * 65536 + table[:, 1] * 256 + table[:, 2]
    valid = ((table >= 0) & (table <= 255)).all(axis=1)
    return np.where(valid, keys, -1).astype(np.int32)


class HashTable(NamedTuple):
    """The kernel's lookup table: a pixel with key ``k`` reads ``probes``
    slots from ``(k * multiplier mod 2**32) >> (32 - bits)`` on (mod
    ``2**bits``), and takes the id of the slot whose key is ``k``."""
    slots: np.ndarray  # (2**bits,) uint32: key | id << 24, or EMPTY
    bits: int
    multiplier: int    # odd, < 2**32
    probes: int


def _homes(keys: np.ndarray, multipliers: np.ndarray, bits: int):
    """(multipliers, keys) int64 home slots of the multiplicative hash."""
    prod = (multipliers[:, None] * keys[None, :].astype(np.uint64)) \
        & np.uint64(0xFFFFFFFF)
    return (prod >> np.uint64(32 - bits)).astype(np.int64)


def _max_probes(homes: np.ndarray, bits: int) -> np.ndarray:
    """Per row of ``homes``: the probes a lookup needs when the keys are
    inserted in order with linear probing (1 + the longest displacement)."""
    tries, n = homes.shape
    size = 1 << bits
    taken = np.zeros((tries, size), bool)
    longest = np.zeros(tries, np.int64)
    rows = np.arange(tries)
    for k in range(n):
        pos = homes[:, k].copy()
        todo = np.ones(tries, bool)
        dist = 0
        while todo.any():
            free = todo & ~taken[rows, pos]
            taken[rows[free], pos[free]] = True
            longest[free] = np.maximum(longest[free], dist)
            todo &= ~free
            pos = (pos + 1) & (size - 1)
            dist += 1
    return longest + 1


def build_hash_table(keys: np.ndarray) -> HashTable:
    """The kernel's table for packed ``keys`` (:func:`pack_keys`).

    Rows with key -1 are dropped and only the first row of each key is
    kept, which keeps the first-match rule.  For each size from the
    smallest that holds the keys (at least 32 slots, one per shared-memory
    bank) to 512, ``SEARCH_MULTIPLIERS`` odd multipliers drawn from
    ``SEARCH_SEED`` are tried; the first size with a perfect hash (one
    probe) wins, else the size and multiplier with the fewest probes.  The
    search is deterministic."""
    keys = np.asarray(keys)
    if not 0 < len(keys) <= MAX_KEYS:
        raise ValueError(f"the colour table must have 1 to {MAX_KEYS} rows, "
                         f"got {len(keys)}")
    first: dict[int, int] = {}
    for row, key in enumerate(keys.tolist()):
        if key >= 0 and key not in first:
            first[key] = row
    uniq = np.fromiter(first, np.int64, len(first))
    ids = np.fromiter(first.values(), np.int64, len(first))
    multipliers = np.random.default_rng(SEARCH_SEED).integers(
        0, 2**31, SEARCH_MULTIPLIERS, dtype=np.uint64) * np.uint64(2) \
        + np.uint64(1)
    lowest = max(MIN_BITS, int(np.ceil(np.log2(max(len(uniq), 1)))))
    best = None
    for bits in range(lowest, MAX_BITS + 1):
        homes = _homes(uniq, multipliers, bits)
        ordered = np.sort(homes, axis=1)
        perfect = (np.diff(ordered, axis=1) != 0).all(axis=1)
        if perfect.any():
            best = (1, bits, int(multipliers[np.argmax(perfect)]))
            break
        probes = _max_probes(homes, bits)
        i = int(np.argmin(probes))
        if best is None or probes[i] < best[0]:
            best = (int(probes[i]), bits, int(multipliers[i]))
    probes, bits, multiplier = best
    slots = np.full(1 << bits, EMPTY, np.uint32)
    homes = _homes(uniq, np.array([multiplier], np.uint64), bits)[0]
    for key, row, home in zip(uniq.tolist(), ids.tolist(), homes.tolist()):
        pos = home
        while slots[pos] != EMPTY:
            pos = (pos + 1) & ((1 << bits) - 1)
        slots[pos] = key | row << 24
    slots.setflags(write=False)  # cached and shared by every caller
    return HashTable(slots, bits, multiplier, probes)


@functools.lru_cache(maxsize=16)
def _cached_table(spec) -> HashTable:
    if spec is None:
        table = class_colors_for_remap()
    else:
        dtype, shape, data = spec
        table = np.frombuffer(data, dtype).reshape(shape)
    return build_hash_table(pack_keys(table))


def remap_table(color_table=None) -> HashTable:
    """The kernel's hash table for ``color_table`` (default: the GTA5 keys
    of :func:`class_colors_for_remap`), built on the first call for that
    table and cached."""
    if color_table is None:
        return _cached_table(None)
    table = np.asarray(color_table)
    return _cached_table((table.dtype.str, table.shape, table.tobytes()))


def rgb_to_train_ids_cuda(rgb: torch.Tensor, color_table=None,
                          default_id: int = 255) -> torch.Tensor:
    """(..., 3) RGB label colours -> (...) int32 trainIds: the index of the
    first matching row of ``color_table``, else ``default_id``.

    On the GPU the input must be uint8, so that the kernel's packed 24-bit
    key and the plain version's per-channel compare always agree.
    """
    if rgb.shape[-1:] != (3,):
        raise ValueError(f"expected (..., 3) RGB, got {tuple(rgb.shape)}")
    table = remap_table(color_table)
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
    if rgb.data_ptr() % 16:  # the kernel reads aligned 16-byte vectors
        rgb = rgb.clone()
    lib = _build.load()
    with torch.cuda.device(device):  # the launch goes to the current device
        code = lib.rtsds_remap_launch(
            rgb.data_ptr(), out.data_ptr(), n_pixels, table.slots.ctypes.data,
            table.bits, table.multiplier, table.probes, int(default_id),
            torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, code, "RGB remap kernel launch")
    rgb_to_train_ids_cuda.launches += 1
    return out


rgb_to_train_ids_cuda.launches = 0  # kernel launches since the last reset
