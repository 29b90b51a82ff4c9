"""The port's RGB -> trainId remap (plain version and the K2 wrapper's CPU
path) against the JAX package's vectorized remap and its Pallas kernel in
interpret mode, on the same numpy inputs: exact.  The kernel's hash-table
lookup, emulated in numpy, is held exactly against the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cuda import DEFAULT_IDS, EDGE_TABLES, edge_pixels

from rtsds_tpu.ops.pallas.remap import rgb_to_train_ids_pallas
from rtsds_tpu.ops.remap import rgb_to_train_ids as jax_remap
from rtsds_tpu.utils.colors import class_colors_for_remap as jax_colors
from rtsds_tpu_torch.ops.cuda.remap import (
    EMPTY, MAX_BITS, HashTable, build_hash_table, pack_keys, remap_table,
    rgb_to_train_ids_cuda)
from rtsds_tpu_torch.ops.remap import rgb_to_train_ids
from rtsds_tpu_torch.utils.colors import class_colors_for_remap


def _labels(rng, shape, table, unmatched=0.1):
    """Key colours of ``table`` with ``unmatched`` random colours."""
    rgb = table[rng.integers(0, len(table), shape)]
    off = rng.random(shape) < unmatched
    rgb[off] = rng.integers(0, 256, (int(off.sum()), 3))
    return rgb.astype(np.uint8)


def test_color_table_matches_jax():
    np.testing.assert_array_equal(class_colors_for_remap(), jax_colors())
    assert class_colors_for_remap().dtype == np.uint8


CUSTOM = np.array([[10, 20, 30], [0, 0, 0], [255, 255, 255], [10, 20, 30],
                   [7, 7, 7]], np.uint8)  # row 3 repeats row 0


@pytest.mark.parametrize("table,default_id,shape", [
    (None, 255, (2, 37, 53)),
    (None, 0, (3, 37, 53)),
    (CUSTOM, 255, (37, 53)),
    (CUSTOM, 7, (1, 41, 29)),
])
def test_remap_matches_jax_and_pallas(table, default_id, shape):
    rng = np.random.default_rng(0)
    keys = jax_colors() if table is None else table
    rgb = _labels(rng, shape, keys)
    want = np.asarray(jax_remap(jnp.asarray(rgb), table,
                                default_id=default_id))
    pallas = np.asarray(rgb_to_train_ids_pallas(
        jnp.asarray(rgb), table, default_id=default_id, interpret=True))
    np.testing.assert_array_equal(pallas, want)
    for fn in (rgb_to_train_ids, rgb_to_train_ids_cuda):
        got = fn(torch.from_numpy(rgb), table, default_id=default_id)
        assert got.dtype == torch.int32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want)
    assert (want == default_id).any()


def test_reference_compat_fills_road():
    """The JAX package's ``reference_compat=True`` is ``default_id=0``."""
    rgb = _labels(np.random.default_rng(1), (2, 16, 16), jax_colors())
    want = np.asarray(jax_remap(jnp.asarray(rgb), reference_compat=True))
    for fn in (rgb_to_train_ids, rgb_to_train_ids_cuda):
        got = fn(torch.from_numpy(rgb), default_id=0)
        np.testing.assert_array_equal(got.numpy(), want)


def test_int_inputs_compare_per_channel():
    """Int colours outside [0, 255] can alias a packed key; the plain
    version compares channels, as the JAX version does."""
    rgb = np.array([[[0, 1, 0], [0, 0, 256], [128, 64, 128]]], np.int64)
    table = np.array([[0, 1, 0], [128, 64, 128]])
    want = np.asarray(jax_remap(jnp.asarray(rgb), table))
    got = rgb_to_train_ids(torch.from_numpy(rgb), table)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [[0, 255, 1]]


def test_empty_input():
    got = rgb_to_train_ids_cuda(torch.zeros((0, 3), dtype=torch.uint8))
    assert got.shape == (0,) and got.dtype == torch.int32


def test_pack_keys_drops_rows_no_uint8_pixel_matches():
    keys = pack_keys([[1, 2, 3], [0, 0, 256], [-1, 0, 0]])
    assert keys.tolist() == [65536 + 2 * 256 + 3, -1, -1]


def test_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="128"):
        rgb_to_train_ids_cuda(torch.zeros((4, 3), dtype=torch.uint8),
                              np.zeros((129, 3), np.uint8))
    with pytest.raises(ValueError, match="RGB"):
        rgb_to_train_ids_cuda(torch.zeros((4, 4), dtype=torch.uint8))


def test_cpu_path_launches_nothing():
    before = rgb_to_train_ids_cuda.launches
    rgb_to_train_ids_cuda(torch.zeros((2, 4, 4, 3), dtype=torch.uint8))
    assert rgb_to_train_ids_cuda.launches == before


def _kernel_lookup(table: HashTable, rgb: np.ndarray,
                   default_id: int) -> np.ndarray:
    """``csrc/remap.cu``'s lookup in numpy, in uint32 as the kernel does
    it: the multiplicative hash, ``probes`` slot reads, and per read a
    compare of ``slot & 0x80FFFFFF`` with the key and a select of the id in
    bits 24-30."""
    px = rgb.astype(np.uint32)
    key = px[..., 0] << 16 | px[..., 1] << 8 | px[..., 2]
    home = (key * np.uint32(table.multiplier)) >> np.uint32(32 - table.bits)
    ids = np.full(key.shape, default_id, np.int32)
    for j in range(table.probes):
        word = table.slots[(home + np.uint32(j)) & np.uint32(
            (1 << table.bits) - 1)]
        ids = np.where((word & np.uint32(0x80FFFFFF)) == key,
                       (word >> np.uint32(24)).astype(np.int32), ids)
    return ids


@pytest.mark.parametrize("default_id", DEFAULT_IDS)
@pytest.mark.parametrize("name", EDGE_TABLES)
def test_hash_lookup_equals_plain_remap(name, default_id):
    table = EDGE_TABLES[name]
    rgb = edge_pixels(table)
    want = rgb_to_train_ids(torch.from_numpy(rgb), table, default_id).numpy()
    got = _kernel_lookup(remap_table(table), rgb, default_id)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        rgb_to_train_ids_cuda(torch.from_numpy(rgb), table,
                              default_id).numpy(), want)
    assert (want == default_id).any() and (want != default_id).any()


def test_hash_lookup_equals_pallas_on_the_gta5_table():
    rgb = edge_pixels(None, seed=1).reshape(1, -1, 3)
    want = np.asarray(rgb_to_train_ids_pallas(jnp.asarray(rgb),
                                              interpret=True))
    np.testing.assert_array_equal(_kernel_lookup(remap_table(), rgb, 255),
                                  want)


def test_gta5_table_hashes_perfectly_into_32_slots():
    """One probe, one slot per shared-memory bank; the seeded search gives
    the same table each time it runs."""
    table = remap_table()
    assert (table.bits, table.probes) == (5, 1)
    assert table.multiplier % 2 == 1 and table.slots.dtype == np.uint32
    assert int((table.slots != EMPTY).sum()) == 19
    again = build_hash_table(pack_keys(class_colors_for_remap()))
    assert again.multiplier == table.multiplier
    np.testing.assert_array_equal(again.slots, table.slots)


@pytest.mark.parametrize("name", ["random33", "random128", "duplicates"])
def test_larger_tables_take_a_short_fixed_probe_count(name):
    """A pixel's work does not grow with the keys: 128 keys take 2 probes
    in at most 512 slots; the duplicated rows take no slot."""
    table = EDGE_TABLES[name]
    hashed = remap_table(table)
    assert hashed.bits <= MAX_BITS and hashed.probes <= 2
    assert int((hashed.slots != EMPTY).sum()) == len(
        np.unique(pack_keys(table)))


def test_remap_table_is_cached_per_table():
    table = EDGE_TABLES["duplicates"]
    assert remap_table(table) is remap_table(table.copy())
    assert remap_table() is remap_table(None)
    assert remap_table(table) is not remap_table(table.astype(np.int64))


def test_a_table_no_pixel_can_match_leaves_every_slot_empty():
    table = remap_table([[256, 0, 0], [-1, 0, 0]])
    assert (table.slots == EMPTY).all()
    rgb = np.array([[0, 0, 0], [255, 255, 255], [0, 0, 255]], np.uint8)
    assert _kernel_lookup(table, rgb, -3).tolist() == [-3, -3, -3]
