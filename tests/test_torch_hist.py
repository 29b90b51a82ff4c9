"""The port's confusion matrix against the JAX package's: the plain
PyTorch ``fast_hist`` against the Pallas kernel (interpret mode) and the
jnp ``bincount`` version, exactly.  The CUDA kernel is held against the
plain version on the card by test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsds_tpu.ops.pallas.hist import fast_hist_pallas
from rtsds_tpu.utils.metrics import fast_hist as jax_fast_hist
from rtsds_tpu_torch.ops.cuda.hist import fast_hist_cuda
from rtsds_tpu_torch.utils.metrics import fast_hist

# (labels, preds, num_classes) makers; preds stay in [0, n) so that the
# jnp bincount version (which masks labels only) agrees too
CASES = {
    "invalid_labels": lambda r: (r.integers(0, 25, (2, 37, 53)),
                                 r.integers(0, 19, (2, 37, 53)), 19),
    "exact_tile_multiple": lambda r: (r.integers(0, 19, (2 * 2048,)),
                                      r.integers(0, 19, (2 * 2048,)), 19),
    "all_ignored": lambda r: (np.full((100,), 255),
                              r.integers(0, 19, (100,)), 19),
    "uint8": lambda r: (np.where(r.random((3, 41, 29)) < 0.1, 255,
                                 r.integers(0, 19, (3, 41, 29))
                                 ).astype(np.uint8),
                        r.integers(0, 19, (3, 41, 29)).astype(np.uint8), 19),
    "n128": lambda r: (r.integers(-3, 140, (3000,)),
                       r.integers(0, 128, (3000,)), 128),
}


def _pallas(labels, preds, n):
    return np.asarray(fast_hist_pallas(jnp.asarray(labels),
                                       jnp.asarray(preds), num_classes=n,
                                       interpret=True))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_hist_equals_pallas_and_jnp(case, rng):
    labels, preds, n = CASES[case](rng)
    got = fast_hist(torch.from_numpy(labels), torch.from_numpy(preds), n)
    assert got.dtype == torch.int32 and got.shape == (n, n)
    np.testing.assert_array_equal(got.numpy(), _pallas(labels, preds, n))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_fast_hist(labels, preds, n)))


def test_out_of_range_preds_follow_the_pallas_kernel(rng):
    """Out-of-range predictions drop out, as in the TPU kernel (the jnp
    bincount version would alias them into other cells)."""
    labels = rng.integers(0, 19, (5000,))
    preds = rng.integers(-4, 130, (5000,))
    got = fast_hist(torch.from_numpy(labels), torch.from_numpy(preds), 19)
    np.testing.assert_array_equal(got.numpy(), _pallas(labels, preds, 19))
    assert int(got.sum()) == int(((preds >= 0) & (preds < 19)).sum())


def test_cuda_wrapper_takes_the_plain_path_on_cpu(rng):
    labels = torch.from_numpy(rng.integers(0, 25, (4, 16, 16)))
    preds = torch.from_numpy(rng.integers(0, 19, (4, 16, 16)))
    before = fast_hist_cuda.launches
    got = fast_hist_cuda(labels, preds, 19)
    assert fast_hist_cuda.launches == before
    assert torch.equal(got, fast_hist(labels, preds, 19))
    assert torch.equal(fast_hist_cuda(labels[:0], preds[:0], 19),
                       torch.zeros((19, 19), dtype=torch.int32))


def test_cuda_wrapper_rejects_bad_input():
    ids = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="num_classes"):
        fast_hist_cuda(ids, ids, 129)
    with pytest.raises(ValueError, match="shape"):
        fast_hist_cuda(ids, ids[:4], 19)
    with pytest.raises(TypeError, match="integer"):
        fast_hist_cuda(ids.float(), ids, 19)


ID_PAIRS = [(torch.int32, torch.int32), (torch.int32, torch.int64),
            (torch.uint8, torch.int64), (torch.int64, torch.int64)]


def _ids(rng, n, dtype, classes):
    """Ids in [0, classes) with negatives, ids >= classes and, for int64,
    ids of 2^32 and above (2^32 + k would wrap to k in 32 bits)."""
    if dtype == torch.uint8:
        ids = rng.integers(0, 256, n)
        ids[:classes] = np.arange(classes)
        return torch.from_numpy(ids).to(dtype)
    ids = rng.integers(-3, classes + 5, n)
    if dtype == torch.int64:
        wide = rng.random(n) < 0.2
        ids[wide] = 2 ** 32 + rng.integers(0, classes, int(wide.sum()))
        ids[:3] = [2 ** 32, -(2 ** 32) + 1, 2 ** 33 + 5]
    return torch.from_numpy(ids).to(dtype)


@pytest.mark.parametrize("label_dtype,pred_dtype", ID_PAIRS)
def test_plain_hist_drops_out_of_range_ids_of_each_dtype(rng, label_dtype,
                                                         pred_dtype):
    """The rule K1 holds to for each pair of id dtypes the main paths pass:
    an id counts only in [0, n), compared in its own width, so negative ids
    and int64 ids of 2^32 and above never wrap into range."""
    n = 19
    labels = _ids(rng, 5000, label_dtype, n)
    preds = _ids(rng, 5000, pred_dtype, n)
    got = fast_hist(labels, preds, n)
    lab, pre = labels.long().numpy(), preds.long().numpy()
    keep = (lab >= 0) & (lab < n) & (pre >= 0) & (pre < n)
    want = np.zeros((n, n), np.int64)
    np.add.at(want, (lab[keep], pre[keep]), 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < int(got.sum()) < 5000
    assert torch.equal(fast_hist_cuda(labels, preds, n), got)
