"""Card-only tests of the port; each skips where there is no CUDA device.

This file imports nothing of JAX, so it also runs on a machine with a card
and no JAX installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from rtsds_tpu_torch.data.synthetic import SyntheticSegDataset
from rtsds_tpu_torch.eval.validate import validate
from rtsds_tpu_torch.ops.cuda.hist import fast_hist_cuda
from rtsds_tpu_torch.ops.preprocess import normalize
from rtsds_tpu_torch.serve import Predictor
from rtsds_tpu_torch.utils.metrics import fast_hist

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,shape,lo,hi,dtype", [
    (19, (2, 37, 53), -1, 25, torch.int32),     # void and negative labels
    (19, (2 * 2048,), 0, 19, torch.int64),
    (19, (3, 41, 29), 0, 256, torch.uint8),
    (128, (3000,), -3, 140, torch.int32),       # 64 KB of shared memory
])
def test_hist_kernel_equals_plain(cuda, n, shape, lo, hi, dtype):
    rng = np.random.default_rng(0)
    labels = torch.from_numpy(rng.integers(lo, hi, shape)).to(cuda, dtype)
    preds = torch.from_numpy(rng.integers(-2, n + 3, shape)).to(cuda)
    before = fast_hist_cuda.launches
    got = fast_hist_cuda(labels, preds, n)
    torch.cuda.synchronize()
    assert fast_hist_cuda.launches == before + 1
    assert torch.equal(got, fast_hist(labels, preds, n))


def test_hist_kernel_on_no_pixels_launches_nothing(cuda):
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    before = fast_hist_cuda.launches
    got = fast_hist_cuda(empty, empty, 19)
    assert fast_hist_cuda.launches == before
    assert got.is_cuda and int(got.abs().sum()) == 0


def test_serving_and_validation_on_the_card(cuda):
    size = (64, 128)
    ds = SyntheticSegDataset(4, size, seed=0, fixed_tints=True)
    frames = np.stack([ds[i][0] for i in range(4)])
    labels = np.stack([ds[i][1] for i in range(4)])
    predictor = Predictor(image_size=size, batch_size=2,
                          dtype=torch.float32)
    assert predictor.device.type == "cuda"
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        masks = predictor.predict(frames)
    cpu = Predictor(image_size=size, batch_size=2, dtype=torch.float32,
                    device="cpu")
    assert (masks == cpu.predict(frames)).mean() >= 0.999

    batches = [(normalize(torch.from_numpy(frames[i:i + 2])),
                torch.from_numpy(labels[i:i + 2])) for i in (0, 2)]
    before = fast_hist_cuda.launches
    miou, _ = validate(predictor.model, iter(batches), 19)
    assert fast_hist_cuda.launches == before + 2
    assert 0.0 <= miou <= 1.0
