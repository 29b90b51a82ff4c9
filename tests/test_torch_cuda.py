"""Card-only tests of the port; each skips where there is no CUDA device.

This file imports nothing of JAX, so it also runs on a machine with a card
and no JAX installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Its remap edge cases (``EDGE_TABLES``, ``DEFAULT_IDS``, ``edge_pixels``)
also drive the CPU tests of the kernel's hash table in
``test_torch_remap.py``.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from rtsds_tpu_torch import cli
from rtsds_tpu_torch.bench.da_bench import da_step_benchmark
from rtsds_tpu_torch.config import load_config
from rtsds_tpu_torch.data.synthetic import SyntheticSegDataset
from rtsds_tpu_torch.eval.validate import validate
from rtsds_tpu_torch.ops.cuda.hist import fast_hist_cuda
from rtsds_tpu_torch.ops.cuda.remap import rgb_to_train_ids_cuda
from rtsds_tpu_torch.ops.preprocess import normalize
from rtsds_tpu_torch.ops.remap import rgb_to_train_ids
from rtsds_tpu_torch.serve import Predictor
from rtsds_tpu_torch.train.factory import make_bisenet
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.state import TrainState
from rtsds_tpu_torch.train.supervised import make_train_step
from rtsds_tpu_torch.utils.colors import class_colors_for_remap
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


def _rgb(rng, shape, table, unmatched=0.1):
    rgb = table[rng.integers(0, len(table), shape)]
    off = rng.random(shape) < unmatched
    rgb[off] = rng.integers(0, 256, (int(off.sum()), 3))
    return torch.from_numpy(rgb.astype(np.uint8))


DUP_TABLE = np.random.default_rng(1).integers(0, 256, (128, 3)).astype(
    np.uint8)
DUP_TABLE[77] = DUP_TABLE[5]  # the first of two equal keys wins


def _random_table(seed: int, rows: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (rows, 3)).astype(
        np.uint8)


def _duplicates() -> np.ndarray:
    table = _random_table(3, 40)
    table[[9, 21, 39]] = table[[2, 2, 30]]  # the first of equal keys wins
    return table


def _out_of_range_rows() -> np.ndarray:
    """Rows with a channel outside [0, 255] match no uint8 pixel; (0, 0,
    256) packs like (0, 1, 0), a valid row further down."""
    table = _random_table(4, 12).astype(np.int64)
    table[[0, 3, 7, 8]] = [[256, 0, 0], [-1, 5, 5], [0, 0, 256], [0, 1, 0]]
    return table


def _black_and_white() -> np.ndarray:
    table = _random_table(5, 10)
    table[4], table[6] = (0, 0, 0), (255, 255, 255)
    return table


EDGE_TABLES = {
    "gta5": None,  # the 19 GTA5 keys; neither black nor white
    "random33": _random_table(1, 33),
    "random128": _random_table(2, 128),
    "duplicates": _duplicates(),
    "out_of_range_rows": _out_of_range_rows(),
    "black_and_white": _black_and_white(),
}
DEFAULT_IDS = (0, 255, 7, -1)  # void 0 ('road'), 255, a class id, negative


def edge_pixels(table, seed: int = 0, n_random: int = 2000) -> np.ndarray:
    """(N, 3) uint8, shuffled: every valid key colour of ``table`` (None:
    the GTA5 keys), each with one channel moved by +-1, black, white and
    ``n_random`` random colours."""
    rng = np.random.default_rng(seed)
    keys = np.asarray(class_colors_for_remap() if table is None else table,
                      np.int64)
    valid = keys[((keys >= 0) & (keys <= 255)).all(axis=1)]
    near = [valid]
    for channel in range(3):
        for step in (-1, 1):
            moved = valid.copy()
            moved[:, channel] = (moved[:, channel] + step) % 256
            near.append(moved)
    pixels = np.concatenate([*near, [[0, 0, 0], [255, 255, 255]],
                             rng.integers(0, 256, (n_random, 3))])
    return rng.permutation(pixels).astype(np.uint8)


@pytest.mark.parametrize("shape,table,default_id", [
    ((2, 37, 53), None, 255),
    ((4097,), None, 0),          # one whole 4096-pixel tile and one pixel
    ((3,), None, 255),           # a partial tile alone
    ((1000,), DUP_TABLE, 255),
    ((1,), None, 255),
    ((15,), None, 255),
    ((16,), None, 255),
    ((17,), None, 255),
    ((4095,), None, 255),
    ((4096,), None, 255),
    ((3, 4096 + 5), DUP_TABLE, -1),
    ((8, 720, 1280), None, 255),  # the training batch: 1800 whole tiles
])
def test_remap_kernel_equals_plain(cuda, shape, table, default_id):
    keys = class_colors_for_remap() if table is None else table
    rgb = _rgb(np.random.default_rng(0), shape, keys).to(cuda)
    before = rgb_to_train_ids_cuda.launches
    got = rgb_to_train_ids_cuda(rgb, table, default_id)
    torch.cuda.synchronize()
    assert rgb_to_train_ids_cuda.launches == before + 1
    assert got.is_cuda and got.dtype == torch.int32
    assert torch.equal(got, rgb_to_train_ids(rgb, table, default_id))


@pytest.mark.parametrize("default_id", DEFAULT_IDS)
@pytest.mark.parametrize("name", EDGE_TABLES)
def test_remap_kernel_on_edge_tables(cuda, name, default_id):
    """Duplicated keys, rows no pixel matches, black and white in the
    table or only in the pixels, 33 and 128 keys; 3 whole tiles and a
    partial one."""
    table = EDGE_TABLES[name]
    rgb = torch.from_numpy(edge_pixels(table, n_random=3 * 4096)).to(cuda)
    before = rgb_to_train_ids_cuda.launches
    got = rgb_to_train_ids_cuda(rgb, table, default_id)
    torch.cuda.synchronize()
    assert rgb_to_train_ids_cuda.launches == before + 1
    assert torch.equal(got, rgb_to_train_ids(rgb, table, default_id))


def test_remap_kernel_on_views_and_refusals(cuda):
    rgb = _rgb(np.random.default_rng(2), (2, 64, 96),
               class_colors_for_remap()).to(cuda)
    flat = rgb.reshape(-1)
    aligned4 = flat[4:4 + 3 * 5000].view(5000, 3)  # 4- but not 16-byte
    assert aligned4.data_ptr() % 4 == 0 and aligned4.data_ptr() % 16
    for view in (rgb[:, ::2, 1::3], rgb.reshape(-1, 3)[1:], aligned4):
        before = rgb_to_train_ids_cuda.launches
        assert torch.equal(rgb_to_train_ids_cuda(view),
                           rgb_to_train_ids(view))
        assert rgb_to_train_ids_cuda.launches == before + 1
    empty = rgb_to_train_ids_cuda(rgb[:, :0])
    assert empty.shape == (2, 0, 96)
    with pytest.raises(TypeError, match="uint8"):
        rgb_to_train_ids_cuda(rgb.to(torch.int32))


@contextlib.contextmanager
def _relu_routing(masks, replay=False):
    """``F.relu`` records which inputs it passes; with ``replay`` it passes
    the ones ``masks`` recorded, so a step takes another run's routing."""
    relu = F.relu
    recorded = iter(list(masks)) if replay else None

    def routed(x, inplace=False):
        if recorded is None:
            masks.append((x.detach() > 0).cpu())
            return relu(x, inplace)
        return x * next(recorded).to(x.device, x.dtype)

    F.relu = routed
    try:
        yield
    finally:
        F.relu = relu


@pytest.mark.parametrize("dtype,batch", [(torch.float64, 2),
                                         (torch.float32, 4)])
def test_train_step_on_the_card_matches_the_cpu(cuda, dtype, batch):
    """One SGD step at 64x128, TF32 off, the CPU on the card's ReLU routing:
    a ReLU input within rounding of zero may round to either side, and one
    such flip moves some float32 updates by tens of times the limit; at two
    frames float32 rounding alone can pass it (PERF.md)."""
    ds = SyntheticSegDataset(batch, (64, 128), seed=3, fixed_tints=True)
    images = normalize(torch.from_numpy(np.stack([ds[i][0]
                                                  for i in range(batch)])))
    images = images.to(dtype)
    labels = torch.from_numpy(np.stack([ds[i][1] for i in range(batch)]))
    labels[:, :3] = 19
    cfg = load_config().model["bisenet"]
    states = []
    for dev in (cuda, "cpu"):
        model = make_bisenet(cfg, seed=0).to(dev, dtype)
        states.append(TrainState(model, make_optimizer(
            "SGD", model.parameters(), 0.01, momentum=0.9)))
    before = {k: v.detach().clone()
              for k, v in states[1].model.named_parameters()}
    step = make_train_step(19)
    masks = []
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        with _relu_routing(masks):
            loss_gpu = float(step(states[0], images.to(cuda),
                                  labels.to(cuda))["train_loss"])
        with _relu_routing(masks, replay=True):
            loss_cpu = float(step(states[1], images, labels)["train_loss"])
    assert abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu)
    gpu_state = states[0].model.state_dict()
    for k, want in states[1].model.state_dict().items():
        if "running_" in k:
            torch.testing.assert_close(gpu_state[k].cpu(), want, rtol=1e-4,
                                       atol=1e-5, msg=k)
    gpu = dict(states[0].model.named_parameters())
    for k, p in states[1].model.named_parameters():
        want = p.detach() - before[k]
        got = gpu[k].detach().cpu() - before[k]
        limit = 1e-3 * float(want.abs().max()) + 1e-6
        assert float((got - want).abs().max()) <= limit, k


@pytest.mark.parametrize("variant,grl_alpha", [("v1", 0.0), ("v1", 0.1),
                                               ("v2", 0.0)])
def test_da_step_on_the_card_matches_the_cpu(cuda, variant, grl_alpha):
    """One float64 SGD step of the adversarial trainer (BiSeNet-R18 and the
    Tiny discriminator, b2, source 64x96, target 64x128), as chip_smoke.py
    checks it: every loss within 1e-4 relative, G's BN running statistics
    rtol 1e-4 / atol 1e-5, each update of G and D within 1e-3 of its
    tensor's largest update + 1e-6 (the check raises otherwise)."""
    result = chip_smoke.da_step_card_vs_cpu(variant, grl_alpha)
    assert result["tensors_over_limit"] == 0


def test_da_bench_on_the_card(cuda):
    out = da_step_benchmark(batch_size=2, src_hw=(64, 96), tgt_hw=(64, 128),
                            steps=2, repeats=2)
    assert out["ms_per_step"] > 0 and len(out["ms_per_step_all"]) == 2
    assert np.isfinite(out["last_loss_gen_source"])
    assert set(out["split_ms"]) == {"generator", "discriminator"}
    assert out["device"] == torch.cuda.get_device_name(0)


def test_da_cli_launches_both_kernels_on_the_card(cuda, tmp_path):
    """``--domain_adaptation`` on the card with colour-coded labels: the
    source transform launches K2 once per step, the validation K1."""
    path = tmp_path / "config.yaml"
    path.write_text(f"""
device: cuda
data:
  cityscapes: {{image_size: "32, 64", batch_size: 2, num_workers: 1}}
  gta5_modified: {{image_size: "40, 72", batch_size: 2, num_workers: 1,
                  decode_label_colors: true}}
training:
  domain_adaptation: {{epochs: 1, iterations: 3, do_validation: 1}}
callbacks:
  model_checkpoint: {{save_dir: "{tmp_path}/ckpt", save_name: "m"}}
  images_plots: null
""")
    k1, k2 = fast_hist_cuda.launches, rgb_to_train_ids_cuda.launches
    history = cli.main(["--config", str(path), "--synthetic",
                        "--domain_adaptation", "--augmented"])
    assert len(history) == 1 and 0.0 <= history[0]["validation_mIoU"] <= 1.0
    assert rgb_to_train_ids_cuda.launches - k2 == 3
    assert fast_hist_cuda.launches - k1 >= 1
    assert (tmp_path / "ckpt" / "m_da" / "epoch_0.pt").exists()
