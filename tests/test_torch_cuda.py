"""Card-only tests of the port; each skips where there is no CUDA device.

This file imports nothing of JAX, so it also runs on a machine with a card
and no JAX installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Its remap edge cases (``EDGE_TABLES``, ``DEFAULT_IDS``, ``edge_pixels``)
also drive the CPU tests of the kernel's hash table in
``test_torch_remap.py``, and its ``trained_checkpoint`` the CPU tests of
serving in ``test_torch_serve_checkpoint.py``.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from rtsds_tpu_torch import cli
from rtsds_tpu_torch.bench.da_bench import da_step_benchmark
from rtsds_tpu_torch.bench.train_bench import supervised_step_benchmark
from rtsds_tpu_torch.config import load_config
from rtsds_tpu_torch.data.synthetic import SyntheticSegDataset
from rtsds_tpu_torch.eval.ensemble import make_ensemble_predict
from rtsds_tpu_torch.eval.sliding import make_sliding_predict
from rtsds_tpu_torch.eval.validate import validate
from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2
from rtsds_tpu_torch.models.pretrained import load_flax_variables
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


@pytest.mark.parametrize("label_dtype,pred_dtype", chip_smoke.ID_DTYPE_PAIRS)
def test_hist_kernel_reads_each_id_dtype_as_it_is(cuda, label_dtype,
                                                  pred_dtype):
    """Each pair of id dtypes the main paths pass goes to the kernel
    uncast, and the kernel drops negative ids, ids >= n and int64 ids of
    2^32 and above as the plain version does."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    labels = chip_smoke.out_of_range_ids(gen, 300_001, label_dtype)
    preds = chip_smoke.out_of_range_ids(gen, 300_001, pred_dtype)
    casts = []
    to = torch.Tensor.to

    def spy(self, *args, **kwargs):
        casts.append(args)
        return to(self, *args, **kwargs)

    torch.Tensor.to = spy
    try:
        got = fast_hist_cuda(labels, preds, 19)
    finally:
        torch.Tensor.to = to
    torch.cuda.synchronize()
    assert casts == []
    want = fast_hist(labels, preds, 19)
    assert torch.equal(got, want) and int(want.sum()) > 0


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


@pytest.mark.parametrize("kwargs", [
    {"variant": "v1", "lambda_ent": 0.005, "fda_beta": 0.05},
    {"variant": "v2", "lambda_ent": 0.005, "fda_beta": 0.05},
    {"self_training": True}])
def test_da_extras_on_the_card_match_the_cpu(cuda, kwargs):
    """MinEnt and FDA in v1 and v2, and the self-training step (ClassMix on
    CPU-drawn scores, its EMA compared too), one float64 step each, held
    as chip_smoke.py holds them (the check raises otherwise)."""
    result = chip_smoke.da_step_card_vs_cpu(**kwargs)
    assert result["tensors_over_limit"] == 0


def test_accumulated_step_on_the_card_matches_the_cpu(cuda):
    """One float64 K = 2 step at batch 4 (micro-batches of 2), within the
    supervised step's limits (the check raises otherwise)."""
    result = chip_smoke.step_card_vs_cpu(torch.float64, 4,
                                         accumulate_steps=2)
    assert result["tensors_over_limit"] == 0


def test_distill_step_on_the_card_matches_the_cpu(cuda):
    result = chip_smoke.distill_step_card_vs_cpu()
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


@pytest.fixture(scope="module")
def deeplab_tree():
    """chip_smoke.py's seeded DeepLabV2-R101 tree, BN statistics
    calibrated on the CPU; made only where there is a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frames = np.stack([SyntheticSegDataset(2, (64, 128), seed=5)[i][0]
                       for i in range(2)])
    return chip_smoke.calibrate_batch_stats(
        chip_smoke.random_flax_deeplab(0), frames, "cpu", DeepLabV2)


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_deeplab_forward_on_the_card_matches_the_cpu(cuda, deeplab_tree):
    """DeepLabV2-R101 eval logits at 65x97 (the ceil-mode pool's partial
    windows), f32 with TF32 off: within 1e-3 of the CPU's largest logit."""
    model = load_flax_variables(DeepLabV2(), deeplab_tree).eval()
    x = torch.randn((2, 3, 65, 97), generator=torch.Generator().manual_seed(0))
    with torch.no_grad(), _no_tf32():
        want = model(x)
        got = model.to(cuda)(x.to(cuda)).cpu()
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


@pytest.mark.parametrize("protocol", ["sliding", "ensemble"])
def test_protocol_on_the_card_matches_the_cpu(cuda, deeplab_tree, protocol):
    """Each protocol's probabilities at 64x128 (sliding: 32x64 windows;
    ensemble: scales 0.75/1/1.25 with flip), f32 with TF32 off, within
    1e-4 of the CPU's."""
    model = load_flax_variables(DeepLabV2(), deeplab_tree).eval()
    x = torch.randn((2, 3, 64, 128), generator=torch.Generator().manual_seed(1))
    probs = {}
    with torch.no_grad(), _no_tf32():
        for dev in ("cpu", cuda):
            model.to(dev)
            if protocol == "sliding":
                predict = make_sliding_predict(model, (64, 128), (32, 64),
                                               return_probs=True)
            else:
                predict = make_ensemble_predict(model, (64, 128),
                                                return_probs=True)
            probs[str(dev)] = predict(x.to(dev)).cpu()
    torch.testing.assert_close(probs["cuda"], probs["cpu"], rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("protocol,kwargs", [
    ("plain", {}), ("sliding", {"window": (32, 64)}),
    ("ensemble", {"scales": (0.75, 1.0, 1.25)})])
def test_deeplab_predictor_on_the_card(cuda, deeplab_tree, protocol, kwargs):
    frames = np.stack([SyntheticSegDataset(3, (64, 128), seed=6)[i][0]
                       for i in range(3)])
    masks = Predictor(model_name="deeplab", variables=deeplab_tree,
                      image_size=(64, 128), batch_size=2, protocol=protocol,
                      protocol_kwargs=kwargs).predict(frames)
    assert masks.shape == (3, 64, 128) and masks.dtype == np.int32
    assert masks.min() >= 0 and masks.max() < 19


def test_deeplab_train_bench_on_the_card(cuda):
    out = supervised_step_benchmark("deeplab", batch_size=1,
                                    image_size=(64, 96), steps=2, repeats=2,
                                    remat=True)
    assert out["ms_per_step"] > 0 and np.isfinite(out["last_train_loss"])
    assert out["max_memory_gb"] > 0 and out["remat"]


def trained_checkpoint(directory) -> str:
    """A port checkpoint of a seeded BiSeNet-R18 whose BN statistics are
    moved off the identity, with an ``ema`` item of other weights."""
    from rtsds_tpu_torch.callbacks.checkpoint import CheckpointManager
    from rtsds_tpu_torch.models.bisenet import BiSeNet
    from rtsds_tpu_torch.train.ema import EMA, ema_init

    gen = torch.Generator().manual_seed(4)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(4)
        model = BiSeNet()
    # BN statistics of real frames (random ones blow the logits up), as
    # chip_smoke.calibrate_batch_stats sets them
    frames = np.stack([SyntheticSegDataset(4, (64, 128), seed=5)[i][0]
                       for i in range(4)])
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None
    with torch.no_grad():
        model.train()(normalize(torch.from_numpy(frames)).permute(0, 3, 1, 2))
    for m, momentum in zip(bns, momenta):
        m.momentum = momentum
    ema = {k: v + 0.01 * torch.randn(v.shape, generator=gen)
           for k, v in ema_init(model).items()}
    CheckpointManager(str(directory)).save(0, {
        "model": TrainState(model, make_optimizer(
            "SGD", model.parameters(), 0.01)), "ema": EMA(ema)},
        monitor=0.5)
    return str(directory)


def test_from_checkpoint_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The served checkpoint's float32 logits on the card, TF32 off, within
    1e-3 of the CPU's largest logit (chip_smoke.py's serving limit), and
    its masks the same wherever the top two logits are twice that apart."""
    path = trained_checkpoint(tmp_path / "ckpt")
    kwargs = dict(image_size=(64, 128), batch_size=2, dtype=torch.float32)
    card = Predictor.from_checkpoint(path, **kwargs)
    cpu = Predictor.from_checkpoint(path, device="cpu", **kwargs)
    x = normalize(torch.from_numpy(np.stack(
        [SyntheticSegDataset(2, (64, 128), seed=7)[i][0] for i in range(2)]
    ))).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad(), _no_tf32():
        got = card.model(x.to(cuda)).cpu()
        want = cpu.model(x)
    limit = 1e-3 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= limit
    top2 = want.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * limit
    assert clear.float().mean() > 0.9
    assert torch.equal(got.argmax(1)[clear], want.argmax(1)[clear])


def test_resize_of_an_output_past_int_max_on_the_card(cuda):
    """BiSeNet's logits at b64 1024x2048 have 2^31 elements or more, which
    ATen's channels-last bilinear kernel refuses; ``resize_bilinear`` runs
    them through the NCHW kernel, and each frame's resize is the one that
    kernel gives it alone."""
    from rtsds_tpu_torch.ops.resize import resize_bilinear

    x = torch.randn((64, 19, 128, 256), generator=torch.Generator(
        device=cuda).manual_seed(2), device=cuda, dtype=torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    out = resize_bilinear(x, (1024, 2048))
    assert out.shape == (64, 19, 1024, 2048)
    for i in (0, 63):
        alone = resize_bilinear(x[i:i + 1].contiguous(), (1024, 2048))
        assert torch.equal(out[i:i + 1], alone)


def test_predict_iter_on_the_card_equals_predict(cuda, tmp_path):
    predictor = Predictor.from_checkpoint(
        trained_checkpoint(tmp_path / "ckpt"), image_size=(64, 128),
        batch_size=4)
    ds = SyntheticSegDataset(10, (64, 128), seed=8)
    frames = np.stack([ds[i][0] for i in range(10)])
    batches = [frames[:4], frames[4:8], frames[8:], frames[0]]
    got = list(predictor.predict_iter(iter(batches)))
    assert len(got) == 4
    for g, b in zip(got, batches):
        b = b if b.ndim == 4 else b[None]
        assert g.dtype == np.int32 and g.shape == (len(b), 64, 128)
        np.testing.assert_array_equal(g, predictor.predict(b))


def test_octet_stream_server_on_the_card(cuda):
    """The HTTP server over a predictor on the card: each raw reply is
    ``predict`` of its frame, and the statistics count every request."""
    predictor = Predictor(image_size=(64, 128), batch_size=8)
    ds = SyntheticSegDataset(16, (64, 128), seed=9)
    frames = np.stack([ds[i][0] for i in range(16)])
    out = chip_smoke.serve_over_http(predictor, frames)
    assert out["replies"] == 16 and out["stats"]["errors"] == 0


def test_latency_benchmark_on_the_card_takes_100_samples(cuda):
    from rtsds_tpu_torch.bench.latency import bisenet_inference_benchmark

    out = bisenet_inference_benchmark((64, 128), batch_size=2)
    assert out["samples"] >= 100 and out["device"] != "cpu"
    assert 0 < out["p50_ms"] <= out["p99_ms"]
    assert out["fps"] > 0 and out["flops_per_image"] > 0


# int8 conv shapes, (n, cin, h, w, cout, k, stride, padding, dilation), that
# the GEMM takes as they are or padded (K = 27 or 147, N = 19, 8 rows); the
# CPU tests hold the same shapes against the JAX package's conv
CONV_SHAPES = [
    (2, 16, 9, 13, 24, 1, 1, 0, 1),    # 1x1
    (2, 16, 9, 13, 24, 1, 2, 0, 1),    # strided 1x1 (a projection)
    (2, 16, 9, 13, 32, 3, 1, 1, 1),    # 3x3
    (2, 16, 9, 13, 32, 3, 2, 1, 1),    # strided 3x3
    (2, 8, 17, 15, 16, 3, 1, 2, 2),    # dilated 3x3
    (1, 8, 21, 23, 8, 3, 1, 4, 4),     # dilation 4
    (2, 3, 17, 19, 16, 7, 2, 3, 1),    # the 3-channel 7x7 stem: K = 147
    (2, 3, 16, 16, 64, 3, 2, 1, 1),    # the 3-channel 3x3 stem: K = 27
    (2, 24, 8, 8, 19, 3, 1, 1, 1),     # 19 outputs (the FFM's)
    (8, 40, 1, 1, 40, 1, 1, 0, 1),     # a pooled gate: M = 8 rows
    (2, 12, 6, 10, 19, 3, 1, 6, 6),    # an ASPP branch
]


@pytest.mark.parametrize("shape", CONV_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_int8_conv_on_the_card_equals_float64(cuda, shape):
    """``conv_int8`` (im2col + ``torch._int_mm``) on the card, padded to
    the GEMM's rules where it must be, equals a float64 conv exactly, and
    its dequantized output equals the CPU's bit for bit."""
    from rtsds_tpu_torch.ops.quant import conv_int8, conv_w8a8

    n, cin, h, w, cout, k, stride, padding, dilation = shape
    gen = torch.Generator().manual_seed(0)
    x_q = torch.randint(-127, 128, (n, cin, h, w), generator=gen,
                        dtype=torch.int8)
    w_q = torch.randint(-127, 128, (cout, cin, k, k), generator=gen,
                        dtype=torch.int8)
    got = conv_int8(x_q.to(cuda), w_q.to(cuda), stride, padding, dilation)
    want = F.conv2d(x_q.to(cuda).double(), w_q.to(cuda).double(), None,
                    stride, padding, dilation)
    assert got.dtype == torch.int32 and torch.equal(got.double(), want)
    w_scale = torch.rand(cout, generator=gen) * 1e-2
    bias = torch.randn(cout, generator=gen)
    y = conv_w8a8(x_q.to(cuda), w_q.to(cuda), 0.0213, w_scale.to(cuda),
                  bias.to(cuda), stride, padding, dilation,
                  out_dtype=torch.float32)
    assert torch.equal(y.cpu(), conv_w8a8(x_q, w_q, 0.0213, w_scale, bias,
                                          stride, padding, dilation,
                                          out_dtype=torch.float32))


def test_int8_predictor_on_the_card_matches_the_cpu(cuda):
    """The int8 BiSeNet on the same scales: the card's Predictor holds the
    CPU's quantized tree exactly, and the float32 int8 walk (TF32 off) on
    the card gives the CPU's logits within 2e-2 of their peak and 99% of
    the argmax equal (an activation within rounding of a half step may
    take the other code)."""
    from rtsds_tpu_torch.models.bisenet_int8 import bisenet_int8_apply

    size = (64, 128)
    ds = SyntheticSegDataset(2, size, seed=5, fixed_tints=True)
    frames = np.stack([ds[i][0] for i in range(2)])
    tree = chip_smoke.calibrate_batch_stats(chip_smoke.random_flax_bisenet(3),
                                            frames)
    common = dict(variables=tree, image_size=size, batch_size=2,
                  quantize="int8")
    cpu = Predictor(calib_frames=frames, device="cpu", **common)
    card = Predictor(act_scales=cpu.act_scales, device="cuda", **common)
    for kind in ("q8", "bf16"):
        for name, entry in cpu.model.qtree[kind].items():
            for a, b in zip(card.model.qtree[kind][name], entry):
                assert (a is None and b is None) or torch.equal(a.cpu(), b)
    masks = card.predict(frames)
    assert masks.shape == (2, *size) and masks.max() < 19
    x = normalize(torch.from_numpy(frames)).permute(0, 3, 1, 2)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False), \
            torch.no_grad():
        want = bisenet_int8_apply(cpu.model.qtree, x,
                                  out_dtype=torch.float32)
        got = bisenet_int8_apply(card.model.qtree, x.to(cuda),
                                 out_dtype=torch.float32).cpu()
    peak = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2e-2 * peak
    assert (got.argmax(1) == want.argmax(1)).float().mean() >= 0.99


def test_serving_artifact_on_the_card_is_exact(cuda, tmp_path):
    """A bf16 BiSeNet artifact exported and served on the card: its masks
    equal the predictor's computation at the same batch, dynamic and
    static; an artifact of the card refuses the CPU."""
    from rtsds_tpu_torch.serve_export import export_predictor, load_predictor

    size = (64, 128)
    ds = SyntheticSegDataset(3, size, seed=6, fixed_tints=True)
    frames = np.stack([ds[i][0] for i in range(3)])
    p = Predictor(image_size=size, batch_size=3, device="cuda")
    for batch in ("dynamic", 3):
        path = export_predictor(p, str(tmp_path / f"{batch}.rtsds"),
                                batch=batch)
        art = load_predictor(path)
        np.testing.assert_array_equal(art.predict(frames),
                                      p.predict(frames))
    with pytest.raises(ValueError, match="not for 'cpu'"):
        load_predictor(path, device="cpu")


def test_jitter_and_zoom_on_the_card_match_the_cpu(cuda):
    """ColorJitter and RandomZoom on the card against the CPU on the same
    draws: images within 1e-3 on the 0..255 range, labels exact."""
    from rtsds_tpu_torch.ops.augment import (
        AugmentConfig, apply_augment, draw)

    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.uniform(0, 255, (4, 72, 128, 3))
                         .astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 19, (4, 72, 128)).astype(np.int32))
    cfg = AugmentConfig(apply_p=1.0, color_jitter=(0.4, 0.4, 0.4, 0.1),
                        zoom_max=1.8, zoom_p=0.5)
    draws = draw(cfg, torch.Generator().manual_seed(3), tuple(y.shape))
    want_x, want_y = apply_augment(cfg, draws, x, y)
    got_x, got_y = apply_augment(cfg, draws, x.to(cuda), y.to(cuda))
    torch.testing.assert_close(got_x.cpu(), want_x, rtol=1e-5, atol=1e-3)
    assert torch.equal(got_y.cpu(), want_y)


def test_convert_labels_on_the_card_equals_the_host_lut(cuda):
    from rtsds_tpu_torch.data.convert_gta5 import build_lut, convert_labels

    table = class_colors_for_remap()
    rng = np.random.default_rng(8)
    rgb = table[rng.integers(0, len(table), (2, 33, 47))].astype(np.uint8)
    rgb[:, ::5] = rng.integers(0, 256, (2, 7, 47, 3))
    packed = ((rgb[..., 0].astype(np.uint32) << 16)
              | (rgb[..., 1].astype(np.uint32) << 8) | rgb[..., 2])
    launches = rgb_to_train_ids_cuda.launches
    np.testing.assert_array_equal(convert_labels(rgb), build_lut()[packed])
    assert rgb_to_train_ids_cuda.launches == launches + 1


def test_global_batchnorm_under_gloo_on_cuda_tensors_equals_the_cpu(cuda):
    """Two ranks sharing the card under gloo (CUDA tensors; gloo runs the
    all_reduce the global-batch BN needs) against two ranks on the CPU, in
    float64: output, running statistics and gradients at rtol 1e-9 / atol
    1e-12."""
    from rtsds_tpu_torch.parallel.launch import run_ranks
    from test_torch_multihost import bn_worker

    rng = np.random.default_rng(0)
    x = rng.normal(2.0, 3.0, size=(4, 5, 6, 7))
    x[:2] += 10.0
    dy = rng.normal(size=x.shape)
    card = run_ranks(bn_worker, 2, (x, dy, "cuda"), timeout_s=120)
    cpu = run_ranks(bn_worker, 2, (x, dy, "cpu"), timeout_s=120)
    for got, want in zip(card, cpu):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-9,
                                       atol=1e-12, err_msg=k)
