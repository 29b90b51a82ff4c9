"""The spatial axis in training (``parallel/spatial.py`` bands of rows on
several CPU "devices", ``mesh: {spatial: S}``), against one device and
against the JAX package, in float64.

* One supervised SGD step (momentum 0.9) of BiSeNet-R18 at b2 64x128
  (test_torch_train.py's batch, a band of void rows) on 2 and 4 bands (on
  4, two bands hold no row of the 1/32 map): the loss, the BN running
  statistics and every parameter at rtol 1e-9 / atol 1e-12 of one
  device's step, and against JAX's one-device step at
  test_torch_train.py's limits (the loss rtol 1e-4, each update within
  1e-3 of its largest update plus 1e-6, the BN statistics rtol 1e-4).
* One step of a thin DeepLabV2 ([1, 1, 1, 1], BN affines frozen) at b4
  32x64 (test_torch_parallel.py's half-void batch) on 2 and 4 bands:
  against one device at rtol 1e-9 / atol 1e-12 and against JAX's step at
  rtol 1e-6 / atol 1e-10 (test_torch_parallel.py's limits).
* DA v1 on bands: test_torch_spatial_da.py.
* Validation on 2 bands: the bands' K1 matrices (the kernel's plain
  version here) summed on the first device equal one device's matrix
  exactly on the same predictions, and ``validate`` reports one device's
  mIoU.
* The CLI with ``mesh: {spatial: 2}`` and ``RTSDS_CPU_DEVICES=2``: 1 x 2
  steps of BiSeNet-R18 on colour-coded labels (K2's plain version in the
  transform before banding), a validation and a checkpoint.
"""

import numpy as np
import pytest
import torch

from rtsds_tpu_torch import cli
from rtsds_tpu_torch.eval.validate import make_eval_step, validate
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2, frozen_bn_parameters
from rtsds_tpu_torch.ops.cuda.hist import fast_hist_cuda
from rtsds_tpu_torch.parallel.spatial import (
    Bands, banded_hist, split_batch, split_rows)
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.state import TrainState
from rtsds_tpu_torch.train.supervised import make_train_step
from test_torch_train import (  # noqa: F401 -- jax_step is a fixture
    LR, _leaves, _param_key, _port_model, _stat_key, _to_torch_layout,
    jax_step)

SAME = dict(rtol=1e-9, atol=1e-12)
JAX = dict(rtol=1e-6, atol=1e-10)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _numpy(model) -> dict:
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def _close(got: dict, want: dict, what: str, **tol):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   err_msg=f"{what} {k}", **tol)


def _sgd(model, momentum=0.9, lr=LR, frozen=()):
    return TrainState(model, make_optimizer("SGD", model.parameters(), lr,
                                            momentum=momentum,
                                            frozen=frozen))


def _step(model, images, labels, bands: int, **opt) -> tuple:
    """One supervised step on one device (``bands`` 0) or on bands; the
    metrics and the state after."""
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    if bands:
        x, y = split_batch(x, y, ["cpu"] * bands)
    metrics = make_train_step(19)(_sgd(model, **opt), x, y)
    return ({k: float(v) for k, v in metrics.items()}, _numpy(model))


# --- BiSeNet-R18 ----------------------------------------------------------

@pytest.fixture(scope="module")
def bisenet_runs(jax_step):
    before, images, labels = jax_step[:3]
    return {n: _step(_port_model(before), images, labels, n)
            for n in (0, 2, 4)}


@pytest.mark.parametrize("bands", [2, 4])
def test_bisenet_step_on_bands_equals_one_device(bisenet_runs, bands):
    got, want = bisenet_runs[bands], bisenet_runs[0]
    assert got[0]["correct"] == want[0]["correct"]
    assert got[0]["total"] == want[0]["total"]
    np.testing.assert_allclose(got[0]["train_loss"], want[0]["train_loss"],
                               rtol=1e-9)
    _close(got[1], want[1], f"{bands} bands", **SAME)


@pytest.mark.parametrize("bands", [2, 4])
def test_bisenet_step_on_bands_matches_jax(bisenet_runs, jax_step, bands):
    before, _, labels, metrics, after, _ = jax_step
    got, new = bisenet_runs[bands]
    np.testing.assert_allclose(got["train_loss"],
                               float(metrics["train_loss"]), rtol=1e-4)
    assert got["total"] == int(metrics["total"]) == labels.size
    params_before = dict(_leaves(before["params"]))
    for path, want_after in _leaves(after["params"]):
        key = _param_key(path, want_after)
        want = _to_torch_layout(want_after - params_before[path])
        upd = new[key] - _to_torch_layout(params_before[path])
        assert np.abs(upd - want).max() <= \
            1e-3 * np.abs(want).max() + 1e-6, key
    for path, want in _leaves(after["batch_stats"]):
        np.testing.assert_allclose(new[_stat_key(path)], want, rtol=1e-4,
                                   err_msg=_stat_key(path))


# --- thin DeepLabV2 -------------------------------------------------------

@pytest.fixture(scope="module")
def deeplab():
    """JAX's step (test_torch_parallel.py's) and the port's on 0, 2 and 4
    bands of its half-void batch 4 at 32x64."""
    import test_torch_parallel as tp
    from test_torch_deeplab import flax_tree

    trees = {"deeplab": tp._f64(flax_tree(tp.THIN, (1, *tp.SIZE, 3),
                                          seed=7))}
    images, labels = tp._void_batch()
    state = tp._numpy_sd(trees["deeplab"])

    def model():
        m = DeepLabV2(layers=tp.THIN).double()
        m.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        return m

    runs = {}
    for n in (0, 2, 4):
        m = model()
        runs[n] = _step(m, images, labels, n,
                        frozen=frozen_bn_parameters(m))
    return runs, tp._jax_step(trees, "deeplab", 1)


@pytest.mark.parametrize("bands", [2, 4])
def test_deeplab_step_on_bands_equals_one_device_and_jax(deeplab, bands):
    runs, (want_metrics, want) = deeplab
    got, one = runs[bands], runs[0]
    assert got[0]["correct"] == one[0]["correct"] == want_metrics["correct"]
    np.testing.assert_allclose(got[0]["train_loss"], one[0]["train_loss"],
                               rtol=1e-9)
    _close(got[1], one[1], f"{bands} bands", **SAME)
    np.testing.assert_allclose(got[0]["train_loss"],
                               want_metrics["train_loss"], rtol=1e-6)
    _close({k: v for k, v in got[1].items()
            if not k.endswith("num_batches_tracked")}, want, "jax", **JAX)


# --- validation -----------------------------------------------------------

def test_banded_k1_sum_equals_one_device(jax_step):
    before, images, labels = jax_step[:3]
    model = _port_model(before).eval()
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    with torch.no_grad():
        preds = model(x.permute(0, 3, 1, 2)).argmax(1)
    want = fast_hist_cuda(y, preds, 19)
    frames, bands = split_batch(x, y, ["cpu"] * 2)
    banded_preds = Bands(split_rows(preds, ["cpu"] * 2), bands.starts,
                         bands.height, bands.layout)
    got = banded_hist(bands, banded_preds, 19)
    assert torch.equal(got, want)
    assert not torch.equal(fast_hist_cuda(bands.parts[0],
                                          banded_preds.parts[0], 19), want)
    # validate on banded batches: the eval step's per-band K1
    one = validate(model, [(x, y)], 19, device="cpu")[0]
    banded = validate(model, [split_batch(x, y, ["cpu"] * 2)], 19,
                      eval_step=make_eval_step(model, 19), device="cpu")[0]
    assert banded == one


# --- the CLI --------------------------------------------------------------

def test_cli_trains_on_two_bands(tmp_path, monkeypatch):
    monkeypatch.setenv("RTSDS_CPU_DEVICES", "2")
    config = tmp_path / "config.yaml"
    config.write_text(f"""
device: cpu
mesh: {{spatial: 2}}
data:
  cityscapes: {{image_size: "32, 64", batch_size: 2, num_workers: 1}}
  gta5_modified: {{image_size: "40, 72", batch_size: 2, num_workers: 1,
                  decode_label_colors: true}}
  synthetic: {{}}
training:
  segmentation: {{epochs: 1, do_validation: 1}}
callbacks:
  model_checkpoint: {{save_dir: "{tmp_path}/ckpt", save_name: "m",
                     save_best: true}}
""")
    seen = []
    build = cli.supervised_train_step

    def recording(*args, **kwargs):
        step = build(*args, **kwargs)

        def recorded(state, images, labels):
            seen.append(type(images).__name__)
            return step(state, images, labels)
        return recorded

    monkeypatch.setattr(cli, "supervised_train_step", recording)
    history = cli.main(["--config", str(config), "--synthetic",
                        "--dataset", "gta5"])
    assert len(history) == 1 and np.isfinite(history[0]["train_loss"])
    assert 0.0 <= history[0]["validation_mIoU"] <= 1.0
    assert seen and set(seen) == {"FrameBands"}
    assert (tmp_path / "ckpt" / "m" / "epoch_0.pt").exists()


@pytest.mark.parametrize("protocol", [
    "sliding: {enabled: true, window: '16, 32'}",
    "ensemble: {enabled: true}"], ids=["sliding", "ensemble"])
def test_cli_protocol_on_bands_reports_one_devices_miou(tmp_path,
                                                        monkeypatch,
                                                        protocol):
    """A validation protocol in spatial training (``mesh: {spatial: 2}``,
    one process): the run validates on the bands; ``--validate_only`` on
    its checkpoint reports the run's mIoU, and one device's on the same
    checkpoint (the mesh dropped) to 1e-12; ``--resume`` of a longer
    config trains the next epoch on the bands."""
    from test_torch_mesh_nd import _with, one_iteration

    monkeypatch.setenv("RTSDS_CPU_DEVICES", "2")
    config = one_iteration(_with(tmp_path, "mesh: {spatial: 2}",
                                 extra=f"validation: {{{protocol}}}"))
    flags = ["--config", config, "--synthetic"]
    history = cli.main(flags)
    banded = cli.main(flags + ["--validate_only"])
    assert banded == pytest.approx(history[0]["validation_mIoU"], abs=1e-12)
    one_device = tmp_path / "one_device.yaml"
    one_device.write_text((tmp_path / "config.yaml").read_text().replace(
        "mesh: {spatial: 2}", ""))
    miou = cli.main(["--config", str(one_device), "--synthetic",
                     "--validate_only"])
    assert miou == pytest.approx(banded, abs=1e-12)
    longer = tmp_path / "longer.yaml"
    longer.write_text((tmp_path / "config.yaml").read_text().replace(
        "epochs: 1,", "epochs: 2,"))
    resumed = cli.main(["--config", str(longer), "--synthetic", "--resume"])
    assert [h["epoch"] for h in resumed] == [1]
