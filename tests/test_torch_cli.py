"""The port's training CLI on the CPU, end to end at tiny sizes: synthetic
data, and GTA5-layout PNGs with colour-coded labels remapped on the
device; best-model checkpoints, ``--resume`` and ``--validate_only``, as
the JAX package's CLI does them; DeepLabV2 as the trained model and as the
DA generator, validated under the sliding and ensemble protocols; the
training extras (EMA, gradient accumulation, distillation, MinEnt, FDA,
self-training with CBST calibration and ClassMix) and the JAX CLI's
refusals of their combinations; the checkpoint and early-stopping
callbacks; and the switches not ported yet."""

import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from rtsds_tpu_torch import cli
from rtsds_tpu_torch.callbacks.checkpoint import (
    CheckpointManager, EarlyStopping, ModelCheckpoint)
from rtsds_tpu_torch.config import load_config
from rtsds_tpu_torch.train import loop
from rtsds_tpu_torch.train.ema import EMA, ema_init
from rtsds_tpu_torch.train.factory import make_segmentor
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.state import TrainState
from rtsds_tpu_torch.utils.colors import class_colors_for_remap


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Tiny shapes gain nothing from many threads, and the test workers
    share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _config(tmp_path, extra=""):
    path = tmp_path / "config.yaml"
    path.write_text(f"""
device: cpu
data:
  cityscapes:
    image_size: "32, 64"
    batch_size: 2
    num_workers: 2
    images_train_dir: "{tmp_path}/cs/img/train"
    images_val_dir: "{tmp_path}/cs/img/val"
    segmentation_train_dir: "{tmp_path}/cs/gt/train"
    segmentation_val_dir: "{tmp_path}/cs/gt/val"
  gta5_modified:
    image_size: "40, 72"
    batch_size: 2
    num_workers: 2
    images_dir: "{tmp_path}/gta5/images"
    segmentation_dir: "{tmp_path}/gta5/labels"
    decode_label_colors: true
training:
  segmentation: {{epochs: 2, do_validation: 1}}
callbacks:
  model_checkpoint: {{save_dir: "{tmp_path}/ckpt", save_name: "m",
                     save_best: true, save_freq: 1}}
  images_plots: null
{extra}
""")
    return str(path)


def _write_pngs(tmp_path):
    rng = np.random.default_rng(0)
    table = class_colors_for_remap()
    for split in ("train", "val"):
        img = tmp_path / "cs" / "img" / split / "city"
        gt = tmp_path / "cs" / "gt" / split / "city"
        img.mkdir(parents=True)
        gt.mkdir(parents=True)
        for i in range(4):
            stem = f"city_{i:06d}_000019"
            Image.fromarray(rng.integers(0, 256, (32, 64, 3), np.uint8)).save(
                img / f"{stem}_leftImg8bit.png")
            Image.fromarray(rng.integers(0, 19, (32, 64)).astype(np.uint8)
                            ).save(gt / f"{stem}_gtFine_labelTrainIds.png")
    for sub in ("images", "labels"):
        (tmp_path / "gta5" / sub).mkdir(parents=True)
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (40, 72, 3), np.uint8)).save(
            tmp_path / "gta5" / "images" / f"{i:05d}.png")
        rgb = table[rng.integers(0, 19, (50, 90))]  # resized nearest
        rgb[:5] = (1, 2, 3)  # void rows
        Image.fromarray(rgb.astype(np.uint8)).save(
            tmp_path / "gta5" / "labels" / f"{i:05d}.png")


@pytest.fixture
def drop_checkpoints(tmp_path):
    """Delete the run's checkpoints when the test ends: each BiSeNet epoch
    with its Adam moments takes ~0.2 GB of the temporary directory."""
    yield
    shutil.rmtree(tmp_path / "ckpt", ignore_errors=True)
    shutil.rmtree(tmp_path / "teacher", ignore_errors=True)


def _check_history(history, epochs):
    assert [h["epoch"] for h in history] == list(epochs)
    for h in history:
        assert 0.0 <= h["validation_mIoU"] <= 1.0
        assert np.isfinite(h["train_loss"])


def test_gta5_pngs_train_resume_and_validate_only(tmp_path, capsys):
    _write_pngs(tmp_path)
    config = _config(tmp_path)
    history = cli.main(["--config", config, "--dataset", "gta5",
                        "--augmented", "--seed", "3"])
    _check_history(history, [0, 1])
    out = capsys.readouterr().out
    assert "Training on GTA5" in out and "Best Model Saved at Epoch 0" in out
    assert (tmp_path / "ckpt" / "m" / "epoch_0.pt").exists()

    # a longer run resumes after the last saved epoch
    path = tmp_path / "longer.yaml"
    path.write_text((tmp_path / "config.yaml").read_text().replace(
        "epochs: 2", "epochs: 3"))
    saved = max(int(p.stem.split("_")[1])
                for p in (tmp_path / "ckpt" / "m").glob("epoch_*.pt"))
    history = cli.main(["--config", str(path), "--dataset", "gta5",
                        "--resume", "--seed", "3"])
    _check_history(history, range(saved + 1, 3))
    assert f"Resuming from epoch {saved + 1}" in capsys.readouterr().out

    miou = cli.main(["--config", config, "--dataset", "gta5",
                     "--validate_only"])
    assert 0.0 <= miou <= 1.0
    assert "validate_only: checkpoint epoch" in capsys.readouterr().out


def test_synthetic_cityscapes_run(tmp_path, capsys):
    history = cli.main(["--config", _config(tmp_path), "--synthetic"])
    _check_history(history, [0, 1])
    assert "Validation mIoU for Epoch 2" in capsys.readouterr().out


def test_validate_only_without_a_checkpoint_exits(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoint"):
        cli.main(["--config", _config(tmp_path), "--synthetic",
                  "--validate_only"])


@pytest.mark.parametrize("argv,extra,match", [
    (["--multihost"], "", "--multihost"),
    (["--wandb"], "", "--wandb"),
    (["--model", "deeplab", "--debug"], "", "--debug"),
    ([], "callbacks: {history: {path: h.jsonl}}", "callbacks.history"),
])
def test_not_ported_switches_exit(tmp_path, argv, extra, match):
    with pytest.raises(SystemExit, match=match) as info:
        cli.main(["--config", _config(tmp_path, extra), "--synthetic",
                  *argv])
    assert "not ported yet" in str(info.value)


def _da_config(tmp_path, da="", extra=""):
    config = _config(tmp_path, extra)
    text = (tmp_path / "config.yaml").read_text().replace(
        "segmentation: {epochs: 2, do_validation: 1}",
        "segmentation: {epochs: 2, do_validation: 1}\n"
        f"  domain_adaptation: {{epochs: 1, iterations: 3, do_validation: 1, "
        f"when_print: 2{da}}}")
    (tmp_path / "config.yaml").write_text(text)
    return config


@pytest.mark.parametrize("variant,grl", [("v1", False), ("v1", True),
                                         ("v2", False)])
def test_domain_adaptation_run_resume_and_validate_only(tmp_path, capsys,
                                                        variant, grl):
    """One epoch of three steps on synthetic data: the epoch table, the
    validation, and a checkpoint of both networks under ``<save_name>_da``,
    apart from a supervised run of the same config; then ``--resume`` runs
    the second epoch of a longer config and ``--validate_only`` reports the
    generator's mIoU."""
    extra = ("model: {adversarial_model: {discriminator: {grl: "
             "{enabled: true, alpha: 0.5}}}}" if grl else "")
    config = _da_config(tmp_path, f", variant: {variant}", extra)
    history = cli.main(["--config", config, "--synthetic",
                        "--domain_adaptation", "--augmented", "--seed", "3"])
    assert [h["epoch"] for h in history] == [0]
    h = history[0]
    assert 0.0 <= h["validation_mIoU"] <= 1.0
    for key in ("loss_gen_source", "loss_adversarial", "loss_disc_source",
                "loss_disc_target", "Generator Accuracy", "steps_per_sec"):
        assert np.isfinite(h[key]), key
    assert ("loss_gen_total" in h) == (variant == "v2")
    out = capsys.readouterr().out
    assert "Epoch Results 0" in out and "Generator Accuracy" in out
    assert "iter 2/3: loss_gen_source=" in out
    assert "Validation mIoU for Epoch 1" in out
    saved = torch.load(tmp_path / "ckpt" / "m_da" / "epoch_0.pt",
                       weights_only=True)
    assert sorted(saved) == ["discriminator", "generator"]
    assert saved["generator"]["step"] == saved["discriminator"]["step"] == 3
    assert not (tmp_path / "ckpt" / "m").exists()

    longer = tmp_path / "longer.yaml"
    longer.write_text((tmp_path / "config.yaml").read_text().replace(
        "epochs: 1, iterations: 3", "epochs: 2, iterations: 3"))
    history = cli.main(["--config", str(longer), "--synthetic",
                        "--domain_adaptation", "--augmented", "--resume",
                        "--seed", "3"])
    assert [h["epoch"] for h in history] == [1]
    assert "Resuming from epoch 1" in capsys.readouterr().out

    miou = cli.main(["--config", config, "--synthetic", "--domain_adaptation",
                     "--validate_only"])
    assert 0.0 <= miou <= 1.0
    assert "validate_only: checkpoint epoch" in capsys.readouterr().out


def test_supervised_and_da_checkpoints_keep_apart(tmp_path):
    config = _da_config(tmp_path)
    text = (tmp_path / "config.yaml").read_text().replace(
        "segmentation: {epochs: 2,", "segmentation: {epochs: 1,")
    (tmp_path / "config.yaml").write_text(text)
    cli.main(["--config", config, "--synthetic"])
    cli.main(["--config", config, "--synthetic", "--domain_adaptation"])
    ckpt = tmp_path / "ckpt"
    assert sorted(p.name for p in ckpt.iterdir()) == ["m", "m_da"]
    assert sorted(torch.load(ckpt / "m" / "epoch_0.pt",
                             weights_only=True)) == ["model"]
    # each mode resumes from its own directory
    assert cli.main(["--config", config, "--synthetic", "--resume"]) == []
    assert cli.main(["--config", config, "--synthetic", "--resume",
                     "--domain_adaptation"]) == []


@pytest.mark.parametrize("da,extra,match", [
    ("", "mesh: {data: 2}", "mesh"),
])
def test_not_ported_da_switches_exit(tmp_path, da, extra, match):
    with pytest.raises(SystemExit, match=match) as info:
        cli.main(["--config", _da_config(tmp_path, da, extra), "--synthetic",
                  "--domain_adaptation"])
    assert "not ported yet" in str(info.value)


@pytest.mark.parametrize("da,extra", [
    (", ema: {enabled: true, decay: 0.9}", ""),
    (", entropy_min: {enabled: true, lambda: 0.05}", ""),
    (", fda: {enabled: true, beta: 0.05}", ""),
    (", variant: v2, entropy_min: {enabled: true}, fda: {enabled: true}", ""),
    (", entropy_min: {enabled: true}, fda: {enabled: true}",
     "model: {adversarial_model: {discriminator: {grl: {enabled: true}}}}"),
    (", ema: {enabled: true}, self_training: {enabled: true, threshold: 0.1}",
     ""),
    (", ema: {enabled: true}, self_training: {enabled: true, threshold: "
     "'0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, "
     "0.1, 0.1, 0.1, 0.1, 0.1, 0.1', classmix: {enabled: true}}, "
     "entropy_min: {enabled: true}, fda: {enabled: true}", ""),
])
@pytest.mark.usefixtures("drop_checkpoints")
def test_da_extras_run(tmp_path, da, extra):
    """Each DA extra through the CLI, one epoch of three steps: the epoch
    table holds its losses, and a run with EMA checkpoints it."""
    history = cli.main(["--config", _da_config(tmp_path, da, extra),
                        "--synthetic", "--domain_adaptation"])
    h = history[0]
    assert 0.0 <= h["validation_mIoU"] <= 1.0
    assert np.isfinite(h["loss_gen_source"])
    assert ("loss_entropy" in h) == ("entropy_min" in da)
    assert ("loss_pseudo" in h) == ("self_training" in da)
    assert ("mix_coverage" in h) == ("classmix" in da)
    if "self_training" in da:
        assert 0.0 <= h["pl_coverage"] <= 1.0
    saved = torch.load(tmp_path / "ckpt" / "m_da" / "epoch_0.pt",
                       weights_only=True)
    assert ("ema" in saved) == ("ema" in da)


@pytest.mark.usefixtures("drop_checkpoints")
def test_self_training_calibrates_on_the_resumed_teacher(tmp_path, capsys):
    """CBST calibration prints the thresholds it derives, and a resumed
    self-training run picks up the stored EMA and step."""
    da = (", ema: {enabled: true}, self_training: {enabled: true, "
          "calibration: {enabled: true, portion: 0.5, batches: 2}}")
    config = _da_config(tmp_path, da)
    cli.main(["--config", config, "--synthetic", "--domain_adaptation"])
    out = capsys.readouterr().out
    assert "self-training calibration (portion=0.5): thresholds [" in out
    longer = tmp_path / "longer.yaml"
    longer.write_text((tmp_path / "config.yaml").read_text().replace(
        "epochs: 1, iterations: 3", "epochs: 2, iterations: 3"))
    history = cli.main(["--config", str(longer), "--synthetic",
                        "--domain_adaptation", "--resume"])
    assert [h["epoch"] for h in history] == [1]
    out = capsys.readouterr().out
    assert "Resuming from epoch 1" in out and "thresholds [" in out


@pytest.mark.parametrize("da,extra,match", [
    (", self_training: {enabled: true}", "", "needs the mean-teacher"),
    (", variant: v2, ema: {enabled: true}, self_training: {enabled: true}",
     "", "composes with the v1 adversarial step only"),
    (", ema: {enabled: true}, self_training: {enabled: true, "
     "threshold: '0.5, 0.6'}", "", "one value per class"),
])
def test_jax_refusals_of_self_training_are_kept(tmp_path, da, extra, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(["--config", _da_config(tmp_path, da, extra), "--synthetic",
                  "--domain_adaptation"])


@pytest.mark.parametrize("da,match", [
    (", variant: v2", "composes with the v1 adversarial step only"),
    (", self_training: {enabled: true}", "does not compose with "
                                         "self_training"),
])
def test_grl_refusals_keep_the_jax_messages(tmp_path, da, match):
    grl = ("model: {adversarial_model: {discriminator: {grl: "
           "{enabled: true}}}}")
    with pytest.raises(SystemExit, match=match):
        cli.main(["--config", _da_config(tmp_path, da, grl), "--synthetic",
                  "--domain_adaptation"])


def _segmentation(tmp_path, section, epochs=1, extra=""):
    """The CLI config with ``section`` added to training.segmentation."""
    config = _config(tmp_path, extra)
    text = (tmp_path / "config.yaml").read_text().replace(
        "segmentation: {epochs: 2, do_validation: 1}",
        f"segmentation: {{epochs: {epochs}, do_validation: 1, {section}}}")
    (tmp_path / "config.yaml").write_text(text)
    return config


@pytest.mark.parametrize("section", [
    "distillation: {enabled: true, teacher: {checkpoint_dir: t, "
    "quantize: int8, calib_batches: 0}}"])
def test_not_ported_training_options_exit(tmp_path, section):
    """The int8 teacher is ported (test_torch_distill_int8.py trains with
    it); its calibration needs at least one batch, as in JAX."""
    with pytest.raises(SystemExit, match="calib_batches 0 must be >= 1"):
        cli.main(["--config", _segmentation(tmp_path, section),
                  "--synthetic"])


@pytest.mark.parametrize("section", [
    "accumulate_steps: 2", "ema: {enabled: true}",
    "accumulate_steps: 2, ema: {enabled: true, decay: 0.9}"])
@pytest.mark.usefixtures("drop_checkpoints")
def test_accumulation_and_ema_runs(tmp_path, section):
    """GTA5 at batch 4: micro-batches of 2 frames, which BiSeNet needs."""
    config = _segmentation(tmp_path, section)
    text = (tmp_path / "config.yaml").read_text().replace(
        'image_size: "40, 72"\n    batch_size: 2',
        'image_size: "40, 72"\n    batch_size: 4')
    (tmp_path / "config.yaml").write_text(text)
    history = cli.main(["--config", config, "--synthetic", "--dataset",
                        "gta5"])
    _check_history(history, [0])
    saved = torch.load(tmp_path / "ckpt" / "m" / "epoch_0.pt",
                       weights_only=True)
    assert ("ema" in saved) == ("ema" in section)
    # 16 GTA5 frames at batch 4: 4 optimizer steps; with accumulation each
    # of 2 micro-batches, which batch-normalize one after the other
    assert saved["model"]["step"] == 4
    bn = [v for k, v in saved["model"]["model"].items()
          if k.endswith("num_batches_tracked")]
    assert {int(v) for v in bn} == {8 if "accumulate" in section else 4}


def test_a_micro_batch_of_one_bisenet_frame_is_refused(tmp_path):
    """GTA5 at batch 2 split in 2: BiSeNet refuses a micro-batch of one
    frame, and says why."""
    with pytest.raises(ValueError, match="micro-batches of 1"):
        cli.main(["--config", _segmentation(tmp_path, "accumulate_steps: 2"),
                  "--synthetic", "--dataset", "gta5"])


@pytest.mark.usefixtures("drop_checkpoints")
def test_distillation_runs_from_a_teacher_checkpoint(tmp_path, monkeypatch):
    """A teacher checkpoint of the port (a seeded model saved with an
    ``ema`` item) distils into BiSeNet; the step's own losses reach the
    callbacks.  (A DeepLabV2 teacher, the default, is loaded the same way:
    test_torch_distill.py and chip_smoke.py's distillation phase.)"""
    teacher = "bisenet"
    config = _segmentation(
        tmp_path, f"distillation: {{enabled: true, alpha: 0.5, teacher: "
                  f"{{model: {teacher}, checkpoint_dir: "
                  f"'{tmp_path}/teacher'}}}}")
    model, _ = make_segmentor(load_config(config), teacher, seed=7)
    CheckpointManager(str(tmp_path / "teacher")).save(
        0, {"model": TrainState(model, make_optimizer(
            "SGD", model.parameters(), 0.01)),
            "ema": EMA(ema_init(model))}, monitor=0.5)
    seen = []
    fan_out = loop._fan_out

    def spy(callbacks, method, *args, **kwargs):
        if method == "on_batch_end":
            seen.append(args[1])
        return fan_out(callbacks, method, *args, **kwargs)

    monkeypatch.setattr(loop, "_fan_out", spy)
    history = cli.main(["--config", config, "--synthetic"])
    _check_history(history, [0])
    assert seen and all(np.isfinite(logs["loss_distill"])
                        and np.isfinite(logs["loss_ce"]) for logs in seen)


@pytest.mark.parametrize("section,extra,match", [
    ("accumulate_steps: 2, distillation: {enabled: true, teacher: "
     "{checkpoint_dir: t}}", "", "does not compose with accumulate_steps"),
    ("distillation: {enabled: true}", "", "teacher.checkpoint_dir"),
    ("distillation: {enabled: true, teacher: {checkpoint_dir: t, "
     "quantize: int4}}", "", "not supported"),
    ("accumulate_steps: 3", "", "does not divide into accumulate_steps=3"),
])
def test_jax_refusals_of_the_training_extras_are_kept(tmp_path, section,
                                                      extra, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(["--config", _segmentation(tmp_path, section, extra=extra),
                  "--synthetic"])


def test_criterion_other_than_cross_entropy_exits(tmp_path):
    config = _config(tmp_path, "model: {bisenet: {criterion: {name: Dice}}}")
    with pytest.raises(SystemExit, match="trains with CrossEntropy"):
        cli.main(["--config", config, "--synthetic"])


def test_colour_jitter_is_refused(tmp_path):
    config = _config(tmp_path, "augmentation: {ColorJitter: {hue: 0.1}}")
    with pytest.raises(NotImplementedError, match="ColorJitter"):
        cli.main(["--config", config, "--synthetic", "--dataset", "gta5",
                  "--augmented"])


class _State:
    """A train-state stand-in: one tensor."""

    def __init__(self, value, n=3):
        self.w = torch.full((n,), float(value))

    def state_dict(self):
        return {"w": self.w.clone()}

    def load_state_dict(self, state):
        if state["w"].shape != self.w.shape:
            raise RuntimeError("size mismatch for w")
        self.w.copy_(state["w"])


def test_checkpoint_keeps_the_latest_and_the_best(tmp_path):
    ckpt = ModelCheckpoint(str(tmp_path), "m", save_best=False,
                           max_to_keep=2)
    state = _State(0)
    ckpt.attach(lambda: {"model": state})
    for epoch, miou in enumerate([0.5, 0.9, 0.2, 0.3]):
        state.w.fill_(epoch)
        ckpt.on_epoch_end(epoch)
        ckpt.on_validation_end({"validation_mIoU": miou})
    mgr = ckpt.manager
    assert mgr.all_steps() == [1, 2, 3]  # the last two, and the best
    assert mgr.best_step() == 1 and mgr.latest_step() == 3

    fresh = _State(-1)
    resumed = ModelCheckpoint(str(tmp_path), "m")
    states, start = resumed.resume({"model": fresh})
    assert start == 4 and states["model"] is fresh
    assert fresh.w.tolist() == [3.0] * 3 and resumed.best == 0.9

    wrong = _State(-1, n=4)
    assert not mgr.restore({"model": wrong})
    assert wrong.w.tolist() == [-1.0] * 4
    assert not mgr.restore({"generator": _State(0)})
    assert ModelCheckpoint(str(tmp_path), "empty").resume(
        {"model": fresh}) == ({"model": fresh}, 0)


def test_early_stopping_counts_validations_without_gain():
    stop = EarlyStopping(patience=2)
    for miou in (0.3, 0.4, 0.4, 0.35):
        assert not stop.should_stop
        stop.on_validation_end({"validation_mIoU": miou})
    assert stop.should_stop and stop.best == 0.4


def test_deeplab_run_with_sliding_validation(tmp_path, capsys):
    """``--model deeplab`` trains DeepLabV2-R101 (at batch 2) and validates
    it window by window; ``--validate_only`` takes the same protocol."""
    config = _config(tmp_path, "validation: {sliding: {enabled: true, "
                               "window: '16, 32', window_chunk: 4}}")
    text = (tmp_path / "config.yaml").read_text().replace(
        "epochs: 2", "epochs: 1")
    (tmp_path / "config.yaml").write_text(text)
    history = cli.main(["--config", config, "--synthetic", "--model",
                        "deeplab"])
    _check_history(history, [0])
    saved = torch.load(tmp_path / "ckpt" / "m" / "epoch_0.pt",
                       weights_only=True)
    assert "layer6.conv2d_list.3.weight" in saved["model"]["model"]
    miou = cli.main(["--config", config, "--synthetic", "--model", "deeplab",
                     "--validate_only"])
    assert 0.0 <= miou <= 1.0
    assert "validate_only: checkpoint epoch 0" in capsys.readouterr().out


def test_deeplab_generator_run_with_ensemble_validation(tmp_path, capsys):
    config = _da_config(
        tmp_path, extra="model: {adversarial_model: {generator: {name: "
                        "deeplab}}}\nvalidation: {ensemble: {enabled: true, "
                        "scales: '0.5, 1.0'}}")
    history = cli.main(["--config", config, "--synthetic",
                        "--domain_adaptation"])
    assert [h["epoch"] for h in history] == [0]
    assert np.isfinite(history[0]["loss_adversarial"])
    assert 0.0 <= history[0]["validation_mIoU"] <= 1.0
    saved = torch.load(tmp_path / "ckpt" / "m_da" / "epoch_0.pt",
                       weights_only=True)
    assert "layer6.conv2d_list.0.bias" in saved["generator"]["model"]


class _Stop(Exception):
    pass


def _stop(*args, **kwargs):
    raise _Stop


@pytest.mark.parametrize("argv,extra,target,want", [
    (["--model", "deeplab"], "", "supervised.make_train_step", 7),
    ([], "", "supervised.make_train_step", 5),
    (["--domain_adaptation"], "", "adversarial.make_adversarial_step", 5),
    (["--domain_adaptation"],
     "  adversarial_model: {generator: {name: deeplab}}",
     "adversarial.make_adversarial_step", 7),
])
def test_ignore_index_comes_from_the_trained_models_section(
        tmp_path, monkeypatch, argv, extra, target, want):
    """The trained model's section gives ``ignore_index``: the generator's
    under ``--domain_adaptation``."""
    seen = []

    def record(*args, ignore_index=None, **kwargs):
        seen.append(ignore_index)
        raise _Stop

    module, name = target.split(".")
    monkeypatch.setattr(f"rtsds_tpu_torch.train.{module}.{name}", record)
    sections = ("model:\n  deeplab: {criterion: {ignore_index: 7}}\n"
                "  bisenet: {criterion: {ignore_index: 5}}\n" + extra)
    with pytest.raises(_Stop):
        cli.main(["--config", _da_config(tmp_path, extra=sections),
                  "--synthetic", *argv])
    assert seen == [want]


@pytest.mark.parametrize("model,section,exits", [
    ("deeplab", "deeplab", True), ("deeplab", "bisenet", False),
    ("bisenet", "bisenet", True)])
def test_criterion_comes_from_the_trained_models_section(
        tmp_path, monkeypatch, model, section, exits):
    monkeypatch.setattr("rtsds_tpu_torch.train.supervised.make_train_step",
                        _stop)
    config = _config(tmp_path, f"model: {{{section}: {{criterion: "
                               f"{{name: Dice}}}}}}")
    with pytest.raises(SystemExit if exits else _Stop,
                       match=f"model.{model}.criterion.name" if exits
                       else None):
        cli.main(["--config", config, "--synthetic", "--model", model])


def test_both_validation_protocols_exit(tmp_path):
    config = _config(tmp_path, "validation: {ensemble: {enabled: true}, "
                               "sliding: {enabled: true}}")
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli.main(["--config", config, "--synthetic"])
