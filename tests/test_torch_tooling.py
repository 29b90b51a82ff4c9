"""The port's training tooling against the JAX package's: preemption and
the emergency checkpoint (SIGTERM -> an epoch-start snapshot -> ``--resume``
replays the epoch), the history, image-plot, W&B and TensorBoard
callbacks, ``.env`` loading and ``--debug``.

Each callback is fed the same hook calls as its JAX counterpart and must
write the same records and files: history lines equal but for their
``time``; figures equal pixel for pixel (Agg, and the PIL fallback); the
W&B stub sees the same calls; TensorBoard's event files hold the same
scalars.  The preempted CLI run is held bit for bit against an
uninterrupted one.
"""

import os
import shutil
import signal
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

from rtsds_tpu.callbacks import history as jax_history
from rtsds_tpu.callbacks import logging as jax_logging
from rtsds_tpu.callbacks import plots as jax_plots
from rtsds_tpu.utils import dotenv as jax_dotenv
from rtsds_tpu.utils import preemption as jax_preemption
from rtsds_tpu_torch import cli, ckpt_info
from rtsds_tpu_torch.callbacks import history, logging, plots
from rtsds_tpu_torch.callbacks.base import Callback
from rtsds_tpu_torch.callbacks.checkpoint import (
    CheckpointManager, ModelCheckpoint)
from rtsds_tpu_torch.eval.validate import make_eval_step, validate
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.utils import debug, dotenv, preemption
from test_torch_cli import _check_history, _config, _State


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tensors_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tensors_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_tensors_equal, a, b))
    return a == b


class _SigtermAt(Callback):
    """Sends SIGTERM to this process at batch ``batch`` of epoch
    ``epoch``, as a scheduler evicting the job would."""

    def __init__(self, epoch, batch):
        self.epoch, self.batch, self.epochs_done = epoch, batch, 0

    def on_epoch_end(self, epoch, logs=None):
        self.epochs_done += 1

    def on_batch_end(self, batch, logs=None):
        if self.epochs_done == self.epoch and batch == self.batch:
            os.kill(os.getpid(), signal.SIGTERM)


def _preemption_config(root):
    root.mkdir()
    path = _config(root)
    text = open(path).read().replace("save_best: true", "save_best: false")
    open(path, "w").write(text)
    return path


def test_sigterm_saves_the_epoch_start_and_resume_replays_it(
        tmp_path, monkeypatch, capsys):
    """SIGTERM in epoch 1: the run exits cleanly with JAX's message; the
    emergency checkpoint of epoch 1 is the epoch-start state (the state
    saved after epoch 0, bit for bit), ``ckpt_info`` reports it, and
    ``--resume`` replays epoch 1 to the checkpoint of an uninterrupted
    run, bit for bit."""
    flags = ["--synthetic", "--seed", "4"]
    whole = cli.main(["--config", _preemption_config(tmp_path / "a"),
                      *flags])
    _check_history(whole, [0, 1])

    build = cli.build_callbacks

    def with_sigterm(*args, **kwargs):
        callbacks, checkpoint = build(*args, **kwargs)
        return [*callbacks, _SigtermAt(epoch=1, batch=2)], checkpoint

    monkeypatch.setattr(cli, "build_callbacks", with_sigterm)
    config = _preemption_config(tmp_path / "b")
    before = signal.getsignal(signal.SIGTERM)
    assert cli.main(["--config", config, *flags]) is None
    assert signal.getsignal(signal.SIGTERM) is before
    out = capsys.readouterr().out
    assert "Emergency checkpoint saved at epoch 1" in out
    assert "Preempted (received signal 15); exiting -- restart with " \
           "--resume" in out
    run_dir = str(tmp_path / "b" / "ckpt" / "m")
    info = ckpt_info.describe_checkpoint(run_dir)
    assert info["emergency_step"] == 1 and info["latest_step"] == 1
    assert "EMERGENCY(mid-epoch)" in ckpt_info.format_report(run_dir, info)
    mgr = CheckpointManager(run_dir)
    assert _tensors_equal(mgr.load(1), mgr.load(0))

    monkeypatch.setattr(cli, "build_callbacks", build)
    resumed = cli.main(["--config", config, *flags, "--resume"])
    assert "Resuming from epoch 1" in capsys.readouterr().out
    assert resumed == whole[1:]
    assert ckpt_info.describe_checkpoint(run_dir)["emergency_step"] is None
    want = CheckpointManager(str(tmp_path / "a" / "ckpt" / "m")).load(1)
    assert _tensors_equal(mgr.load(1), want)
    shutil.rmtree(tmp_path / "a")
    shutil.rmtree(tmp_path / "b")


def test_an_exception_in_domain_adaptation_saves_the_epoch_start(
        tmp_path, monkeypatch):
    """Any exception leaving the DA loop saves the interrupted epoch's
    start (generator, discriminator) and propagates."""
    config = _config(tmp_path)
    text = open(config).read().replace(
        "segmentation: {epochs: 2, do_validation: 1}",
        "segmentation: {epochs: 2, do_validation: 1}\n"
        "  domain_adaptation: {epochs: 2, iterations: 2, "
        "do_validation: 1}")
    open(config, "w").write(text)

    class _Fail(Callback):
        def __init__(self):
            self.batches = 0

        def on_batch_end(self, batch, logs=None):
            self.batches += 1
            if self.batches == 3:   # the first step of epoch 1
                raise RuntimeError("planted failure")

    build = cli.build_callbacks
    monkeypatch.setattr(cli, "build_callbacks", lambda *a, **k: (
        [*build(*a, **k)[0], _Fail()], build(*a, **k)[1]))
    with pytest.raises(RuntimeError, match="planted failure"):
        cli.main(["--config", config, "--synthetic", "--domain_adaptation"])
    run_dir = str(tmp_path / "ckpt" / "m_da")
    mgr = CheckpointManager(run_dir)
    assert ckpt_info.describe_checkpoint(run_dir)["emergency_step"] == 1
    # epoch 0 was saved as best; the snapshot of epoch 1's start equals it
    assert _tensors_equal(mgr.load(1), mgr.load(0))
    shutil.rmtree(tmp_path / "ckpt")


def test_save_emergency_keeps_a_saved_epoch_and_never_raises(tmp_path,
                                                             capsys):
    ckpt = ModelCheckpoint(save_dir=str(tmp_path), save_name="m",
                           save_best=False)
    assert ckpt.save_emergency() is False          # nothing attached
    state = _State(1.0)
    ckpt.attach(lambda: {"model": state},
                lambda: {"model": _State(0.5)})
    ckpt.set_epoch(0)
    ckpt.on_epoch_end(0)                            # the post-epoch save
    state.w += 1
    assert ckpt.save_emergency() is True
    assert "already has a post-epoch snapshot" in capsys.readouterr().out
    assert torch.equal(ckpt.manager.load(0)["model"]["w"],
                       torch.full((3,), 1.0))
    assert not os.path.exists(ckpt.emergency_marker)
    ckpt.set_epoch(1)
    assert ckpt.save_emergency() is True            # the snapshot's values
    assert torch.equal(ckpt.manager.load(1)["model"]["w"],
                       torch.full((3,), 0.5))
    assert open(ckpt.emergency_marker).read() == "1"
    assert ckpt.save_emergency() is True            # kept, not rewritten
    assert "already has a mid-epoch snapshot" in capsys.readouterr().out
    restored, start = ModelCheckpoint(
        save_dir=str(tmp_path), save_name="m").resume({"model": _State(9)})
    assert start == 1 and torch.equal(restored["model"].w,
                                      torch.full((3,), 0.5))

    def broken():
        raise OSError("disk full")

    ckpt.attach(broken)
    ckpt.set_epoch(2)
    assert ckpt.save_emergency() is False
    assert "emergency checkpoint failed: disk full" in \
        capsys.readouterr().out


def test_preemption_handler_matches_jax():
    before = signal.getsignal(signal.SIGTERM)
    previous = preemption.install_preemption_handler()
    try:
        with pytest.raises(preemption.Preempted, match="received signal 15"):
            os.kill(os.getpid(), signal.SIGTERM)
    finally:
        preemption.restore_handlers(previous)
    assert signal.getsignal(signal.SIGTERM) is before
    jax_previous = jax_preemption.install_preemption_handler()
    assert jax_previous.keys() == previous.keys()
    jax_preemption.restore_handlers(jax_previous)


def _drive(cb):
    cb.on_train_begin()
    cb.on_batch_end(0, {"train_loss": 0.5, "train_accuracy": 10.0})
    cb.on_epoch_end(0, {"train_loss": 0.4, "train_accuracy": float("nan"),
                        "note": "x"})
    cb.on_validation_end({"validation_mIoU": 0.25},
                         data=[("road", 0.5), ("car", float("nan"))])
    cb.on_epoch_end(1, {"train_loss": 0.3, "steps_per_sec": 2.0})
    cb.on_validation_end({"validation_mIoU": 0.3}, data=None)
    cb.on_train_end()


def test_history_records_equal_jaxs(tmp_path):
    ours = history.HistoryCallback(str(tmp_path / "a" / "h.jsonl"))
    theirs = jax_history.HistoryCallback(str(tmp_path / "b" / "h.jsonl"))
    _drive(ours)
    _drive(theirs)

    def untimed(path, read):
        records = read(path)
        assert all(isinstance(r.pop("time"), float) for r in records)
        return records

    got = untimed(ours.path, history.read_history)
    assert got == untimed(theirs.path, jax_history.read_history)
    assert [r["event"] for r in got] == [
        "train_begin", "epoch", "validation", "epoch", "validation",
        "train_end"]
    assert got[1]["train_accuracy"] is None
    assert got[2]["per_class_iou"] == {"road": 0.5, "car": None}


def _samples(n=3):
    rng = np.random.default_rng(1)
    return [(rng.normal(size=(2, 24, 40, 3)).astype(np.float32),
             rng.integers(0, 19, (2, 24, 40)).astype(np.int32),
             rng.integers(0, 19, (2, 24, 40))) for _ in range(n)]


def _plot(module, save_dir):
    cb = module.ImagePlotsCallback(save_dir=str(save_dir),
                                   number_of_samples=2)
    cb.on_validation_begin()
    cb.set_epoch(3)
    for s in _samples():
        cb.add_sample(*s)
    cb.on_validation_end({"validation_mIoU": 0.1})
    return sorted(os.listdir(save_dir))


def _pixels(path):
    return np.asarray(Image.open(path))


@pytest.mark.parametrize("renderer", ["matplotlib", "PIL"])
def test_image_plots_equal_jaxs(tmp_path, monkeypatch, renderer):
    if renderer == "PIL":
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    names = _plot(plots, tmp_path / "a")
    assert names == _plot(jax_plots, tmp_path / "b")
    want = (["val_epoch_3.png"] if renderer == "matplotlib" else
            [f"val_epoch_3_{r}_{p}.png" for r in (0, 1)
             for p in ("gt", "input", "pred")])
    assert names == want
    for name in names:
        np.testing.assert_array_equal(_pixels(tmp_path / "a" / name),
                                      _pixels(tmp_path / "b" / name))


def test_image_plots_without_matplotlib_or_pil(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="matplotlib or PIL"):
        _plot(plots, tmp_path)


def test_validation_hands_the_plots_host_arrays_of_its_argmax():
    model = BiSeNet().eval()
    rng = np.random.default_rng(2)
    batches = [(torch.from_numpy(rng.normal(size=(2, 32, 64, 3))
                                 .astype(np.float32)),
                torch.from_numpy(rng.integers(0, 19, (2, 32, 64))
                                 .astype(np.int32))) for _ in range(2)]
    cb = plots.ImagePlotsCallback(number_of_samples=4)
    cb.on_validation_end = lambda logs=None, data=None: None
    step = make_eval_step(model, 19, return_preds=True)
    validate(model, batches, 19, callbacks=[cb], eval_step=step,
             device="cpu")
    assert len(cb._preds) == 2
    for (images, labels), x, y, p in zip(batches, cb._inputs, cb._targets,
                                         cb._preds):
        assert all(isinstance(a, np.ndarray) for a in (x, y, p))
        np.testing.assert_array_equal(x, images.numpy())
        np.testing.assert_array_equal(y, labels.numpy())
        with torch.no_grad():
            want = model(images.permute(0, 3, 1, 2)).argmax(dim=1)
        np.testing.assert_array_equal(p, want.numpy())


class _FakeRun:
    def __init__(self, calls):
        self.calls = calls

    def log(self, payload):
        self.calls.append(("log", payload))

    def finish(self):
        self.calls.append(("finish",))


def _fake_wandb(monkeypatch):
    calls = []
    wandb = types.ModuleType("wandb")

    def init(**kwargs):
        calls.append(("init", kwargs))
        return _FakeRun(calls)

    wandb.init = init
    wandb.Table = lambda columns, data: {"columns": columns, "data": data}
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    return calls


def test_wandb_calls_equal_jaxs(monkeypatch, capsys):
    calls = _fake_wandb(monkeypatch)
    _drive(logging.WandBCallback("p", "r", {"a": 1}, note="n"))
    ours = list(calls)
    calls.clear()
    _drive(jax_logging.WandBCallback("p", "r", {"a": 1}, note="n"))
    assert repr(ours) == repr(calls)
    assert ours[0] == ("init", {"project": "p", "name": "r",
                                "config": {"a": 1}, "notes": "n"})
    monkeypatch.setitem(sys.modules, "wandb", None)
    _drive(logging.WandBCallback("p"))
    out = capsys.readouterr().out
    assert "wandb is not installed; WandBCallback degrades to console" in out
    assert "validation: {'validation_mIoU': 0.25}" in out


def test_tensorboard_scalars_equal_jaxs(tmp_path):
    event_accumulator = pytest.importorskip(
        "tensorboard.backend.event_processing.event_accumulator")

    def scalars(log_dir):
        acc = event_accumulator.EventAccumulator(str(log_dir))
        acc.Reload()
        return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
                for tag in acc.Tags()["scalars"]}

    _drive(logging.TensorBoardCallback(str(tmp_path / "a")))
    _drive(jax_logging.TensorBoardCallback(str(tmp_path / "b")))
    got = scalars(tmp_path / "a")
    assert repr(got) == repr(scalars(tmp_path / "b"))   # NaN included
    assert got["train_loss"] == [(0, pytest.approx(0.4)),
                                 (1, pytest.approx(0.3))]


def test_dotenv_equals_jaxs(tmp_path, monkeypatch):
    path = tmp_path / ".env"
    path.write_text("# comment\nROOT=/data\nGTA='${ROOT}/gta5'\n"
                    "KEEP=new\nbad line\nEMPTY=\n")
    monkeypatch.setenv("KEEP", "old")
    for key in ("ROOT", "GTA", "EMPTY"):
        monkeypatch.delenv(key, raising=False)
    ours = dotenv.load_dotenv(str(path))
    env = {k: os.environ.get(k) for k in ("ROOT", "GTA", "KEEP", "EMPTY")}
    for key in ("ROOT", "GTA", "EMPTY"):
        monkeypatch.delenv(key)
    assert jax_dotenv.load_dotenv(str(path)) == ours
    assert {k: os.environ.get(k) for k in env} == env
    assert env == {"ROOT": "/data", "GTA": "/data/gta5", "KEEP": "old",
                   "EMPTY": ""}
    assert dotenv.load_dotenv(str(tmp_path / "none")) == {}
    dotenv.load_dotenv(str(path), override=True)
    assert os.environ["KEEP"] == "new"


def test_cli_writes_history_plots_and_logs_to_wandb(tmp_path, monkeypatch):
    """``callbacks.history``, ``callbacks.images_plots`` and ``--wandb``
    through the CLI; W&B's key is read from ``.env``; ``--wandb`` without
    ``callbacks.logging.wandb`` exits as the JAX CLI does."""
    calls = _fake_wandb(monkeypatch)
    monkeypatch.chdir(tmp_path)
    (tmp_path / ".env").write_text("WANDB_API_KEY=k123\n")
    monkeypatch.delenv("WANDB_API_KEY", raising=False)
    config = _config(tmp_path)
    text = open(config).read().replace("  images_plots: null\n", f"""\
  images_plots: {{save_dir: "{tmp_path}/img", number_of_samples: 2}}
  history: {{path: "{tmp_path}/runs/h.jsonl"}}
  logging: {{wandb: {{project_name: p, run_name: r, note: n}}}}
""")
    open(config, "w").write(text)
    history_out = cli.main(["--config", config, "--synthetic", "--wandb"])
    _check_history(history_out, [0, 1])
    assert os.environ["WANDB_API_KEY"] == "k123"
    events = history.read_history(str(tmp_path / "runs" / "h.jsonl"))
    epochs = [r["epoch"] for r in events if r["event"] == "epoch"]
    assert epochs == [0, 1]
    assert [r["validation_mIoU"] for r in events
            if r["event"] == "validation"] == [
        h["validation_mIoU"] for h in history_out]
    assert sorted(os.listdir(tmp_path / "img")) == ["val_epoch_0.png",
                                                    "val_epoch_1.png"]
    assert calls[0][0] == "init" and calls[0][1]["project"] == "p"
    assert calls[0][1]["config"]["device"] == "cpu"
    assert calls[-1] == ("finish",)
    text = text.replace("logging: {wandb: {project_name: p, run_name: r, "
                        "note: n}}", "logging: {wandb: null}")
    open(config, "w").write(text)
    with pytest.raises(SystemExit, match="callbacks.logging.wandb is "
                                         "disabled"):
        cli.main(["--config", config, "--synthetic", "--wandb"])
    shutil.rmtree(tmp_path / "ckpt")


def test_debug_names_the_layer_of_a_planted_nan():
    model = debug.name_modules(BiSeNet().eval())
    with torch.no_grad():
        model.ffm.conv1.weight[0, 0] = float("nan")
    anomaly = torch.is_anomaly_enabled()
    debug.enable_debug(disable_optimizations=True)
    try:
        assert torch.is_anomaly_enabled()
        assert torch.get_float32_matmul_precision() == "highest"
        with pytest.raises(FloatingPointError,
                           match="module 'ffm.conv1' \\(Conv2d"):
            model(torch.zeros(2, 3, 32, 64))
    finally:
        debug.disable_debug()
    assert torch.is_anomaly_enabled() == anomaly
    with torch.no_grad():
        model(torch.zeros(2, 3, 32, 64))   # the hook is gone


def test_cli_debug_raises_on_a_planted_nan_and_restores(tmp_path,
                                                        monkeypatch):
    from rtsds_tpu_torch.train import factory

    build = factory.build_supervised

    def planted(*args, **kwargs):
        state = build(*args, **kwargs)
        with torch.no_grad():
            state.model.context_path.layer2[0].conv1.weight.fill_(
                float("nan"))
        return state

    monkeypatch.setattr(factory, "build_supervised", planted)
    config = _config(tmp_path)
    with pytest.raises(FloatingPointError,
                       match="'context_path.layer2.0.conv1'"):
        cli.main(["--config", config, "--synthetic", "--debug"])
    assert not torch.is_anomaly_enabled()
    assert not torch.nn.modules.module._global_forward_hooks
    shutil.rmtree(tmp_path / "ckpt", ignore_errors=True)
