"""The port stands alone: it imports nothing of JAX or of the JAX package,
and its entry points never drop to the CPU on their own."""

import ast
import inspect
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from rtsds_tpu_torch import cli, serve_server
from rtsds_tpu_torch.bench import __main__ as one_line_bench
from rtsds_tpu_torch.bench import (
    da_bench, ensemble_bench, flops, io_bench, latency, sliding_bench,
    train_bench)
from rtsds_tpu_torch.eval import ensemble, sliding
from rtsds_tpu_torch.models import deeplabv2
from rtsds_tpu_torch.bench.da_bench import da_step_benchmark
from rtsds_tpu_torch.bench.train_bench import supervised_step_benchmark
from rtsds_tpu_torch.config import load_config
from rtsds_tpu_torch.eval.ensemble import make_ensemble_eval_step
from rtsds_tpu_torch.eval.sliding import make_sliding_eval_step
from rtsds_tpu_torch.eval.validate import validate
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2
from rtsds_tpu_torch.ops.cuda import hist as cuda_hist
from rtsds_tpu_torch.ops.cuda import remap as cuda_remap
from rtsds_tpu_torch.serve import Predictor
from rtsds_tpu_torch.ops import fda
from rtsds_tpu_torch.train import accumulate, distill, ema, self_training
from rtsds_tpu_torch.train.adversarial import make_adversarial_step
from rtsds_tpu_torch.train.factory import build_adversarial, build_supervised
from rtsds_tpu_torch.train.loop import adversarial_fit, supervised_fit
from rtsds_tpu_torch.train.self_training import make_self_training_step
from rtsds_tpu_torch.train.supervised import make_train_step

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = textwrap.dedent("""
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "orbax", "rtsds_tpu")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"the port must not import {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import rtsds_tpu_torch
    names = ["chip_smoke"] + [
        m.name for m in pkgutil.walk_packages(rtsds_tpu_torch.__path__,
                                              "rtsds_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print(" ".join(names))
""")

# modules whose import must stay clean by name, beside the walk of them all
NAMED = ("rtsds_tpu_torch.models.deeplabv2", "rtsds_tpu_torch.eval.sliding",
         "rtsds_tpu_torch.eval.ensemble",
         "rtsds_tpu_torch.bench.train_bench", "chip_smoke",
         "rtsds_tpu_torch.train.ema", "rtsds_tpu_torch.train.accumulate",
         "rtsds_tpu_torch.ops.fda", "rtsds_tpu_torch.train.self_training",
         "rtsds_tpu_torch.train.distill", "rtsds_tpu_torch.serve_server",
         "rtsds_tpu_torch.ckpt_info", "rtsds_tpu_torch.export_torch",
         "rtsds_tpu_torch.utils.profiling", "rtsds_tpu_torch.bench.latency",
         "rtsds_tpu_torch.bench.flops", "rtsds_tpu_torch.bench.sliding_bench",
         "rtsds_tpu_torch.bench.ensemble_bench",
         "rtsds_tpu_torch.bench.io_bench", "rtsds_tpu_torch.bench.__main__",
         "rtsds_tpu_torch.ops.quant", "rtsds_tpu_torch.models.bisenet_int8",
         "rtsds_tpu_torch.models.deeplab_int8", "rtsds_tpu_torch.train.qat",
         "rtsds_tpu_torch.qat", "rtsds_tpu_torch.pseudo_label",
         "rtsds_tpu_torch.bench.quant_bench")


def test_port_imports_nothing_of_jax_or_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    imported = proc.stdout.split()
    assert len(imported) >= 15
    assert set(NAMED) <= set(imported)


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(image_size=(64, 128))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        validate(BiSeNet(), iter([]), 19)


def test_trainer_and_cli_refuse_to_fall_back_to_the_cpu(monkeypatch,
                                                        tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = load_config(overrides={
        "training": {"segmentation": {"epochs": 1}}})
    state = build_supervised(config, "bisenet", 1, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        supervised_fit(state, make_train_step(), lambda e: [],
                       lambda e: [], epochs=1, num_classes=19)
    # the default config's device is the GPU; the CLI resolves it first
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--synthetic"])
    path = tmp_path / "c.yaml"
    path.write_text("device: tpu\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", str(path), "--synthetic"])


def test_adversarial_trainer_and_bench_refuse_to_fall_back_to_the_cpu(
        monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = load_config(overrides={
        "training": {"domain_adaptation": {"epochs": 1, "iterations": 1}}})
    gen, dis = build_adversarial(config, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        adversarial_fit(gen, dis, make_adversarial_step(0.1, 1, 1),
                        iter([]), iter([]), lambda e: [], iterations=1,
                        epochs=1, num_classes=19)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        da_step_benchmark(batch_size=2, src_hw=(32, 64), tgt_hw=(32, 64))
    path = tmp_path / "c.yaml"
    path.write_text("device: cuda\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", str(path), "--synthetic",
                  "--domain_adaptation"])


def test_hist_wrapper_has_no_fallback():
    """On a CUDA tensor the wrapper launches the kernel or raises: no
    ``try`` in its module may catch a failed build or launch."""
    tree = ast.parse(inspect.getsource(cuda_hist))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_remap_wrapper_has_no_fallback():
    """The same for the RGB remap kernel's wrapper."""
    tree = ast.parse(inspect.getsource(cuda_remap))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


@pytest.mark.parametrize("module", [deeplabv2, sliding, ensemble])
def test_deeplab_and_protocol_modules_catch_nothing(module):
    """The model and the protocols call K1's wrapper and the model with no
    ``try`` around either: a failed launch is never swallowed."""
    tree = ast.parse(inspect.getsource(module))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_deeplab_protocols_and_train_bench_refuse_to_fall_back_to_the_cpu(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for protocol in ("plain", "sliding", "ensemble"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Predictor(model_name="deeplab", image_size=(64, 128),
                      protocol=protocol)
    model = DeepLabV2(layers=(1, 1, 1, 1))
    for step in (make_sliding_eval_step(model, (64, 128), 19),
                 make_ensemble_eval_step(model, (64, 128), 19)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            validate(model, iter([]), 19, eval_step=step)
    for kwargs in ({}, {"remat": True}, {"bn_eval": True}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            supervised_step_benchmark("deeplab", batch_size=1,
                                      image_size=(32, 64), **kwargs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        da_step_benchmark(batch_size=1, src_hw=(32, 64), tgt_hw=(32, 64),
                          generator="deeplab")


def test_unported_benches_exit(monkeypatch):
    """The QAT step bench is ported; like every bench it refuses to run
    without a card instead of dropping to the CPU."""
    from rtsds_tpu_torch.bench import train_bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--qat"], ["--distill", "deeplab", "--distill_quant",
                             "int8"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_bench.main(argv)
    with pytest.raises(ValueError, match="neither distill"):
        train_bench.supervised_step_benchmark(qat=True, distill="deeplab")
    with pytest.raises(ValueError, match="not supported"):
        train_bench.supervised_step_benchmark(distill="deeplab",
                                              distill_quant="int4")


@pytest.mark.parametrize("module", [ema, accumulate, fda, self_training,
                                    distill])
def test_the_da_extras_catch_nothing(module):
    """The extras' modules catch no exception (a ``try`` there only
    restores state in its ``finally``): a failed launch or a refused batch
    inside a step is never swallowed."""
    tree = ast.parse(inspect.getsource(module))
    assert not [n for n in ast.walk(tree)
                if isinstance(n, ast.ExceptHandler)]


def test_the_da_extras_refuse_to_fall_back_to_the_cpu(monkeypatch):
    """The fits with an EMA or the self-training step, and the benches of
    the extras, raise without a GPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = load_config(overrides={
        "training": {"segmentation": {"epochs": 1},
                     "domain_adaptation": {"epochs": 1, "iterations": 1}}})
    state = build_supervised(config, "bisenet", 1, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        supervised_fit(state, make_train_step(), lambda e: [], lambda e: [],
                       epochs=1, num_classes=19, ema_decay=0.999)
    gen, dis = build_adversarial(config, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        adversarial_fit(gen, dis, make_self_training_step(0.1, 1), iter([]),
                        iter([]), lambda e: [], iterations=1, epochs=1,
                        num_classes=19, ema_in_step=True)
    for kwargs in ({"lambda_ent": 0.005, "fda_beta": 0.01},
                   {"self_training": True, "classmix": True}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            da_step_benchmark(batch_size=2, src_hw=(32, 64),
                              tgt_hw=(32, 64), **kwargs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        supervised_step_benchmark("bisenet", batch_size=2,
                                  image_size=(32, 64), distill="deeplab")


@pytest.mark.parametrize("module", [latency, flops, sliding_bench,
                                    ensemble_bench, io_bench, one_line_bench,
                                    da_bench, train_bench])
def test_the_benches_catch_nothing(module):
    """A failed launch inside a bench fails the bench: no ``except``."""
    tree = ast.parse(inspect.getsource(module))
    assert not [n for n in ast.walk(tree)
                if isinstance(n, ast.ExceptHandler)]


def _name(node) -> str:
    return ast.unparse(node) if node is not None else "<bare>"


def test_the_server_hides_no_failure():
    """``serve_server`` catches only what it hands on.  A handler of a
    specific, expected exception (an empty queue, a future already
    resolved or cancelled, an overloaded queue, Ctrl-C) is allowed; every
    broad ``except Exception`` passes the error on: to the clients'
    futures (``_fail``) in the collector, or as an HTTP error status
    (``send_error``) in the request handler, whose mapping answers an
    overload with 503 and anything else with 500.  Nothing is re-raised
    silently and no handler is bare."""
    tree = ast.parse(inspect.getsource(serve_server))
    specific = {"queue.Empty", "InvalidStateError", "Overloaded",
                "KeyboardInterrupt"}
    broad = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        name = _name(node.type)
        if name in specific:
            continue
        assert name == "Exception", name
        calls = {ast.unparse(c.func).split(".")[-1] for c in ast.walk(node)
                 if isinstance(c, ast.Call)}
        assert calls & {"_fail", "send_error"}, ast.unparse(node)
        assert not [n for n in ast.walk(node) if isinstance(n, ast.Raise)]
        broad.append(node)
    assert len(broad) == 2
    statuses = {_name(h.type): [c.args[0].value for c in ast.walk(h)
                                if isinstance(c, ast.Call)
                                and ast.unparse(c.func).endswith("send_error")]
                for node in ast.walk(tree) if isinstance(node, ast.Try)
                for h in node.handlers
                if any(ast.unparse(c.func).endswith("send_error")
                       for c in ast.walk(h) if isinstance(c, ast.Call))}
    assert statuses == {"Overloaded": [503], "Exception": [500]}


def test_the_serving_tools_refuse_to_fall_back_to_the_cpu(monkeypatch,
                                                          tmp_path):
    """The server's CLI and ``from_checkpoint`` raise without a GPU."""
    from rtsds_tpu_torch.callbacks.checkpoint import CheckpointManager
    from rtsds_tpu_torch.train.optim import make_optimizer
    from rtsds_tpu_torch.train.state import TrainState

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_server.main(["--size", "32, 64", "--batch", "1"])
    model = BiSeNet()
    CheckpointManager(str(tmp_path)).save(0, {"model": TrainState(
        model, make_optimizer("SGD", model.parameters(), 0.01))})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor.from_checkpoint(str(tmp_path), image_size=(32, 64))


@pytest.mark.parametrize("name", ["ops.quant", "models.bisenet_int8",
                                  "models.deeplab_int8", "train.qat", "qat",
                                  "pseudo_label", "bench.quant_bench"])
def test_the_int8_modules_catch_nothing(name):
    """No ``try`` in the int8 modules: a shape the int8 GEMM refuses, or a
    failed calibration, raises; nothing falls back to a bf16 conv."""
    import importlib

    module = importlib.import_module(f"rtsds_tpu_torch.{name}")
    tree = ast.parse(inspect.getsource(module))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_int8_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    from rtsds_tpu_torch import pseudo_label
    from rtsds_tpu_torch.ops.quant import quantize_model
    from rtsds_tpu_torch.qat import finetune
    from rtsds_tpu_torch.train.qat import prepare_qat

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames = torch.zeros((1, 64, 128, 3), dtype=torch.uint8).numpy()
    state = BiSeNet().state_dict()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(image_size=(64, 128), quantize="int8", calib_frames=frames)
    for call in (lambda: quantize_model("bisenet", state, []),
                 lambda: prepare_qat("bisenet", state, []),
                 lambda: pseudo_label.sweep_model("bisenet", state, [frames],
                                                  quantize="int8"),
                 lambda: finetune(state, None, None, 1, "unused")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
