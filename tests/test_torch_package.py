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

from rtsds_tpu_torch import cli
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
         "rtsds_tpu_torch.train.distill")


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


def test_unported_benches_exit():
    from rtsds_tpu_torch.bench import train_bench
    with pytest.raises(SystemExit, match="not ported yet"):
        train_bench.main(["--qat"])


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
