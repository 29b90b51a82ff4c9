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
from rtsds_tpu_torch.bench.da_bench import da_step_benchmark
from rtsds_tpu_torch.config import load_config
from rtsds_tpu_torch.eval.validate import validate
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.ops.cuda import hist as cuda_hist
from rtsds_tpu_torch.ops.cuda import remap as cuda_remap
from rtsds_tpu_torch.serve import Predictor
from rtsds_tpu_torch.train.adversarial import make_adversarial_step
from rtsds_tpu_torch.train.factory import build_adversarial, build_supervised
from rtsds_tpu_torch.train.loop import adversarial_fit, supervised_fit
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
    print(len(names))
""")


def test_port_imports_nothing_of_jax_or_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15


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
