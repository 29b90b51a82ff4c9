"""The port's benches and measuring tools on the CPU: ``bench/flops.py``
held against a count of its own and against the JAX package's parameter
count; each bench's refusal without a GPU and its run with
``device="cpu"`` at tiny sizes; the one-line bench's keys; the host decode
bench; and the profiler's trace.  Times taken here are the CPU's and say
nothing of the card."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from rtsds_tpu.bench.flops import count_parameters as jax_count_parameters
from rtsds_tpu.bench.latency import program_flops
from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
from rtsds_tpu.models.deeplabv2 import DeepLabV2 as FlaxDeepLab
from rtsds_tpu_torch.bench import ensemble_bench, io_bench, sliding_bench
from rtsds_tpu_torch.bench.__main__ import main as bench_main
from rtsds_tpu_torch.bench.__main__ import one_line_record
from rtsds_tpu_torch.bench.flops import count_parameters, mfu, model_flops
from rtsds_tpu_torch.bench.latency import (
    MIN_SAMPLES, bisenet_inference_benchmark, deeplab_inference_benchmark,
    latency_benchmark)
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2
from rtsds_tpu_torch.models.pretrained import load_flax_variables
from rtsds_tpu_torch.utils.profiling import annotate, trace

SIZE = (64, 128)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _hook_flops(model, x):
    """2 * K_h * K_w * C_in / groups * C_out * H_out * W_out * N for every
    Conv2d, 2 * in * out per row for every Linear, from forward hooks."""
    total = []

    def conv(m, inputs, out):
        kh, kw = m.kernel_size
        total.append(2 * kh * kw * m.in_channels // m.groups
                     * m.out_channels * out.numel() // m.out_channels)

    def linear(m, inputs, out):
        total.append(2 * m.in_features * out.numel())

    handles = [m.register_forward_hook(conv) for m in model.modules()
               if isinstance(m, torch.nn.Conv2d)]
    handles += [m.register_forward_hook(linear) for m in model.modules()
                if isinstance(m, torch.nn.Linear)]
    with torch.no_grad():
        model(x)
    for h in handles:
        h.remove()
    return sum(total)


@pytest.mark.parametrize("name,train", [("bisenet", False),
                                        ("bisenet", True),
                                        ("deeplab", False)])
def test_model_flops_counts_every_conv(name, train, record_property):
    """``model_flops`` on the meta device equals the hooks' count of a real
    forward at b2 64x128, exactly; the JAX package's XLA cost analysis of
    the same forward goes beside it (it counts elementwise ops too)."""
    torch.manual_seed(0)
    model = BiSeNet() if name == "bisenet" else DeepLabV2()
    got = model_flops(model, (2, *SIZE, 3), train=train)
    assert got["parameters"] == count_parameters(model)
    assert set(got["flops_by_op"]) == {"aten.convolution"}
    model.train(train)
    want = _hook_flops(model, torch.randn(2, 3, *SIZE))
    assert got["flops"] == want
    assert model.training == train  # model_flops restores the mode
    if not train:
        flax = (FlaxBiSeNet(num_classes=19) if name == "bisenet"
                else FlaxDeepLab(num_classes=19))
        x = jnp.zeros((2, *SIZE, 3))
        variables = flax.init(jax.random.key(0), x, train=False)
        xla = program_flops(
            lambda v, x: flax.apply(v, x, train=False), variables, x)
        record_property("xla_cost_analysis_flops", xla)
        record_property("conv_flops", got["flops"])


def test_model_flops_leaves_the_model_untouched():
    torch.manual_seed(0)
    model = BiSeNet().eval()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model_flops(model, (2, *SIZE, 3), train=True)
    for k, v in model.state_dict().items():
        assert v.device.type == "cpu" and torch.equal(v, before[k]), k


@pytest.mark.parametrize("name", ["bisenet", "deeplab"])
def test_count_parameters_is_jaxs(name):
    flax = (FlaxBiSeNet(num_classes=19) if name == "bisenet"
            else FlaxDeepLab(num_classes=19))
    variables = flax.init(jax.random.key(0), jnp.zeros((1, *SIZE, 3)),
                          train=True)
    ours = load_flax_variables(BiSeNet() if name == "bisenet"
                               else DeepLabV2(), variables)
    assert count_parameters(ours) == jax_count_parameters(
        variables["params"])


def test_mfu_only_for_a_card_in_the_table():
    assert mfu(989e12, 1000.0, "NVIDIA H100 80GB HBM3") == pytest.approx(1.0)
    assert mfu(1e12, 10.0, "cpu") is None
    assert mfu(1e12, 10.0, "Some Other GPU") is None


@pytest.mark.parametrize("call", [
    lambda: latency_benchmark(lambda: None, ()),
    lambda: bisenet_inference_benchmark(SIZE, 1, iterations=1),
    lambda: deeplab_inference_benchmark(SIZE, 1, iterations=1),
    lambda: sliding_bench.bench_sliding(SIZE, (32, 64), iterations=1),
    lambda: ensemble_bench.bench_ensemble(SIZE, iterations=1),
    lambda: one_line_record(iters=1, da=False, models=False),
    bench_main,
])
def test_benches_refuse_to_fall_back_to_the_cpu(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_latency_benchmark_reports_p99_only_from_100_samples():
    calls = []
    few = latency_benchmark(lambda: calls.append(1), (), iterations=10,
                            warmup=2, device="cpu")
    assert len(calls) == 12 and few["samples"] == 10
    assert few["p50_ms"] is not None and few["p99_ms"] is None
    assert few["p95_ms"] is None and few["device"] == "cpu"
    many = latency_benchmark(lambda: None, (), iterations=50, repeats=2,
                             device="cpu", images_per_call=4)
    assert many["samples"] == MIN_SAMPLES["p99_ms"] == 100
    assert many["p50_ms"] <= many["p95_ms"] <= many["p99_ms"]
    assert many["fps"] == pytest.approx(4 / (many["mean_ms"] / 1e3))


@pytest.mark.parametrize("mode", ["masks", "logits"])
def test_inference_benches_run_on_the_cpu(mode):
    out = bisenet_inference_benchmark(SIZE, 2, iterations=2, warmup=1,
                                      mode=mode, device="cpu")
    for key in ("mean_ms", "std_ms", "p50_ms", "p95_ms", "p99_ms", "fps",
                "flops_per_call", "flops_per_image", "mfu"):
        assert key in out
    assert out["mfu"] is None and out["fps"] > 0
    assert out["flops_per_call"] == 2 * out["flops_per_image"]
    assert out["flops_per_image"] == model_flops(
        BiSeNet(), (1, *SIZE, 3))["flops"]
    assert (out["mode"], out["batch_size"], out["dtype"]) == (
        mode, 2, "bfloat16")
    dl = deeplab_inference_benchmark((33, 65), 1, iterations=1, warmup=1,
                                     device="cpu")
    assert dl["model"] == "deeplabv2-resnet101" and dl["fps"] > 0


def test_protocol_benches_run_on_the_cpu():
    sl = sliding_bench.bench_sliding(SIZE, (32, 64), iterations=1,
                                     device="cpu")
    assert sl["windows_per_frame"] == 9 and sl["bf16_ms"] > 0
    ens = ensemble_bench.bench_ensemble(SIZE, iterations=1, device="cpu")
    assert ens["scales"] == [0.75, 1.0, 1.25] and ens["bf16_fps"] > 0


@pytest.mark.parametrize("module,env", [(sliding_bench, "SL_INT8"),
                                        (ensemble_bench, "ENS_INT8")])
def test_unported_int8_benches_exit(monkeypatch, module, env):
    """The int8 variants are ported: on the CPU the function times both
    models, and ``main`` (the card's full size) refuses to run without a
    card instead of dropping to the CPU."""
    monkeypatch.setenv(env, "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main()
    if module is sliding_bench:
        out = module.bench_sliding(SIZE, (32, 64), iterations=1,
                                   include_int8=True, device="cpu")
    else:
        out = module.bench_ensemble(SIZE, iterations=1, include_int8=True,
                                    device="cpu")
    assert out["int8_ms"] > 0 and out["bf16_ms"] > 0
    assert out["speedup"] == pytest.approx(out["bf16_ms"] / out["int8_ms"])


def test_one_line_record_keys_on_the_cpu():
    out = one_line_record(batch=2, iters=2, da_batch=2, da_steps=1,
                          device="cpu", image_size=SIZE,
                          deeplab_size=(33, 65), src_hw=(64, 96),
                          tgt_hw=SIZE)
    json.dumps(out)
    for key in ("metric", "value", "unit", "p50_ms", "p50_ms_per_image",
                "p99_ms", "batch_size", "dtype", "flops_per_image", "mfu",
                "device", "da_training", "models"):
        assert key in out, key
    assert not any("vs_baseline" in k for k in json.dumps(out).split('"'))
    assert out["metric"] == "bisenet_64x128_inference_fps"
    assert out["device"] == "cpu" and out["mfu"] is None
    assert out["p50_ms_per_image"] == out["p50_ms"] / 2
    assert out["da_training"]["value"] > 0
    assert set(out["models"]) == {"deeplab_512x1024_serving",
                                  "da_v2_steps_per_sec"}


def test_io_bench_decodes_on_the_cpu():
    out = io_bench.io_benchmark(n_images=4, hw=SIZE, n_threads=2,
                                repeats=1)
    assert out["pil_fps"] > 0 and out["threaded_fps"] > 0
    assert out["native_available"] is False
    assert out["out_hw"] == list(SIZE)


def test_trace_writes_a_trace_with_the_annotation(tmp_path):
    with trace(str(tmp_path)) as prof:
        with annotate("rtsds_region"):
            torch.ones(64).sum()
    files = glob.glob(os.path.join(tmp_path, "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "rtsds_region" for e in events)
    assert any(e.key == "rtsds_region" for e in prof.key_averages())
