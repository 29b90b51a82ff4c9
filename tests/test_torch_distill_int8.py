"""The int8 distillation teacher (``train/distill.py:quantize_teacher`` and
the CLI's ``distillation.teacher.quantize: int8``) against the JAX
package's.

Tolerances:
  * the teacher's int8 weights and its conv selection: exact; its scales
    within 2^-6 relative (a bf16 calibration forward on both sides);
  * the teacher's soft targets (softmax at T = 2) on the same scales: mean
    absolute difference below 2e-3 and at most 0.05 anywhere (both walks
    run in bf16, whose rounding differs between XLA and ATen);
  * the step's distillation loss: exactly ``distillation_kl`` of the
    student's output and the int8 teacher's, recomputed apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsds_tpu.train import distill as jax_distill
from rtsds_tpu_torch import cli
from rtsds_tpu_torch.callbacks.checkpoint import CheckpointManager
from rtsds_tpu_torch.config import load_config
from rtsds_tpu_torch.models.pretrained import state_dict_from_flax
from rtsds_tpu_torch.ops.quant import QuantizedSegmentor
from rtsds_tpu_torch.train import distill
from rtsds_tpu_torch.train.factory import make_segmentor
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.state import TrainState
from test_torch_cli import _segmentation
from test_torch_quant import flax_deeplab, hwio, images, nchw


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def teachers():
    variables = flax_deeplab(11)
    x = images(12)
    j_apply, jtree = jax_distill.quantize_teacher("deeplab", variables,
                                                  [jnp.asarray(x)])
    teacher = distill.quantize_teacher(
        "deeplab", state_dict_from_flax(variables), [nchw(x)], device="cpu")
    return {"variables": variables, "x": x, "j_apply": j_apply,
            "jtree": jtree, "teacher": teacher}


def test_quantize_teacher_matches_jax(teachers):
    t = teachers["teacher"]
    assert isinstance(t, QuantizedSegmentor) and not list(t.parameters())
    jtree = teachers["jtree"]
    assert set(t.qtree["q8"]) == set(jtree["q8"])
    assert set(t.qtree["bf16"]) == set(jtree["bf16"])
    for name, (jw, js, jx, _) in jtree["q8"].items():
        w, s, xs, _ = t.qtree["q8"][name]
        np.testing.assert_array_equal(hwio(w), np.asarray(jw))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        assert float(xs) == pytest.approx(float(jx), rel=2.0 ** -6)


def test_int8_soft_targets_match_jax(teachers):
    """On JAX's scales, the two int8 teachers' soft targets agree."""
    from rtsds_tpu_torch.models.deeplab_int8 import build_quantized, make_walk

    jtree = teachers["jtree"]
    scales = {n: float(e[2]) for n, e in jtree["q8"].items()}
    state = state_dict_from_flax(teachers["variables"])
    tree = build_quantized(state, scales)
    t = QuantizedSegmentor(make_walk([*tree["q8"], *tree["bf16"]]), tree)
    want = np.asarray(teachers["j_apply"](jtree, jnp.asarray(teachers["x"]))
                      .astype(jnp.float32))
    with torch.no_grad():
        got = t(nchw(teachers["x"])).float().numpy().transpose(0, 2, 3, 1)

    def soft(z):
        z = z / 2.0
        e = np.exp(z - z.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    gap = np.abs(soft(got) - soft(want))
    assert gap.mean() < 2e-3 and gap.max() < 0.05, (gap.mean(), gap.max())


def test_distill_step_takes_the_int8_teacher(teachers):
    """The step casts the input to the teacher's declared bf16, runs it
    outside the student's autocast, and its distillation loss is the KL
    of the student's output from the int8 teacher's."""
    config = load_config()
    student, _ = make_segmentor(config, "bisenet", seed=3)
    state = TrainState(student, make_optimizer(
        "SGD", student.parameters(), 0.0))
    x = torch.from_numpy(teachers["x"])
    labels = torch.randint(0, 19, x.shape[:3],
                           generator=torch.Generator().manual_seed(1))
    step = distill.make_distill_step(teachers["teacher"], 19)
    metrics = step(state, x, labels)
    with torch.no_grad():
        t_out = teachers["teacher"](x.permute(0, 3, 1, 2))
        s_out = student.train()(x.permute(0, 3, 1, 2))[0]
    want = distill.distillation_kl(s_out, t_out)
    assert float(metrics["loss_distill"]) == pytest.approx(float(want),
                                                           rel=1e-6)
    assert t_out.dtype == torch.bfloat16


def test_quantize_teacher_refuses_an_unknown_model():
    with pytest.raises(ValueError, match="no int8 path for model 'fcn'"):
        distill.quantize_teacher("fcn", {}, [], device="cpu")


def test_cli_distils_from_an_int8_teacher(tmp_path, monkeypatch):
    """``distillation.teacher.quantize: int8`` through ``cli.main``: the
    teacher is quantized once on ``calib_batches`` training batches, then
    the loader is rewound, so epoch 0 trains on the batches an unquantized
    run trains on; ``--validate_only`` skips the quantization."""
    teacher_dir = tmp_path / "teacher"
    model, _ = make_segmentor(load_config(), "bisenet", seed=7)
    CheckpointManager(str(teacher_dir)).save(0, {"model": TrainState(
        model, make_optimizer("SGD", model.parameters(), 0.01))},
        monitor=0.5)
    made, seen = [], {}
    quantize = distill.quantize_teacher
    make_step = distill.make_distill_step

    def spy_quantize(name, state, calib, **kwargs):
        calib = list(calib)
        made.append(len(calib))
        return quantize(name, state, calib, **kwargs)

    def spy_step(teacher, *args, **kwargs):
        step = make_step(teacher, *args, **kwargs)
        kind = "int8" if isinstance(teacher, QuantizedSegmentor) else "bf16"
        seen[kind] = []

        def run(state, images, labels):
            seen[kind].append(int(labels.sum()))
            return step(state, images, labels)
        return run

    monkeypatch.setattr(distill, "quantize_teacher", spy_quantize)
    monkeypatch.setattr(distill, "make_distill_step", spy_step)
    for quant in ("int8", "null"):
        config = _segmentation(
            tmp_path, f"distillation: {{enabled: true, teacher: {{model: "
                      f"bisenet, checkpoint_dir: '{teacher_dir}', quantize: "
                      f"{quant}, calib_batches: 2}}}}", epochs=1)
        history = cli.main(["--config", config, "--synthetic", "--dataset",
                            "gta5"])
        assert len(history) == 1
    assert made == [2]
    assert seen["int8"] == seen["bf16"] and len(seen["int8"]) > 1
    config = _segmentation(
        tmp_path, f"distillation: {{enabled: true, teacher: {{model: "
                  f"bisenet, checkpoint_dir: '{teacher_dir}', quantize: "
                  f"int8}}}}", epochs=1)
    miou = cli.main(["--config", config, "--synthetic", "--validate_only"])
    assert 0.0 <= miou <= 1.0 and made == [2]


def test_int8_teacher_on_bands_equals_one_device(teachers):
    """The int8 teacher on 2 height bands (its walk with a banded conv op,
    as spatial serving runs it): its logits equal the whole frame's, and
    a float64 student's distillation step on the bands equals the step on
    one device at rtol 1e-9 / atol 1e-12, its loss the KL of the banded
    outputs."""
    from rtsds_tpu_torch.parallel.spatial import gather, split_batch

    teacher = teachers["teacher"]
    x = torch.from_numpy(teachers["x"])
    labels = torch.randint(0, 19, x.shape[:3],
                           generator=torch.Generator().manual_seed(1))
    frames, bands = split_batch(x, labels, ["cpu"] * 2)
    with torch.no_grad():
        whole = teacher(x.permute(0, 3, 1, 2))
        banded = teacher(frames.permute(0, 3, 1, 2))
    assert banded.dtype == torch.bfloat16
    assert torch.equal(gather(banded), whole)

    config = load_config()
    student, _ = make_segmentor(config, "bisenet", seed=3)
    runs = []
    for images, lab in ((x.double(), labels), (frames.to(torch.float64),
                                               bands)):
        model = student.__class__().double()
        model.load_state_dict(student.state_dict())
        state = TrainState(model, make_optimizer("SGD", model.parameters(),
                                                 0.01))
        metrics = distill.make_distill_step(teacher, 19)(state, images, lab)
        runs.append(({k: float(v) for k, v in metrics.items()},
                     {k: v.numpy() for k, v in model.state_dict().items()}))
    (one, one_sd), (got, got_sd) = runs
    for k in one:
        np.testing.assert_allclose(got[k], one[k], rtol=1e-9, atol=1e-12,
                                   err_msg=k)
    for k in one_sd:
        np.testing.assert_allclose(got_sd[k], one_sd[k], rtol=1e-9,
                                   atol=1e-12, err_msg=k)
