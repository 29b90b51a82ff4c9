"""The port's quantization-aware fine-tuning (``rtsds_tpu_torch/train/
qat.py``, ``rtsds_tpu_torch/qat.py``) against the JAX package's.

Tolerances:
  * the STEs' values and gradients: exact (JAX eager against the port);
  * the folded tree, the scales, the conv selection of ``prepare_qat``
    and ``export_int8``'s int8 weights: exact;
  * one float32 QAT step (SGD, both packages fed the same batch): the
    loss to rtol 1e-5, every folded parameter after the step within 1e-2
    of its tensor's largest update + 1e-6.  Float32 gradient sums over
    the pixels differ by their order (a bias gradient that cancels over
    16k pixels reads 0.8% of its update apart on DeepLab's layer4), and
    JAX's jitted fake-quant multiplies by the reciprocal of 127 where the
    port and JAX's eager ``quantize_kernel`` divide, so a weight scale can
    differ by one unit in the last place and a weight code within
    rounding of a half step can flip (ROADMAP C).  ``chip_smoke.py`` holds
    the card's step to the CPU's at the same limits;
  * the write-back: exactly JAX's state, re-folding to the tuned tree bit
    for bit, and the model's eval forward on it within 1e-5 of the folded
    walk;
  * the scales sidecar: the same file layout, read back by both.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsds_tpu.ops import quant as jq
from rtsds_tpu.train import qat as jax_qat
from rtsds_tpu.train.optim import make_optimizer as jax_make_optimizer
from rtsds_tpu.train.supervised import make_train_step as jax_train_step
from rtsds_tpu_torch.models import bisenet_int8, deeplab_int8
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2
from rtsds_tpu_torch.models.pretrained import (
    load_segmentor_state, state_dict_from_flax)
from rtsds_tpu_torch.ops import quant as tq
from rtsds_tpu_torch.train import qat
from rtsds_tpu_torch.train.supervised import make_train_step
from test_torch_quant import (
    THIN, flax_bisenet, flax_deeplab, hwio, images, nchw)

HW = (64, 128)
UPDATE_RTOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_fake_quant_kernel_value_and_gradient_match_jax(rng):
    kernel = (rng.normal(size=(3, 3, 16, 24))
              * rng.uniform(0.01, 2.0, 24)).astype(np.float32)
    r = rng.normal(size=kernel.shape).astype(np.float32)
    want = np.asarray(jq.fake_quant_kernel(jnp.asarray(kernel)))
    jgrad = np.asarray(jax.grad(lambda k: jnp.sum(
        jq.fake_quant_kernel(k) * r))(jnp.asarray(kernel)))
    k = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()).requires_grad_()
    got = tq.fake_quant_kernel(k)
    (got * torch.from_numpy(r.transpose(3, 2, 0, 1).copy())).sum().backward()
    np.testing.assert_array_equal(hwio(got), want)
    np.testing.assert_array_equal(hwio(k.grad), jgrad)
    # the serving grid, exactly
    w_q, w_scale = tq.quantize_kernel(k.detach())
    assert torch.equal(got.detach(),
                       w_q.float() * w_scale.reshape(-1, 1, 1, 1))


def test_fake_quant_act_value_and_gradient_match_jax(rng):
    scale = 0.05
    x = np.concatenate([[-10.0, -0.3, -0.025, 0.0, 0.025, 0.3, 10.0,
                         6.35, -6.36]],
                       axis=0).astype(np.float32)
    x = np.concatenate([x, (4 * rng.normal(size=200)).astype(np.float32)])
    want = np.asarray(jq.fake_quant_act(jnp.asarray(x), scale))
    jgrad = np.asarray(jax.grad(lambda v: jnp.sum(
        jq.fake_quant_act(v, scale)))(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_()
    got = tq.fake_quant_act(t, scale)
    got.sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(t.grad.numpy(), jgrad)
    served = tq.quantize_act(torch.from_numpy(x), scale).float() * scale
    assert torch.equal(got.detach(), served)
    assert t.grad[:7].tolist() == [0.0, 1, 1, 1, 1, 1, 0.0]


@pytest.fixture(scope="module", params=["bisenet", "deeplab"])
def preps(request):
    """Both packages' QAT prep of the same weights on the same batch."""
    name = request.param
    variables = flax_bisenet(5) if name == "bisenet" else flax_deeplab(5)
    state = state_dict_from_flax(variables)
    x = images(6)
    jprep = jax_qat.prepare_qat(name, variables, [jnp.asarray(x)])
    tprep = qat.prepare_qat(name, state, [nchw(x)], device="cpu")
    return dict(name=name, variables=variables, state=state, x=x,
                jprep=jprep, tprep=tprep)


def test_prepare_qat_matches_jax(preps):
    j, t = preps["jprep"], preps["tprep"]
    assert t.model_name == j.model_name
    assert t.quant_names == j.quant_names
    assert set(t.folded) == set(j.folded)
    for name, (jk, jb) in j.folded.items():
        tk, tb = t.folded[name]
        assert tk.dtype == torch.float32
        np.testing.assert_array_equal(hwio(tk), np.asarray(jk))
        if jb is not None:
            np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert set(t.act_scales) == set(j.act_scales)
    for name, s in j.act_scales.items():
        assert t.act_scales[name] == pytest.approx(s, rel=2.0 ** -6)


def _shared_prep(p):
    """The port's prep with JAX's scales, so both steps see one grid."""
    return p["tprep"]._replace(act_scales=dict(p["jprep"].act_scales))


def test_qat_step_matches_jax(preps, rng):
    p = preps
    labels = rng.integers(0, 19, (2, *HW)).astype(np.int32)
    labels[:, :2] = 19
    jstate = jax_qat.create_qat_state(p["jprep"],
                                      jax_make_optimizer("SGD", 0.1))
    jstate, jmetrics = jax_train_step(ignore_index=19, donate=False)(
        jstate, jnp.asarray(p["x"]), jnp.asarray(labels))
    tstate = qat.create_qat_state(_shared_prep(p), 0.1, "SGD")
    before = {k: v.detach().clone() for k, v in
              tstate.model.named_parameters()}
    metrics = make_train_step(19)(tstate, torch.from_numpy(p["x"]),
                                  torch.from_numpy(labels))
    assert float(metrics["train_loss"]) == pytest.approx(
        float(jmetrics["train_loss"]), rel=1e-5)
    folded = tstate.model.folded
    worst = 0.0
    for name, (jk, jb) in jstate.params.items():
        for i, (jv, tv) in enumerate(((jk, folded[name][0]),
                                      (jb, folded[name][1]))):
            if jv is None:
                assert tv is None
                continue
            got = tv.detach().numpy()
            ref = np.asarray(jv)
            if got.ndim == 4:
                got = got.transpose(2, 3, 1, 0)
            key = f"{'kernels' if i == 0 else 'biases'}.{name}"
            upd = np.abs(ref - (hwio(before[key]) if got.ndim == 4
                                else before[key].numpy())).max()
            err = np.abs(got - ref).max()
            worst = max(worst, err / (UPDATE_RTOL * upd + 1e-6))
    print(f"{p['name']}: worst update error / limit {worst:.3g}")
    assert worst <= 1.0


def test_qat_step_trains_every_conv(preps):
    p = preps
    state = qat.create_qat_state(p["tprep"], 1e-3)
    labels = torch.randint(0, 19, (2, *HW), generator=torch.Generator()
                           .manual_seed(0))
    before = {k: v.detach().clone() for k, v in
              state.model.named_parameters()}
    make_train_step(19)(state, torch.from_numpy(p["x"]), labels)
    quant = sorted(p["tprep"].quant_names)[0]
    plain = sorted(set(p["tprep"].folded) - p["tprep"].quant_names)[0]
    for name in (quant, plain):
        moved = state.model.kernels[name].detach() - before[f"kernels.{name}"]
        assert moved.abs().max() > 0, name


def test_export_int8_matches_jax_and_the_fake_quant_grid(preps):
    p = preps
    tprep = _shared_prep(p)
    module = qat.export_int8(tprep)
    _, jtree = jax_qat.export_int8(p["jprep"])
    assert set(module.qtree["q8"]) == set(jtree["q8"]) == tprep.quant_names
    for name, (w_q, w_s, x_s, _) in module.qtree["q8"].items():
        jw, js, jx, _ = jtree["q8"][name]
        np.testing.assert_array_equal(hwio(w_q), np.asarray(jw))
        np.testing.assert_array_equal(w_s.numpy(), np.asarray(js))
        assert float(x_s) == float(jx)
        fq = tq.fake_quant_kernel(tprep.folded[name][0])
        assert torch.equal(w_q.float() * w_s.reshape(-1, 1, 1, 1), fq)
    # the fake-quant forward and the real int8 path compute the same
    # function up to accumulation dtypes
    x = nchw(p["x"])
    with torch.no_grad():
        fake = qat.make_qat_apply(tprep)(x)
        real = module(x)
    agree = (fake.argmax(1) == real.float().argmax(1)).float().mean()
    assert agree > 0.95


def test_writeback_matches_jax_and_refolds_exactly(preps, rng):
    p = preps
    name = p["name"]
    # a "tuned" tree: the folded one moved a little
    tuned = {n: (k + 0.01 * torch.from_numpy(
        rng.normal(size=k.shape).astype(np.float32)),
        None if b is None else b + 0.1)
        for n, (k, b) in p["tprep"].folded.items()}
    jtuned = {n: (jnp.asarray(hwio(k)),
                  None if b is None else jnp.asarray(b.numpy()))
              for n, (k, b) in tuned.items()}
    written = qat.writeback(name, p["state"], tuned)
    want = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, jax_qat.writeback(name, p["variables"], jtuned)))
    assert set(want) <= set(written)
    for k, v in want.items():
        np.testing.assert_array_equal(written[k].numpy(), v.numpy(),
                                      err_msg=k)
    fold = (bisenet_int8.fold_bisenet if name == "bisenet"
            else deeplab_int8.fold_deeplab)
    refold = fold(written)
    assert set(refold) == set(tuned)
    for n, (k, b) in tuned.items():
        assert torch.equal(refold[n][0], k), n
        assert (b is None and refold[n][1] is None) or torch.equal(
            refold[n][1], b), n
    # the model's eval forward (ATen's eval BN) on the written-back state
    # is the folded walk
    model = BiSeNet() if name == "bisenet" else DeepLabV2(layers=THIN)
    model = load_segmentor_state(model, written).eval()
    walk = (bisenet_int8.bisenet_bf16_apply if name == "bisenet"
            else deeplab_int8.deeplab_bf16_apply)
    x = nchw(p["x"])
    with torch.no_grad():
        torch.testing.assert_close(model(x), walk(written, x,
                                                  dtype=torch.float32),
                                   rtol=1e-5, atol=1e-5)
    # the input is not modified; train-only heads and counters pass
    for k, v in p["state"].items():
        if k.startswith("supervision") or k.endswith("num_batches_tracked"):
            assert torch.equal(written[k], v)


def test_scales_sidecar_round_trips_between_the_packages(preps, tmp_path):
    prep = preps["tprep"]
    path = qat.save_act_scales(str(tmp_path), prep, "percentile", 99.5)
    assert os.path.basename(path) == qat.SCALES_SIDECAR == \
        jax_qat.SCALES_SIDECAR
    scales, meta = qat.load_act_scales(str(tmp_path))
    assert scales == {k: float(v) for k, v in prep.act_scales.items()}
    assert meta == {"model": preps["name"], "calib_stat": "percentile",
                    "calib_percentile": 99.5}
    assert jax_qat.load_act_scales(str(tmp_path)) == (scales, meta)
    jdir = tmp_path / "jax"
    jdir.mkdir()
    jax_qat.save_act_scales(str(jdir), preps["jprep"], "max", 99.9)
    assert (json.loads((jdir / qat.SCALES_SIDECAR).read_text()).keys()
            == json.loads(open(path).read()).keys())
    assert qat.load_act_scales(str(jdir))[0] == \
        jax_qat.load_act_scales(str(jdir))[0]
    assert qat.load_act_scales(str(tmp_path / "none")) is None


def test_qat_cli_end_to_end(tmp_path, capsys):
    """``python -m rtsds_tpu_torch.qat`` over a Cityscapes-layout PNG tree:
    fine-tune a port checkpoint, write the serving checkpoint and its
    sidecar, and serve it in bf16 and in int8 from the sidecar's scales."""
    from realdata_fixtures import make_cityscapes_tree

    from rtsds_tpu_torch.callbacks.checkpoint import CheckpointManager
    from rtsds_tpu_torch.qat import main
    from rtsds_tpu_torch.serve import Predictor
    from rtsds_tpu_torch.train.optim import make_optimizer
    from rtsds_tpu_torch.train.state import TrainState

    dirs = make_cityscapes_tree(str(tmp_path / "cs"), n_train=4, n_val=1,
                                disk_size=(48, 96))
    model = BiSeNet()
    ckpt = str(tmp_path / "ckpt")
    CheckpointManager(ckpt).save(1, {"model": TrainState(
        model, make_optimizer("Adam", model.parameters(), 0.01))},
        monitor=0.5)
    out = str(tmp_path / "ckpt_qat")
    main(["--checkpoint_dir", ckpt, "--images", dirs["images_train_dir"],
          "--labels", dirs["segmentation_train_dir"], "--out", out,
          "--model", "bisenet", "--size", f"{HW[0]}, {HW[1]}",
          "--batch", "2", "--steps", "3", "--lr", "1e-4",
          "--calib_batches", "1", "--device", "cpu"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["steps"] == 3 and stats["quantized_convs"] > 0
    assert np.isfinite(stats["final_loss"]) and stats["samples"] == 4
    assert os.path.basename(stats["scales_sidecar"]) == qat.SCALES_SIDECAR
    frames = np.zeros((2, *HW, 3), np.uint8)
    plain = Predictor.from_checkpoint(out, image_size=HW, batch_size=2,
                                      device="cpu")
    assert plain.predict(frames).shape == (2, *HW)
    q = Predictor.from_checkpoint(out, image_size=HW, batch_size=2,
                                  quantize="int8", device="cpu")
    assert q.act_scales == qat.load_act_scales(out)[0]
    assert q.predict(frames).shape == (2, *HW)
    with pytest.raises(SystemExit, match="no paired"):
        main(["--checkpoint_dir", ckpt, "--images", str(tmp_path),
              "--labels", str(tmp_path / "none"), "--out", out,
              "--device", "cpu"])
