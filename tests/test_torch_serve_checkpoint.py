"""Serving trained checkpoints on the CPU: ``Predictor.from_checkpoint``,
``Predictor.predict_iter`` and the serve CLI, held against the JAX
package's ``Predictor`` on the same weights and frames.

A JAX checkpoint reaches the port as the JAX package's users move it: its
``export_torch`` writes a ``.pth`` the port serves.  Logits agree at rtol
1e-3 / atol 1e-4 (``test_golden_bisenet.py``'s tolerance); masks are equal
wherever the top two logits are more than 1e-3 apart, since a near-tie
may break either way between the libraries.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rtsds_tpu import serve as jax_serve
from rtsds_tpu.callbacks.checkpoint import (
    CheckpointManager as JaxCheckpointManager)
from rtsds_tpu.data.pipeline import decode_image as jax_decode_image
from rtsds_tpu.export_torch import export_checkpoint as jax_export
from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
from rtsds_tpu.ops.preprocess import normalize as jax_normalize
from rtsds_tpu.train.optim import make_optimizer as jax_optimizer
from rtsds_tpu.train.state import create_train_state
from chip_smoke import calibrate_batch_stats
from rtsds_tpu_torch import cli
from rtsds_tpu_torch.data.pipeline import decode_image
from rtsds_tpu_torch.data.synthetic import SyntheticSegDataset
from rtsds_tpu_torch.serve import Predictor, load_checkpoint_state, main
from rtsds_tpu_torch.train.distill import load_teacher
from test_torch_cuda import trained_checkpoint

SIZE = (64, 128)
TIE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def frames():
    ds = SyntheticSegDataset(5, SIZE, seed=0, fixed_tints=True)
    return np.stack([ds[i][0] for i in range(5)])


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory, frames):
    """A Flax BiSeNet-R18 train state saved through the JAX package's
    CheckpointManager with an ``ema`` item: BN statistics calibrated on
    frames as chip_smoke.py does (random ones blow the logits up), the
    EMA's parameters 2% away from the trained ones."""
    state = create_train_state(
        FlaxBiSeNet(num_classes=19), jax.random.key(0),
        jnp.zeros((1, *SIZE, 3)), jax_optimizer("Adam", 1e-4), train=True)
    tree = jax.tree_util.tree_map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats})
    calibrate_batch_stats(tree, frames[:4])
    state = state.replace(batch_stats=tree["batch_stats"])
    rng = np.random.default_rng(3)
    ema = jax.tree_util.tree_map(
        lambda p: np.asarray(p) * (1 + 0.02 * rng.standard_normal(
            p.shape)).astype(np.float32), state.params)
    path = str(tmp_path_factory.mktemp("jax") / "ckpt")
    mgr = JaxCheckpointManager(path, max_to_keep=1)
    mgr.save(0, {"model": state, "ema": {"params": ema}}, monitor=0.5)
    mgr.close()
    return path


def _port_logits(predictor, frames):
    x = torch.from_numpy(np.asarray(jax_normalize(jnp.asarray(
        frames, jnp.float32))))
    with torch.no_grad():
        return predictor.model(x.permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()


def _clear_pixels(logits):
    """Pixels whose top two logits are more than TIE apart."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > TIE


@pytest.mark.parametrize("use_ema", [True, False])
def test_from_checkpoint_matches_jax(jax_checkpoint, frames, tmp_path,
                                     use_ema, record_property):
    """JAX's ``Predictor.from_checkpoint`` and the port's, serving the
    ``.pth`` that JAX's ``export_torch`` wrote of the same checkpoint, in
    float32: logits and masks agree, and the other weight set gives other
    logits (so the ``ema`` item was, or was not, read)."""
    ref = jax_serve.Predictor.from_checkpoint(
        jax_checkpoint, use_ema=use_ema, image_size=SIZE, batch_size=2,
        dtype=jnp.float32)
    exported = {}
    for ema in (True, False):
        exported[ema] = str(tmp_path / f"ema_{ema}.pth")
        jax_export(jax_checkpoint, exported[ema], model="bisenet",
                   use_ema=ema)
    kwargs = dict(image_size=SIZE, batch_size=2, dtype=torch.float32,
                  device="cpu")
    ours = Predictor.from_checkpoint(exported[use_ema], **kwargs)
    other = Predictor.from_checkpoint(exported[not use_ema], **kwargs)

    x = jax_normalize(jnp.asarray(frames[:2], jnp.float32))
    want = np.asarray(ref.model.apply(ref.variables, x, train=False))
    got = _port_logits(ours, frames[:2])
    gap = float(np.abs(got - want).max())
    record_property("max_abs_logit_gap", gap)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    assert np.abs(_port_logits(other, frames[:2]) - want).max() > 1e-2

    masks, ref_masks = ours.predict(frames), ref.predict(frames)
    clear = _clear_pixels(np.concatenate([want, _port_logits(
        ours, frames[2:])]))
    record_property("tied_pixels", int((~clear).sum()))
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(masks[clear], ref_masks[clear])
    assert len(np.unique(ref_masks)) > 1


def _tiny_config(tmp_path, training, extra=""):
    path = tmp_path / "config.yaml"
    path.write_text(f"""
device: cpu
data:
  cityscapes: {{image_size: "32, 64", batch_size: 2, num_workers: 2}}
  gta5_modified: {{image_size: "40, 72", batch_size: 2, num_workers: 2}}
training:
{training}
callbacks:
  model_checkpoint: {{save_dir: "{tmp_path}/ckpt", save_name: "m",
                     save_best: false, save_freq: 1}}
  images_plots: null
{extra}
""")
    return str(path)


def test_from_checkpoint_serves_the_ports_own_checkpoints(tmp_path):
    """Directories the port's CLI wrote: a supervised run with an EMA (the
    best epoch's ``ema`` item beats the latest epoch) and a DA run's
    ``generator``.  The served tensors are exactly ``load_teacher``'s."""
    config = _tiny_config(
        tmp_path, "  segmentation: {epochs: 2, do_validation: 1, "
                  "ema: {enabled: true}}")
    cli.main(["--config", config, "--synthetic"])
    run = tmp_path / "ckpt" / "m"
    # the first epoch is made the best, so best and latest differ
    (run / "metrics.json").write_text(json.dumps({"0": 0.9, "1": 0.1}))
    saved = {e: torch.load(run / f"epoch_{e}.pt", weights_only=True)
             for e in (0, 1)}
    kwargs = dict(image_size=(32, 64), batch_size=2, dtype=torch.float32,
                  device="cpu")
    for use_ema in (True, False):
        want = load_teacher(str(run), use_ema=use_ema)
        served = Predictor.from_checkpoint(
            str(run), use_ema=use_ema, **kwargs).model.state_dict()
        assert set(served) == set(want)
        for k, v in served.items():
            assert torch.equal(v, want[k]), k
        epoch0 = dict(saved[0]["model"]["model"])
        if use_ema:
            epoch0.update(saved[0]["ema"]["params"])
        for k, v in epoch0.items():
            assert torch.equal(served[k], v), k
    latest = saved[1]["ema"]["params"]
    assert any(not torch.equal(served[k], v) for k, v in latest.items())

    config = _tiny_config(
        tmp_path, "  domain_adaptation: {epochs: 1, iterations: 2, "
                  "do_validation: 1}")
    cli.main(["--config", config, "--synthetic", "--domain_adaptation"])
    run = tmp_path / "ckpt" / "m_da"
    generator = torch.load(run / "epoch_0.pt",
                           weights_only=True)["generator"]["model"]
    served = Predictor.from_checkpoint(str(run), **kwargs).model.state_dict()
    assert set(served) == set(generator)
    for k, v in served.items():
        assert torch.equal(v, generator[k]), k


def test_state_and_variables_are_exclusive(tmp_path):
    state = load_checkpoint_state(trained_checkpoint(tmp_path / "ckpt"))
    with pytest.raises(ValueError, match="not both"):
        Predictor(variables={"params": {}}, state=state, image_size=SIZE,
                  device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        load_checkpoint_state(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        Predictor.from_checkpoint(str(tmp_path / "missing"),
                                  image_size=SIZE, device="cpu")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    path = trained_checkpoint(tmp_path_factory.mktemp("port") / "ckpt")
    return path, Predictor.from_checkpoint(
        path, image_size=SIZE, batch_size=2, dtype=torch.float32,
        device="cpu")


@pytest.mark.parametrize("sizes", [
    [2, 2, 2],          # full batches
    [2, 2, 1],          # a short last batch
    [None, None, 1],    # single (H, W, 3) frames, then a batch of one
])
def test_predict_iter_equals_predict(served, frames, sizes):
    _, predictor = served
    batches, start = [], 0
    for n in sizes:
        batches.append(frames[start] if n is None
                       else frames[start:start + n])
        start += n or 1
    got = list(predictor.predict_iter(iter(batches)))
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        # a single frame comes back as a batch of one, as in JAX
        b = b if b.ndim == 4 else b[None]
        assert g.dtype == np.int32 and g.shape == (len(b), *SIZE)
        np.testing.assert_array_equal(g, predictor.predict(b))


def test_predict_iter_refuses_a_larger_batch_as_jax_does(served, frames):
    _, predictor = served
    ref = jax_serve.Predictor(
        variables=FlaxBiSeNet(num_classes=19).init(
            jax.random.key(0), jnp.zeros((1, *SIZE, 3)), train=False),
        image_size=SIZE, batch_size=2, dtype=jnp.float32)
    messages = []
    for p in (predictor, ref):
        with pytest.raises(ValueError) as e:
            list(p.predict_iter(iter([frames[:3]])))
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    assert "stream batches must be <= compiled batch 2, got 3" in messages[0]


def test_serve_cli_serves_a_checkpoint_and_resizes(served, frames, tmp_path,
                                                   capsys):
    """A PNG at another size than ``--size`` is resized on the host (within
    one uint8 level of the JAX package's decode), and the CLI's mask is
    ``from_checkpoint(...).predict(decode_image(path, size))``."""
    path, _ = served
    png = tmp_path / "frame.png"
    Image.fromarray(np.kron(frames[0][::2, ::2], np.ones((3, 3, 1), np.uint8))
                    ).save(png)  # 96x192
    decoded = decode_image(str(png), SIZE)
    ref = jax_decode_image(str(png), SIZE)
    assert decoded.shape == ref.shape == (*SIZE, 3)
    assert np.abs(decoded.astype(int) - ref.astype(int)).max() <= 1

    main([str(png), "--size", "64, 128", "--checkpoint", path, "--out",
          str(tmp_path / "out"), "--device", "cpu"])
    assert "EMA weights" in capsys.readouterr().out
    mask = np.asarray(Image.open(tmp_path / "out" / "frame_mask.png"))
    want = Predictor.from_checkpoint(path, image_size=SIZE, batch_size=1,
                                     device="cpu").predict(decoded)
    np.testing.assert_array_equal(mask, want)

    main([str(png), "--size", "64, 128", "--out", str(tmp_path / "rnd"),
          "--device", "cpu"])
    assert "running from RANDOM init" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main([str(png), "--checkpoint", str(tmp_path / "missing"),
              "--device", "cpu"])


@pytest.mark.parametrize("flag", ["--export", "--artifact", "--mesh",
                                  "--quantize"])
def test_serve_cli_refuses_what_is_not_ported(tmp_path, flag, capsys):
    """``--export``, ``--artifact`` and ``--mesh`` are not ported;
    ``--quantize`` is, and refuses a mode other than int8."""
    with pytest.raises(SystemExit):
        main([str(tmp_path / "f.png"), flag, "x", "--device", "cpu"])
    err = capsys.readouterr().err
    if flag == "--quantize":
        assert "invalid choice: 'x'" in err
    else:
        assert "not yet ported" in err
