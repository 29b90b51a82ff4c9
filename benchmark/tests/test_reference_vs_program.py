"""The reference against the program at a tiny size on the CPU, in
float32: the same weights give the same outputs, to rounding."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import harness, seeds
from benchmark.reference import models, transform
from benchmark.reference.layers import checkpoint_blocks
from benchmark.tests.conftest import DATA, ROOT


REF = {"bisenet_r18": "bisenet", "deeplabv2_r101": "deeplabv2",
       "tiny": "discriminator"}


def program_model(arch):
    from rtsds_tpu_torch.models.bisenet import BiSeNet
    from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2
    from rtsds_tpu_torch.models.discriminator import TinyDomainDiscriminator

    return {"bisenet_r18": lambda: BiSeNet(19, "resnet18"),
            "deeplabv2_r101": lambda: DeepLabV2(19),
            "tiny": lambda: TinyDomainDiscriminator(19)}[arch]()


def pair(arch, seed=3):
    spec = models.network(REF[arch], 19)
    w = seeds.make_weights(spec, seed, "cpu")
    ref = models.loaded(spec, w, "cpu")
    prog = program_model(arch)
    prog.load_state_dict(w)
    return ref, prog


@pytest.mark.parametrize("arch", ["bisenet_r18", "deeplabv2_r101", "tiny"])
def test_state_dict_keys_are_the_programs(arch):
    ref, prog = pair(arch)
    assert list(ref.state_dict()) == list(prog.state_dict())


@pytest.mark.parametrize("arch", ["bisenet_r18", "deeplabv2_r101"])
@pytest.mark.parametrize("train", [False, True])
def test_segmentor_outputs_agree(arch, train):
    ref, prog = pair(arch)
    ref.train(train)
    prog.train(train)
    x = torch.randn(2, 3, 64, 96, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, b = ref(x), prog(x)
    if not train:
        a, b = (a,), (b,)
    for r, p in zip(a, b):
        if r is None:
            assert p is None
            continue
        scale = r.abs().max()
        assert (r - p).abs().max() <= 1e-4 * scale


def test_checkpointed_blocks_give_the_same_gradients():
    spec = models.network("deeplabv2", 19)
    w = seeds.make_weights(spec, 4, "cpu")
    x = torch.randn(2, 3, 48, 48, generator=torch.Generator().manual_seed(2))
    grads = []
    for on in (False, True):
        m = checkpoint_blocks(models.loaded(
            models.network("deeplabv2", 19), w, "cpu"), on).train()
        m(x)[0].square().mean().backward()
        grads.append(torch.cat([p.grad.flatten() for p in m.parameters()]))
    assert torch.allclose(grads[0], grads[1], rtol=1e-5, atol=1e-9)


def test_discriminator_agrees():
    ref, prog = pair("tiny")
    x = torch.rand(2, 19, 32, 64)
    assert torch.allclose(ref(x), prog(x), rtol=1e-5, atol=1e-6)


def test_transform_agrees_with_the_programs():
    from rtsds_tpu_torch.ops.preprocess import make_transform

    frames, colours = seeds.scenes(9, 3, (64, 96), 16, "cpu")
    tf = make_transform((64, 96), 19, decode_label_colors=True)
    image, label = tf(frames, colours)
    assert torch.equal(label, transform.label_ids(colours))
    assert torch.allclose(image, transform.normalize(frames), rtol=0,
                          atol=1e-5)
    # both void colours map to the ignored id
    void = torch.tensor(seeds.PALETTE[19:], dtype=torch.uint8)
    assert (transform.label_ids(void[None, None]) == 19).all()


@pytest.mark.parametrize("cell", ["tiny_bisenet_r18.da_v1",
                                  "tiny_deeplabv2_r101.da_v1"])
def test_da_step_agrees_in_float32(cell, tiny_bench):
    """The tiny cells run the program in float32: its three steps and the
    reference's agree to rounding (Adam's first step moves a parameter by
    about the rate whatever its gradient's size, so a leaf whose gradient
    is within rounding of zero may move another way)."""
    out = harness.run_cell(tiny_bench, cell, 11, 0.5, False, "cpu", 0.0,
                           ROOT, (DATA, harness.HERE))
    c = out["checks"]
    assert c["label_mismatch"]["value"] == 0
    assert c["loss_gap"]["value"] < 1e-4
    assert c["grad_gap_p90"]["value"] < 1e-4
    assert out["counters"]["grad_gap"] < 1e-4
    assert c["change_gap"]["value"] < 2e-2
    assert out["correct"] is True


@pytest.mark.parametrize("cell", ["tiny_bisenet_r18.stream",
                                  "tiny_deeplabv2_r101.stream"])
def test_served_masks_are_the_references_in_float32(cell, tiny_bench):
    out = harness.run_cell(tiny_bench, cell, 12, 0.5, False, "cpu", 0.0,
                           ROOT, (DATA, harness.HERE))
    assert out["checks"]["gap_max"]["value"] < 1e-4
    assert out["checks"]["bad_masks"]["value"] == 0
    assert out["correct"] is True


def test_weights_and_inputs_follow_the_seed():
    spec = models.network("bisenet", 19)
    a = seeds.make_weights(spec, 2 ** 31 + 5, "cpu")
    b = seeds.make_weights(spec, 2 ** 31 + 5, "cpu")
    c = seeds.make_weights(spec, 2 ** 31 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    f1, _ = seeds.scenes(seeds.sub_seed(2 ** 33, 2), 2, (32, 64), 16, "cpu")
    f2, _ = seeds.scenes(seeds.sub_seed(2 ** 33, 2), 2, (32, 64), 16, "cpu")
    assert torch.equal(f1, f2)
    assert seeds.sub_seed(1, 2) != seeds.sub_seed(1, 3)
    assert np.iinfo(np.int64).max >= seeds.sub_seed(2 ** 40, 1) >= 0
