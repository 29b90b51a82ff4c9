"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives a tiny cell on
the CPU (float32, limits of ``data/limits``) with one fault planted in the
program: an answer altered where it is produced, half of the batch left
out, a step that leaves its state unchanged.  (The cells run on one chip:
no exchange between chips to leave out.)"""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import DATA, ROOT


def run(bench, cell, seed=21):
    return harness.run_cell(bench, cell, seed, 0.5, False, "cpu", 0.0, ROOT,
                            (DATA, harness.HERE))


def test_sound_runs_are_correct(tiny_bench):
    assert run(tiny_bench, "tiny_bisenet_r18.stream")["correct"]
    assert run(tiny_bench, "tiny_deeplabv2_r101.da_v1")["correct"]


def test_served_answer_altered(tiny_bench, monkeypatch):
    from rtsds_tpu_torch.serve import Predictor

    masks_on = Predictor._masks_on

    def altered(self, i, frames):
        m = masks_on(self, i, frames).clone()
        m[:, :8] = (m[:, :8] + 1) % self.num_classes
        return m
    monkeypatch.setattr(Predictor, "_masks_on", altered)
    out = run(tiny_bench, "tiny_bisenet_r18.stream")
    assert not out["correct"]
    assert out["checks"]["gap_max"]["value"] > \
        out["checks"]["gap_max"]["limit"]


def test_served_half_batch(tiny_bench, monkeypatch):
    from rtsds_tpu_torch.serve import Predictor

    masks_on = Predictor._masks_on

    def half(self, i, frames):
        n = frames.shape[0] // 2
        m = masks_on(self, i, frames[:n])
        return torch.cat([m, m])[:frames.shape[0]]
    monkeypatch.setattr(Predictor, "_masks_on", half)
    assert not run(tiny_bench, "tiny_bisenet_r18.stream", seed=22)["correct"]


def test_served_id_out_of_range(tiny_bench, monkeypatch):
    from rtsds_tpu_torch.serve import Predictor

    masks_on = Predictor._masks_on

    def wrong(self, i, frames):
        m = masks_on(self, i, frames).clone()
        m[:, 0, 0] = 200
        return m
    monkeypatch.setattr(Predictor, "_masks_on", wrong)
    out = run(tiny_bench, "tiny_deeplabv2_r101.stream")
    assert out["checks"]["bad_masks"]["value"] > 0 and not out["correct"]


def test_training_state_unchanged(tiny_bench, monkeypatch):
    from rtsds_tpu_torch.train import optim

    def no_update(self):
        self.count += 1
    monkeypatch.setattr(optim.ScheduledOptimizer, "step", no_update)
    out = run(tiny_bench, "tiny_deeplabv2_r101.da_v1")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_training_half_batch(tiny_bench, monkeypatch):
    from rtsds_tpu_torch.train import adversarial

    make = adversarial.make_adversarial_step

    def halved(*args, **kwargs):
        step = make(*args, **kwargs)

        def first_half(gen, dis, src, labels, tgt):
            n = src.shape[0] // 2
            return step(gen, dis, src[:n], labels[:n], tgt[:n])
        return first_half
    monkeypatch.setattr(adversarial, "make_adversarial_step", halved)
    out = run(tiny_bench, "tiny_deeplabv2_r101.da_v1")
    assert not out["correct"]
    assert out["checks"]["loss_gap"]["value"] > \
        out["checks"]["loss_gap"]["limit"]


def test_training_label_altered(tiny_bench, monkeypatch):
    from rtsds_tpu_torch.ops import preprocess

    remap = preprocess.rgb_to_train_ids_cuda

    def altered(rgb, table=None):
        ids = remap(rgb, table).clone()
        ids[0, 0, 0] = (ids[0, 0, 0] + 1) % 19
        return ids
    monkeypatch.setattr(preprocess, "rgb_to_train_ids_cuda", altered)
    out = run(tiny_bench, "tiny_bisenet_r18.da_v1")
    assert out["checks"]["label_mismatch"]["value"] >= 1
    assert not out["correct"]
