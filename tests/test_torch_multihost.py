"""The port's data axis over processes: the multi-process loader against
the JAX package's, and ``python -m rtsds_tpu_torch.cli --multihost`` on two
CPU processes (gloo).

* ``MultiHostDataLoader``: the same per-rank index shards as
  ``rtsds_tpu.data.multihost.MultiHostDataLoader`` for the same seed, for
  each ``process_index``; the shards of a pass are disjoint and cover its
  global batches; a resume skips global groups (the ragged tail too); a
  global batch that does not divide is refused with JAX's message; under
  a K-step accumulation the ranks' k-th micro-batches make up JAX's
  micro-batch k of the same global batch, and through the CLI (with
  RandomZoom) they hold exactly the one-process run's.
* The CLI on two ranks (``device: cpu``, the ``RTSDS_*`` variables): both
  ranks report the same metrics and mIoU, only rank 0 writes, ``--resume``
  continues on both, SIGTERM to one rank saves the emergency checkpoint and
  ends both at one step, and what is refused (the pipe with several
  processes; the JAX CLI's refusals of self-training and distillation)
  exits before the process group is joined.

This module also holds the rank workers of test_torch_parallel.py and
test_torch_pipelined.py: a spawned child imports it, and it imports no JAX
at module level.  Every multi-process case runs under
``parallel/launch.py:run_ranks``, which kills its children and fails after
its own timeout (at most 60 s here).
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

from rtsds_tpu_torch import cli
from rtsds_tpu_torch.data.multihost import MultiHostDataLoader
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2, frozen_bn_parameters
from rtsds_tpu_torch.models.discriminator import TinyDomainDiscriminator
from rtsds_tpu_torch.parallel.distributed import (
    GlobalBatchNorm2d, convert_global_batchnorm, shard_positions,
    world_size)
from rtsds_tpu_torch.parallel.launch import run_ranks
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.state import TrainState

TIMEOUT_S = 60
THIN = (1, 1, 1, 1)


# --- rank workers (also driven by test_torch_parallel.py) ---------------

def shard(rank: int, world: int, arr):
    n = len(arr) // world
    return arr[rank * n:(rank + 1) * n]


def make_model(kind: str) -> torch.nn.Module:
    """``bisenet`` (R18) or ``deeplab`` (thin), float64."""
    if kind == "bisenet":
        return BiSeNet().double()
    return DeepLabV2(layers=THIN).double()


def load(model: torch.nn.Module, state: dict) -> torch.nn.Module:
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def numpy_state(model: torch.nn.Module) -> dict:
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def train_state(kind: str, state: dict, momentum: float = 0.9,
                lr: float = 0.01) -> TrainState:
    model = load(make_model(kind), state)
    if world_size() > 1:
        convert_global_batchnorm(model)
    frozen = frozen_bn_parameters(model) if kind == "deeplab" else []
    return TrainState(model, make_optimizer("SGD", model.parameters(), lr,
                                            momentum=momentum,
                                            frozen=frozen))


def metrics_of(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items() if k != "preempted"}


def bn_worker(rank, world, x, weight_grad_of_y, device="cpu"):
    """Global-batch BN on this rank's shard, on ``device``: the output, the
    running statistics, and the input's and the affine's gradients of
    ``sum(y * weight_grad_of_y)``."""
    bn = GlobalBatchNorm2d(x.shape[1]).double()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator()
                           .manual_seed(1))
        bn.bias.uniform_(-0.5, 0.5, generator=torch.Generator()
                         .manual_seed(2))
    bn.to(device)
    xs = torch.from_numpy(shard(rank, world, x)).to(device) \
        .requires_grad_(True)
    y = bn(xs)
    (y * torch.from_numpy(shard(rank, world, weight_grad_of_y)).to(device)) \
        .sum().backward()
    return {k: v.detach().cpu().numpy() for k, v in (
        ("y", y), ("x_grad", xs.grad), ("weight_grad", bn.weight.grad),
        ("bias_grad", bn.bias.grad), ("running_mean", bn.running_mean),
        ("running_var", bn.running_var))} | {
        "count": int(bn.num_batches_tracked)}


def supervised_worker(rank, world, cases):
    """One step of each case ``{name: (kind, state, images, labels,
    accumulate K)}`` on this rank's share of the global batch: its metrics
    and the state after."""
    from rtsds_tpu_torch.train.accumulate import (
        make_accumulating_train_step, split_microbatches)
    from rtsds_tpu_torch.train.supervised import make_train_step

    out = {}
    for name, (kind, state, images, labels, k) in cases.items():
        st = train_state(kind, state)
        # this rank's share of the global batch, laid out as the loader
        # lays it out for K micro-batches (data/multihost.py)
        positions = shard_positions(len(images), rank, world, k)
        x = torch.from_numpy(images[positions])
        y = torch.from_numpy(labels[positions])
        if k > 1:
            got = make_accumulating_train_step(19)(
                st, split_microbatches(x, k), split_microbatches(y, k))
        else:
            got = make_train_step(19)(st, x, y)
        out[name] = (metrics_of(got), numpy_state(st.model))
    return out


def da_worker(rank, world, gen_state, dis_state, batch, variants):
    """One DA step of each variant ``{name: make_adversarial_step
    kwargs}`` from the same G and D on this rank's shards: its metrics
    and both states after."""
    from rtsds_tpu_torch.train.adversarial import make_adversarial_step

    src, labels, tgt = (torch.from_numpy(shard(rank, world, a))
                        for a in batch)
    out = {}
    for name, kwargs in variants.items():
        gen = train_state("bisenet", gen_state, momentum=0.0, lr=0.01)
        dis_model = load(TinyDomainDiscriminator().double(), dis_state)
        dis = TrainState(dis_model, make_optimizer(
            "SGD", dis_model.parameters(), 0.02, momentum=0.0))
        got = make_adversarial_step(**kwargs)(gen, dis, src, labels, tgt)
        out[name] = (metrics_of(got), numpy_state(gen.model),
                     numpy_state(dis.model))
    return out


def validate_worker(rank, world, state, batches, protocols):
    """Validation of this rank's shards of ``batches`` under each protocol
    (``plain``, ``sliding``, ``ensemble``): this rank's own matrix, the
    all-reduced one ``validate`` reads, and its mIoU."""
    from rtsds_tpu_torch.eval import validate as val_mod
    from rtsds_tpu_torch.eval.ensemble import make_ensemble_eval_step
    from rtsds_tpu_torch.eval.sliding import make_sliding_eval_step
    from rtsds_tpu_torch.eval.validate import make_eval_step, validate

    model = load(BiSeNet(), state).eval()
    size = batches[0][0].shape[1:3]
    steps = {"plain": make_eval_step(model, 19),
             "sliding": make_sliding_eval_step(
                 model, size, 19, window=(size[0], size[1] // 2)),
             "ensemble": make_ensemble_eval_step(model, size, 19,
                                                 scales=(0.75, 1.0))}
    out = {}
    for name in protocols:
        seen = {}
        reduce = val_mod.global_sum

        def spy(hist, seen=seen, reduce=reduce):
            seen["local"] = hist.numpy().copy()
            seen["global"] = reduce(hist).numpy()
            return torch.from_numpy(seen["global"])

        val_mod.global_sum = spy
        try:
            miou, _ = validate(
                model, [(torch.from_numpy(shard(rank, world, x)),
                         torch.from_numpy(shard(rank, world, y)))
                        for x, y in batches], 19, eval_step=steps[name],
                device="cpu")
        finally:
            val_mod.global_sum = reduce
        out[name] = (seen["local"], seen["global"], miou)
    return out


def cli_inputs_worker(rank, world, argv):
    """``cli.main(argv)`` (with ``--multihost`` on several ranks), the
    images and labels of every training step as this rank's step got
    them."""
    seen = []
    build = cli.supervised_train_step

    def recording(*args, **kwargs):
        step = build(*args, **kwargs)

        def recorded(state, images, labels):
            seen.append((images.numpy().copy(), labels.numpy().copy()))
            return step(state, images, labels)
        return recorded

    cli.supervised_train_step = recording
    try:
        cli.main([*argv, "--multihost"] if world > 1 else argv)
    finally:
        cli.supervised_train_step = build
    return seen


def cli_worker(rank, world, argv, sigterm_at_step=None):
    """``cli.main(argv + ["--multihost"])`` on this rank, recording which
    ranks wrote checkpoints; ``sigterm_at_step`` sends this rank SIGTERM
    after that step of the first epoch (rank 1 only)."""
    from rtsds_tpu_torch.callbacks import checkpoint as ckpt_mod
    from rtsds_tpu_torch.callbacks.base import Callback

    writes = []
    save = ckpt_mod.CheckpointManager.save

    def recorded_save(self, step, *args, **kwargs):
        writes.append(int(step))
        return save(self, step, *args, **kwargs)

    ckpt_mod.CheckpointManager.save = recorded_save
    build = cli.build_callbacks
    if sigterm_at_step is not None and rank == 1:
        class _Term(Callback):
            def on_batch_end(self, batch, logs=None):
                if batch == sigterm_at_step:
                    os.kill(os.getpid(), signal.SIGTERM)

        def with_term(*args, **kwargs):
            callbacks, checkpoint = build(*args, **kwargs)
            return [*callbacks, _Term()], checkpoint
        cli.build_callbacks = with_term
    try:
        result = cli.main([*argv, "--multihost"])
    finally:
        ckpt_mod.CheckpointManager.save = save
        cli.build_callbacks = build
    return result, writes


# --- the loader against the JAX package's -------------------------------

class _Indices:
    """A dataset whose samples are their indices."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((1, 1, 3), i, np.uint8), np.full((1, 1), i, np.int32)


@pytest.mark.parametrize("n,global_batch,pc,shuffle,drop_last", [
    (16, 4, 2, True, True), (17, 4, 2, True, False), (13, 6, 3, False, False),
    (12, 4, 4, True, True), (10, 8, 2, True, False)])
def test_loader_shards_match_jax(n, global_batch, pc, shuffle, drop_last):
    from rtsds_tpu.data.multihost import MultiHostDataLoader as JaxLoader

    shards = []
    for pi in range(pc):
        kwargs = dict(global_batch_size=global_batch, shuffle=shuffle,
                      num_workers=1, seed=5, drop_last=drop_last,
                      process_index=pi, process_count=pc)
        got = MultiHostDataLoader(_Indices(n), **kwargs)
        want = JaxLoader(_Indices(n), **kwargs)
        assert len(got) == len(want)
        for epoch in (0, 1):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            g = [c.tolist() for c in got._batch_indices()]
            w = [c.tolist() for c in want._batch_indices()]
            assert g == w
        got.set_epoch(0)
        shards.append([labels[:, 0, 0].tolist() for _, labels in got])
    # one pass: disjoint shards that cover the pass's global batches
    flat = [i for rank in shards for batch in rank for i in batch]
    assert len(flat) == len(set(flat))
    covered = n if not drop_last else n - n % global_batch
    assert len(flat) == covered
    assert all(len(b) == global_batch // pc for rank in shards
               for b in rank[:n // global_batch])


def test_resume_skips_global_groups_on_a_ragged_tail():
    from rtsds_tpu.data.multihost import MultiHostDataLoader as JaxLoader

    # 10 samples, global batch 4 over 2 ranks: groups of 4, 4 and 2; the
    # tail gives rank 1 nothing, so the ranks' batch counts differ
    for pi in (0, 1):
        kwargs = dict(global_batch_size=4, shuffle=True, num_workers=1,
                      seed=9, drop_last=False, process_index=pi,
                      process_count=2)
        got = MultiHostDataLoader(_Indices(10), **kwargs)
        want = JaxLoader(_Indices(10), **kwargs)
        full = [c.tolist() for c in got._batch_indices()]
        got.set_epoch(0)
        got.skip_batches(2)
        want.skip_batches(2)
        resumed = [c.tolist() for c in got._batch_indices()]
        assert resumed == [c.tolist() for c in want._batch_indices()]
        assert resumed == full[2:]
        assert len(full) == (3 if pi == 0 else 2)


@pytest.mark.parametrize("pc,k", [(2, 2), (2, 4), (4, 2)])
def test_micro_batch_shares_make_jax_micro_batches(pc, k):
    """Under a K-step accumulation, rank r's k-th micro-batch is its part
    of the JAX package's micro-batch k of the same global batch: the ranks'
    k-th micro-batches, side by side, are JAX's split of the one-process
    global batch."""
    from rtsds_tpu.data.multihost import MultiHostDataLoader as JaxLoader

    global_batch = 16
    want = [c for c in JaxLoader(_Indices(40), global_batch, seed=4,
                                 num_workers=1, process_index=0,
                                 process_count=1)._batch_indices()]
    ranks = [list(MultiHostDataLoader(
        _Indices(40), global_batch, seed=4, num_workers=1, process_index=r,
        process_count=pc, micro_batches=k)._batch_indices())
        for r in range(pc)]
    assert len(want) == 2 and all(len(r) == 2 for r in ranks)
    for b, g in enumerate(want):
        got = np.concatenate([r[b].reshape(k, -1) for r in ranks], axis=1)
        np.testing.assert_array_equal(got, g.reshape(k, -1))


def test_micro_batch_shares_need_whole_global_batches():
    with pytest.raises(ValueError, match="does not split into 4 "
                                         "micro-batches over 2 processes"):
        MultiHostDataLoader(_Indices(8), 12, process_index=0,
                            process_count=2, micro_batches=4)
    with pytest.raises(ValueError, match="needs drop_last"):
        MultiHostDataLoader(_Indices(8), 4, process_index=0,
                            process_count=2, micro_batches=2,
                            drop_last=False)


def test_a_global_batch_that_does_not_divide_is_refused():
    from rtsds_tpu.data.multihost import MultiHostDataLoader as JaxLoader

    for cls in (MultiHostDataLoader, JaxLoader):
        with pytest.raises(ValueError, match="global batch 6 must divide "
                                             "evenly over 4 processes"):
            cls(_Indices(8), 6, process_index=0, process_count=4)


# --- the CLI on two processes ------------------------------------------

def _config(tmp_path, extra: str = "") -> str:
    path = tmp_path / "config.yaml"
    path.write_text(f"""
device: cpu
data:
  cityscapes: {{image_size: "32, 64", batch_size: 2, num_workers: 1}}
  gta5_modified: {{image_size: "32, 64", batch_size: 4, num_workers: 1}}
training:
  segmentation: {{epochs: 1, do_validation: 1}}
  domain_adaptation: {{epochs: 1, iterations: 2, do_validation: 1}}
callbacks:
  model_checkpoint: {{save_dir: "{tmp_path}/ckpt", save_name: "m",
                     save_best: false, save_freq: 1}}
{extra}
""")
    return str(path)


def _cli(argv, sigterm_at_step=None):
    return run_ranks(cli_worker, 2, (argv, sigterm_at_step), backend=None,
                     timeout_s=TIMEOUT_S)


def _same(a, b):
    """The ranks' histories agree, all but the host's own step rate."""
    def drop(h):
        return [{k: v for k, v in e.items() if k != "steps_per_sec"}
                for e in h]
    assert json.dumps(drop(a), sort_keys=True) == json.dumps(drop(b),
                                                             sort_keys=True)


def test_cli_gives_each_rank_its_share_of_the_micro_batches(tmp_path):
    """``accumulate_steps: 2`` with RandomZoom on 2 ranks: at every step
    the ranks' k-th micro-batches, side by side, are the one-process run's
    micro-batch k, augmented alike, exactly."""
    argv = ["--config", _config_with(tmp_path, {
        "training": {"segmentation": {"accumulate_steps": 2}},
        "augmentation": {"RandomZoom": {"max": 1.5, "p": 0.5}}}),
        "--synthetic", "--dataset", "gta5", "--augmented"]
    ranks = run_ranks(cli_inputs_worker, 2, (argv,), backend=None,
                      timeout_s=TIMEOUT_S)
    one = cli_inputs_worker(0, 1, argv)
    assert len(one) == len(ranks[0]) == len(ranks[1]) == 4
    for step, want in enumerate(one):
        for j, w in enumerate(want):  # images, labels
            got = np.concatenate([r[step][j].reshape(2, 1, *w.shape[1:])
                                  for r in ranks], axis=1)
            np.testing.assert_array_equal(got, w.reshape(2, 2,
                                                         *w.shape[1:]))


def test_cli_trains_on_two_ranks_and_resumes(tmp_path):
    """Epoch 0, then ``--resume`` with 2 epochs: epoch 1 only.  Both ranks
    report the same history; rank 0 alone saved each epoch."""
    argv = ["--config", _config(tmp_path), "--synthetic", "--dataset",
            "gta5"]
    (h0, w0), (h1, w1) = _cli(argv)
    _same(h0, h1)
    assert [e["epoch"] for e in h0] == [0]
    assert np.isfinite(h0[0]["train_loss"]) and \
        0.0 <= h0[0]["validation_mIoU"] <= 1.0
    assert (sorted(set(w0)), w1) == ([0], [])
    saved = torch.load(tmp_path / "ckpt" / "m" / "epoch_0.pt",
                       weights_only=True)
    assert sorted(saved) == ["model"]

    text = (tmp_path / "config.yaml").read_text().replace(
        "segmentation: {epochs: 1", "segmentation: {epochs: 2")
    (tmp_path / "config.yaml").write_text(text)
    (h0, w0), (h1, w1) = _cli([*argv, "--resume"])
    _same(h0, h1)
    assert [e["epoch"] for e in h0] == [1]
    assert (sorted(set(w0)), w1) == ([1], [])


def test_cli_domain_adaptation_on_two_ranks(tmp_path):
    argv = ["--config", _config(tmp_path), "--synthetic",
            "--domain_adaptation"]
    (h0, w0), (h1, w1) = _cli(argv)
    _same(h0, h1)
    assert [e["epoch"] for e in h0] == [0]
    assert np.isfinite(h0[0]["loss_gen_source"])
    assert (sorted(set(w0)), w1) == ([0], [])
    assert sorted(torch.load(tmp_path / "ckpt" / "m_da" / "epoch_0.pt",
                             weights_only=True)) == [
        "discriminator", "generator"]


def test_sigterm_to_one_rank_stops_both_with_an_emergency_checkpoint(
        tmp_path):
    """Rank 1 alone gets SIGTERM after step 0: both ranks stop at one step
    (``main`` returns None on each), rank 0 saves the epoch-start snapshot
    with the EMERGENCY marker, and no rank is left in a collective."""
    text = _config(tmp_path)
    argv = ["--config", text, "--synthetic", "--dataset", "gta5"]
    (r0, w0), (r1, w1) = _cli(argv, sigterm_at_step=0)
    assert r0 is None and r1 is None
    assert (sorted(set(w0)), w1) == ([0], [])
    run_dir = tmp_path / "ckpt" / "m"
    assert (run_dir / "EMERGENCY").read_text().strip() == "0"


def _merge(into: dict, extra: dict) -> dict:
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(into.get(k), dict):
            _merge(into[k], v)
        else:
            into[k] = v
    return into


def _config_with(tmp_path, extra: dict) -> str:
    import yaml

    config = _config(tmp_path)
    with open(config) as f:
        data = _merge(yaml.safe_load(f), extra)
    with open(config, "w") as f:
        yaml.safe_dump(data, f)
    return config


@pytest.mark.parametrize("argv,extra,match", [
    (["--model", "deeplab"], {"mesh": {"pipe": 2}}, "single-process only"),
    (["--domain_adaptation"],
     {"training": {"domain_adaptation": {"ema": {"enabled": True},
                                         "self_training": {"enabled": True}}},
      "model": {"adversarial_model": {"discriminator": {
          "grl": {"enabled": True}}}}},
     "discriminator.grl does not compose with self_training"),
    ([], {"training": {"segmentation": {"distillation": {
        "enabled": True, "teacher": {"checkpoint_dir": "t",
                                     "quantize": "fp8"}}}}},
     "distillation.teacher.quantize 'fp8' is not supported"),
], ids=["pipe", "self_training", "distillation"])
def test_multihost_refusals_exit_before_joining(tmp_path, monkeypatch, argv,
                                                extra, match):
    """Refused before any process group exists (no coordinator is set).
    Self-training and distillation run on several processes
    (test_torch_multirank_extras.py); what stays refused for them is the
    JAX CLI's own refusals, which come before the group is joined too."""
    monkeypatch.setenv("RTSDS_NUM_PROCESSES", "2")
    monkeypatch.delenv("RTSDS_COORDINATOR_ADDRESS", raising=False)
    config = _config_with(tmp_path, extra)
    with pytest.raises(SystemExit, match=match):
        cli.main(["--config", config, "--synthetic", "--multihost", *argv])


def test_multihost_without_a_gpu_or_device_cpu_raises(tmp_path, monkeypatch):
    """No silent fallback: without ``device: cpu`` the process group needs
    a GPU, and there is none here."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    monkeypatch.setenv("RTSDS_NUM_PROCESSES", "1")
    config = _config_with(tmp_path, {"device": "cuda"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", config, "--synthetic", "--multihost"])


# --- what each rank computes of the global batch -------------------------

def _check_rank_augmentation(monkeypatch, world: int, micro_batches: int):
    """With RandomZoom (per-sample draws) and jitter/blur/flip (per-batch
    draws), rank r's augmentation of its share equals one process's
    augmentation of the global batch at the share's positions, from the
    same generator seed."""
    from rtsds_tpu_torch.data.pipeline import batch_generator
    from rtsds_tpu_torch.ops import augment

    cfg = augment.AugmentConfig(apply_p=1.0, color_jitter=(0.4, 0.4, 0.4,
                                                           0.1),
                                zoom_max=1.8, zoom_p=0.5)
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.uniform(0, 255, (4, 12, 20, 3))
                              .astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 19, (4, 12, 20)))
    fn = augment.make_augment_fn(cfg, micro_batches)
    want_x, want_y = fn(batch_generator(7, 0, 5), images, labels)
    for r in range(world):
        monkeypatch.setattr(augment, "world_size", lambda: world)
        monkeypatch.setattr(augment, "rank", lambda r=r: r)
        pos = shard_positions(4, r, world, micro_batches)
        got_x, got_y = fn(batch_generator(7, 0, 5), images[pos],
                          labels[pos])
        torch.testing.assert_close(got_x, want_x[pos], rtol=0, atol=0)
        assert torch.equal(got_y, want_y[pos])


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_augments_its_slice_of_the_global_batch(monkeypatch,
                                                          world):
    _check_rank_augmentation(monkeypatch, world, 1)


def test_each_rank_augments_its_shares_of_the_micro_batches(monkeypatch):
    """Under a 2-step accumulation rank r holds frames r and r + 2."""
    _check_rank_augmentation(monkeypatch, 2, 2)


def test_bisenet_reads_the_global_batch_for_its_minimum(monkeypatch):
    """A shard of one frame trains when the global batch holds two."""
    from rtsds_tpu_torch.train import supervised

    model = BiSeNet()
    one = torch.zeros(1, 32, 64, 3)
    with pytest.raises(ValueError, match="at least 2 frames, got 1"):
        supervised.check_batch(model, one)
    monkeypatch.setattr(supervised, "world_size", lambda: 2)
    supervised.check_batch(model, one)


def test_one_process_on_several_gpus_warns_that_they_idle(monkeypatch):
    """No card is touched: the device is resolved, not used."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.warns(UserWarning, match="3 of 4 GPUs idle.*torchrun"):
        device = cli.device_from_config({"device": "cuda"})
    assert device == torch.device("cuda")
