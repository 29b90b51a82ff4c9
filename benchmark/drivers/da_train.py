"""Adversarial domain adaptation (v1): the training loop's iteration.

Set-up makes the generator's and the discriminator's weights (float32)
and pools of host batches from the seed: source frames at the source size
with colour-coded labels (blocks of the Cityscapes training colours and
two void colours), target frames at the target size.  It builds the
program's train states with ``train/factory.py:build_adversarial``, from
the program's default configuration with the model of the
configuration's ``program_train`` and the traffic's recipe over it, and
loads the seed's weights into their models; then the loaders' device
streams: ``data/pipeline.py:device_batches`` through
``ops/preprocess.py:make_transform``, the source's with
``decode_label_colors`` (K2 remaps the labels).  Each iteration makes
``train/loop.py:adversarial_fit``'s calls in its order: ``next`` of the
source and the target stream, the step of
``make_adversarial_step(variant="v1")``, and the previous step's losses
read.

The first three steps are the checked ones: the step object that the
window goes on to drive takes them on the pool's first three batches.
After the window the reference follows the same three steps in float32.
Compared (each a gap over the reference's value):

* ``label_mismatch``: the first source batch's labels as the transform
  gave them against a plain colour lookup (exact);
* ``loss_gap``: the four losses of each of the three steps, relative;
* ``grad_gap_p90``: each leaf's gradient norm at step 1, as backward hands
  it to the optimizer (hooks on the parameters, taken by the benchmark),
  its gap over the larger of its own reference norm and the network's
  median leaf's, the 90th percentile over the leaves that train;
  ``grad_gap``, the worst leaf's, is printed beside it;
* ``change_gap``: each leaf's change after step 3, likewise, worst leaf,
  over the leaves whose reference gradient is at least a thousandth of the
  median's (a leaf with none moves under Adam by round-off alone) and the
  frozen ones.

Which of them a cell compares, and the limits, are its
``limits/<cell>.json``.

``train_images_per_s``: source images of the steps of the window, over the
window, which ends when the last step's losses have been read.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import statistics
import time

import torch

from benchmark import harness, hostload, seeds, trace as tracing
from benchmark.stats import percentile
from benchmark.reference import lowp, models
from benchmark.reference.da_step import Adam, v1_step
from benchmark.reference.layers import checkpoint_blocks, set_precision
from benchmark.reference.transform import label_ids, normalize

CHECKED = 3
LOSSES = ("loss_gen_source", "loss_adversarial", "loss_disc_source",
          "loss_disc_target")


def pools(cell):
    """Host batches: source (images, colour labels), target (images,
    trainId labels)."""
    cfg, tr, device = cell.config, cell.traffic, torch.device(cell.device)
    n = int(tr["pool_batches"]) * int(tr["batch"])
    src, src_lab = seeds.scenes(seeds.sub_seed(cell.seed, 13), n,
                                tuple(cfg["train_source_hw"]),
                                int(tr["block"]), device)
    tgt, tgt_rgb = seeds.scenes(seeds.sub_seed(cell.seed, 14), n,
                                tuple(cfg["train_target_hw"]),
                                int(tr["block"]), device)
    tgt_lab = label_ids(tgt_rgb)
    tgt_lab[tgt_lab == 19] = 255
    return ([x.cpu().numpy() for x in (src, src_lab)],
            [x.cpu().numpy() for x in (tgt, tgt_lab)])


def weights(cell, device):
    cfg = cell.config
    classes = int(cfg["num_classes"])
    g_spec = models.network(cfg["reference"], classes)
    d_spec = models.network(cfg["reference_discriminator"], classes)
    return (g_spec, seeds.make_weights(g_spec, seeds.sub_seed(cell.seed, 11),
                                       device),
            d_spec, seeds.make_weights(d_spec, seeds.sub_seed(cell.seed, 12),
                                       device))


def schedules(tr):
    """The two learning rates as functions of the step count, written out
    from the recipe's numbers."""
    opt = tr["optimizer"]
    total = int(tr["epochs"]) * int(tr["iterations"])

    def gen_lr(t):
        return opt["gen_lr"] * (1 - min(t, total) / total) ** opt["gen_power"]

    def dis_lr(t):
        epoch = t // int(tr["iterations"])
        return opt["dis_lr"] * (1 - epoch / int(tr["epochs"])) \
            ** opt["dis_power"]
    return gen_lr, dis_lr


def run(cell: harness.Cell) -> harness.Outcome:
    device = torch.device(cell.device)
    src_pool, tgt_pool = pools(cell)
    cell.mark("pools")
    if cell.mode == "program":
        outcome, readings = train(cell, src_pool, tgt_pool)
    else:
        outcome = harness.Outcome(0, 0, time.perf_counter(), {}, {}, {})
        readings = reference_readings(
            cell, src_pool, tgt_pool,
            "fp8" if cell.mode == "control" else "float32",
            half_batch=cell.mode == "half_batch")
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(cell, src_pool, tgt_pool, "float32")
    outcome.checks = compare(readings, ref)
    # the worst leaf's gradient gap is read, not compared (PERF.md)
    outcome.counters["grad_gap"] = outcome.checks["grad_gap"]
    outcome.counters["worst_leaves"] = worst_leaves(readings, ref)
    return outcome


class Cycle:
    """The loader's host batches, the pool's cycled without end."""

    def __init__(self, pool, batch):
        images, labels = pool
        self.batches = [(images[i:i + batch], labels[i:i + batch])
                        for i in range(0, len(images), batch)]

    def __iter__(self):
        return itertools.cycle(self.batches)


def merged(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def program_config(cell):
    """The program's configuration of this cell: its defaults, the model
    of the configuration's ``program_train``, and the traffic's recipe."""
    from rtsds_tpu_torch.config import load_config

    cfg, tr = cell.config, cell.traffic
    opt = tr["optimizer"]
    recipe = {
        "precision": {"compute_dtype": cfg["dtype"]},
        "model": {"adversarial_model": {
            "generator": {"power_lr_factor": opt["gen_power"],
                          "optimizer": {"name": "Adam",
                                        "lr": opt["gen_lr"]}},
            "discriminator": {"power_lr_factor": opt["dis_power"],
                              "optimizer": {
                                  "name": "Adam", "lr": opt["dis_lr"],
                                  "weight_decay": opt["dis_weight_decay"]}}}},
        "training": {"domain_adaptation": {
            "epochs": int(tr["epochs"]), "iterations": int(tr["iterations"]),
            "lambda": float(tr["lambda"]), "lr_decay_iter": 1,
            "warmup_iters": 0, "variant": tr["variant"]}}}
    return load_config(overrides=merged(cfg["program_train"], recipe),
                       lint=False)


def gradient_norms(model):
    """Hooks that keep each parameter's gradient norm as backward leaves
    it (the last accumulation wins), and the dict they fill."""
    norms = {}

    def keep(name):
        def hook(p):
            norms[name] = p.grad.detach().norm()
        return hook
    handles = [p.register_post_accumulate_grad_hook(keep(k))
               for k, p in model.named_parameters() if p.requires_grad]
    return norms, handles


def train(cell, src_pool, tgt_pool):
    from rtsds_tpu_torch.data.pipeline import device_batches
    from rtsds_tpu_torch.ops.preprocess import make_transform
    from rtsds_tpu_torch.train.adversarial import make_adversarial_step
    from rtsds_tpu_torch.train.factory import build_adversarial

    cfg, tr, device = cell.config, cell.traffic, torch.device(cell.device)
    n, classes = int(tr["batch"]), int(cfg["num_classes"])
    _, g_w, _, d_w = weights(cell, device)
    cell.mark("weights")
    config = program_config(cell)
    gen_state, dis_state = build_adversarial(config, device)
    gen, dis = gen_state.model, dis_state.model
    gen.load_state_dict(g_w)
    dis.load_state_dict(d_w)
    tcfg = config.training["domain_adaptation"]
    step = make_adversarial_step(
        float(tcfg["lambda"]), int(tcfg["iterations"]), int(tcfg["epochs"]),
        ignore_index=19, variant=str(tcfg["variant"]))
    cell.mark("program_build")
    span = torch.profiler.record_function if cell.trace \
        else (lambda name: contextlib.nullcontext())

    def spanned(transform):
        def call(*args):
            with span("bench.transform"):
                return transform(*args)
        return call

    source = device_batches(Cycle(src_pool, n), spanned(make_transform(
        tuple(cfg["train_source_hw"]), classes, decode_label_colors=True)),
        device)
    target = device_batches(Cycle(tgt_pool, n), spanned(make_transform(
        tuple(cfg["train_target_hw"]), classes)), device)

    def iteration():
        with span("bench.batch"):
            src_images, src_labels = next(source)
            tgt_images, _ = next(target)
        with span("bench.step"):
            metrics = step(gen_state, dis_state, src_images, src_labels,
                           tgt_images)
        return metrics, src_labels

    def read(metrics) -> bool:
        with span("bench.metrics_read"):
            losses = [float(metrics[k]) for k in LOSSES]
            int(metrics["correct"])
        return all(v == v and abs(v) != float("inf") for v in losses)

    setup_peak = 0
    # the checked steps, through the window's own call and feed; the first
    # step's gradients as backward hands them to the optimizers
    readings = {"losses": []}
    hooked = {net: gradient_norms(m) for net, m in (("gen", gen),
                                                     ("dis", dis))}
    for t in range(CHECKED):
        metrics, labels = iteration()
        readings["losses"].append({k: float(metrics[k]) for k in LOSSES})
        if t == 0:
            readings["labels"] = labels.cpu()
            readings["grads"] = {}
            for net, (norms, handles) in hooked.items():
                for h in handles:
                    h.remove()
                readings["grads"][net] = {k: float(v)
                                          for k, v in norms.items()}
            cell.mark("first_step")
    with torch.no_grad():
        readings["changes"] = {
            "gen": {k: float((p - g_w[k]).norm())
                    for k, p in gen.named_parameters()},
            "dis": {k: float((p - d_w[k]).norm())
                    for k, p in dis.named_parameters()}}
    del g_w, d_w
    cell.mark("checked_steps")
    for _ in range(int(tr["warmup_steps"])):
        read(iteration()[0])
    if device.type == "cuda":
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    cell.mark("warmup")

    steps, failed, pending = 0, 0, None
    with tracing.profiled(cell.trace) as prof:
        t0 = time.perf_counter()
        t_end = t0 + cell.seconds
        while time.perf_counter() < t_end:
            metrics = iteration()[0]
            steps += 1
            if pending is not None:
                failed += not read(pending)
            pending = metrics
        failed += not read(pending)
        t_last = time.perf_counter()
    window_peak = 0
    if device.type == "cuda":
        window_peak = torch.cuda.max_memory_allocated()
    outcome = harness.Outcome(
        attempted=steps, failed=failed, window_start=t0,
        metrics={"train_images_per_s": steps * n / (t_last - t0)},
        checks={}, counters={"steps": steps, "batch": n,
                             "window_peak_bytes": window_peak,
                             **hostload.counters(cell.host_start, prof)},
        memory_peak_bytes=max(setup_peak, window_peak), trace=prof.trace)
    return outcome, readings


def reference_readings(cell, src_pool, tgt_pool, precision: str,
                       half_batch: bool = False) -> dict:
    """The first three steps of the reference, in ``precision``."""
    cfg, tr, device = cell.config, cell.traffic, torch.device(cell.device)
    n = int(tr["batch"])
    g_spec, g_w, d_spec, d_w = weights(cell, device)
    gen = set_precision(checkpoint_blocks(models.loaded(g_spec, g_w, device)),
                        precision)
    dis = set_precision(models.loaded(d_spec, d_w, device), precision)
    start = {"gen": g_w, "dis": d_w}
    gen_opt = Adam(dict(gen.named_parameters()),
                   frozen=models.frozen_names(cfg["reference"], gen))
    dis_opt = Adam(dict(dis.named_parameters()),
                   weight_decay=tr["optimizer"]["dis_weight_decay"])
    gen_lr, dis_lr = schedules(tr)
    readings = {"losses": []}
    with lowp.strict_float32():
        for t in range(CHECKED):
            sl = slice(t * n, (t + 1) * n)
            src = normalize(torch.from_numpy(src_pool[0][sl]).to(device))
            labels = label_ids(torch.from_numpy(src_pool[1][sl]).to(device))
            tgt = normalize(torch.from_numpy(tgt_pool[0][sl]).to(device))
            out = v1_step(gen, dis, gen_opt, dis_opt, src, labels, tgt,
                          float(tr["lambda"]), int(tr["iterations"]),
                          gen_lr(t), dis_lr(t), half_batch=half_batch)
            readings["losses"].append(out["losses"])
            if t == 0:
                readings["labels"] = labels.cpu()
                readings["grads"] = {
                    net: {k: float(g.norm()) for k, g in out[key].items()}
                    for net, key in (("gen", "gen_grads"),
                                     ("dis", "dis_grads"))}
    with torch.no_grad():
        readings["changes"] = {
            net: {k: float((p - start[net][k]).norm())
                  for k, p in model.named_parameters()}
            for net, model in (("gen", gen), ("dis", dis))}
    return readings


def leaf_gaps(got: dict, ref: dict, net: str) -> tuple[dict, dict]:
    """Each leaf's gradient gap at step 1 over the leaves the reference
    trains, and its change gap after step 3 over those whose reference
    gradient is at least a thousandth of the median leaf's and the frozen
    ones (which the reference leaves unchanged): each a gap of norms over
    the larger of the leaf's reference norm and the median leaf's."""
    rg, gg = ref["grads"][net], got["grads"][net]
    trains = [k for k in rg if rg[k] > 0]
    med = statistics.median(rg[k] for k in trains)
    grad = {k: abs(gg.get(k, 0.0) - rg[k]) / max(rg[k], med) for k in trains}
    moving = [k for k in trains if rg[k] >= 1e-3 * med]
    rc, gc_ = ref["changes"][net], got["changes"][net]
    cmed = statistics.median(rc[k] for k in moving)
    change = {k: abs(gc_[k] - rc[k]) / max(rc[k], cmed)
              for k in moving + [k for k in rg if rg[k] == 0]}
    return grad, change


def compare(got: dict, ref: dict) -> dict:
    loss_gap = max(abs(g[k] - r[k]) / max(abs(r[k]), 1e-30)
                   for g, r in zip(got["losses"], ref["losses"])
                   for k in LOSSES)
    grads, changes = [], []
    for net in ("gen", "dis"):
        grad, change = leaf_gaps(got, ref, net)
        grads += grad.values()
        changes += change.values()
    mismatch = int((got["labels"] != ref["labels"]).sum())
    return {"label_mismatch": float(mismatch), "loss_gap": loss_gap,
            "grad_gap": max(grads), "grad_gap_p90": percentile(grads, 90),
            "change_gap": max(changes)}


def worst_leaves(got: dict, ref: dict) -> dict:
    """For a reader of the numbers: the leaf behind each network's widest
    gradient and change gap."""
    out = {}
    for net in ("gen", "dis"):
        grad, change = leaf_gaps(got, ref, net)
        out[f"{net}_grad"] = max(grad, key=grad.get)
        out[f"{net}_change"] = max(change, key=change.get)
    return out
