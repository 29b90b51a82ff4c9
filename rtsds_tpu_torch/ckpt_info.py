"""Checkpoint inspection CLI: what a training checkpoint directory holds.

Counterpart of ``rtsds_tpu/ckpt_info.py`` for the port's checkpoints
(``callbacks/checkpoint.py``: ``epoch_<N>.pt`` and ``metrics.json`` in
``<save_dir>/<save_name>/``):

    python -m rtsds_tpu_torch.ckpt_info checkpoints/model_da

prints one row per saved epoch (its items, its monitored metric, and
which epoch is the best and which the latest).  Use it before
``--resume``, ``--validate_only`` or serving to see what a run left
behind.  It reads ``metrics.json`` and memory-maps each epoch's file to
list its items, so no tensor is read.
"""

from __future__ import annotations

import argparse
import os

from rtsds_tpu_torch.callbacks.checkpoint import (
    CheckpointManager, emergency_step)


def describe_checkpoint(save_dir: str) -> dict:
    """Metadata summary of a ModelCheckpoint directory.

    Returns ``{"steps": [{"step", "items", "monitor"}...], "best_step",
    "latest_step", "emergency_step"}``, steps ascending.
    ``emergency_step`` is the epoch of a mid-epoch emergency snapshot
    (``ModelCheckpoint.save_emergency``, named by the ``EMERGENCY``
    marker), which ``--resume`` replays from its start; else ``None``.
    """
    # inspection must not create directories (CheckpointManager's
    # constructor makes its save_dir)
    if not os.path.isdir(save_dir):
        return {"steps": [], "best_step": None, "latest_step": None,
                "emergency_step": None}
    mgr = CheckpointManager(save_dir)
    metrics = mgr.metrics()
    rows = [{"step": step, "items": mgr.items(step),
             "monitor": (None if metrics.get(step) is None
                         else float(metrics[step]))}
            for step in mgr.all_steps()]
    return {"steps": rows, "best_step": mgr.best_step(),
            "latest_step": mgr.latest_step(),
            "emergency_step": emergency_step(save_dir)}


def _subdirs_with_checkpoints(path: str) -> list[str]:
    try:
        children = sorted(os.scandir(path), key=lambda e: e.name)
    except OSError:
        return []
    return [c.path for c in children if c.is_dir()
            and describe_checkpoint(c.path)["steps"]]


def format_report(save_dir: str, info: dict) -> str:
    lines = [f"checkpoints in {save_dir}:"]
    for row in info["steps"]:
        flags = []
        if row["step"] == info["best_step"]:
            flags.append("best")
        if row["step"] == info["latest_step"]:
            flags.append("latest")
        if row["step"] == info["emergency_step"]:
            flags.append("EMERGENCY(mid-epoch)")
        monitor = ("-" if row["monitor"] is None
                   else f"{row['monitor']:.4f}")
        lines.append(f"  step {row['step']:>4}  monitor={monitor:>8}  "
                     f"items=[{', '.join(row['items'])}]"
                     + (f"  <- {', '.join(flags)}" if flags else ""))
    if not info["steps"]:
        lines.append("  (none)")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Inspect an RTSDS checkpoint directory of the PyTorch "
                    "port (steps, items, metrics; no tensor is read)")
    parser.add_argument("checkpoint", help="ModelCheckpoint directory "
                        "(e.g. checkpoints/model_da)")
    args = parser.parse_args(argv)

    info = describe_checkpoint(args.checkpoint)
    if not info["steps"]:
        # a run root instead of one save_name directory: descend one level
        subs = _subdirs_with_checkpoints(args.checkpoint)
        if subs:
            for sub in subs:
                print(format_report(sub, describe_checkpoint(sub)))
            return 0
    print(format_report(args.checkpoint, info))
    return 0 if info["steps"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
