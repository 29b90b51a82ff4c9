"""Checkpoint -> torch ``.pth`` in the reference models' layouts.

Counterpart of ``rtsds_tpu/export_torch.py``: weights trained by the port
load into the reference's torch models with ``load_state_dict(strict=True)``
and into any tool that reads the JAX package's exports.

Usage::

    python -m rtsds_tpu_torch.export_torch CHECKPOINT_DIR out.pth \
        --model bisenet
    python -m rtsds_tpu_torch.export_torch CHECKPOINT_DIR out.pth \
        --model deeplab --prefix Scale.

``--model bisenet`` writes the reference BiSeNet's key inventory (its
misspelled ``saptial_path``, the ``context_path.features.*`` aliases);
``--model deeplab`` the plain ResNetMulti inventory, with ``--prefix``
re-adding a dotted scope the reference strips on load (MSCOCO-checkpoint
style); ``--model raw`` the port's names, which are DeepLab's layout for
any model.  The tensors are the checkpoint's EMA weights when it holds
them (what validation scored); ``--no-ema`` opts out.
"""

from __future__ import annotations

import argparse

import torch

from rtsds_tpu_torch.models.pretrained import state_dict_to_reference
from rtsds_tpu_torch.serve import load_checkpoint_state


def export_checkpoint(checkpoint_dir: str, out_path: str,
                      model: str = "bisenet", prefix: str = "",
                      use_ema: bool = True) -> int:
    """Export a training checkpoint as a torch state dict; returns its
    number of entries."""
    state = state_dict_to_reference(
        load_checkpoint_state(checkpoint_dir, use_ema=use_ema),
        bisenet=model == "bisenet", prefix=prefix)
    torch.save(state, out_path)
    return len(state)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Export an RTSDS checkpoint of the PyTorch port as a "
                    "torch .pth state dict loadable by the reference models")
    parser.add_argument("checkpoint", help="ModelCheckpoint directory "
                        "(best/latest epoch, EMA item preferred)")
    parser.add_argument("out", help="output .pth path")
    parser.add_argument("--model", default="bisenet",
                        choices=["bisenet", "deeplab", "raw"],
                        help="target key layout: reference BiSeNet "
                             "(saptial_path + features aliases), reference "
                             "DeepLab/ResNetMulti, or the port's names")
    parser.add_argument("--prefix", default="",
                        help='dotted prefix to re-add (e.g. "Scale." for '
                             "MSCOCO-style DeepLab checkpoints)")
    parser.add_argument("--no-ema", action="store_true",
                        help="export raw training params even when the "
                             "checkpoint carries EMA weights")
    args = parser.parse_args(argv)

    n = export_checkpoint(args.checkpoint, args.out, model=args.model,
                          prefix=args.prefix, use_ema=not args.no_ema)
    print(f"exported {n} tensors -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
