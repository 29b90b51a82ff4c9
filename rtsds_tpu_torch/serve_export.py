"""Ahead-of-time serving artifacts: the whole serving computation and its
weights in one file, served without the model code.

Counterpart of ``rtsds_tpu/serve_export.py``, on ``torch.export``.
:func:`export_predictor` captures a :class:`rtsds_tpu_torch.serve.Predictor`'s
``masks`` method -- uint8 frames -> ImageNet normalization -> the forward in
the predictor's dtype (or its protocol, or its int8 walk) -> argmax -> uint8
masks -- with the trained weights as one ``torch.export`` program.
:func:`load_predictor` returns an :class:`ExportedPredictor` whose
``predict`` and ``predict_colored`` run that program: no model class, no
checkpoint reader, only torch.

File layout, as the JAX package's: a magic line, the ``<I`` length of a
JSON header, the header (``image_size``, ``batch``, ``platforms``,
``num_classes``, ``model``, ``correct_preprocessing``, ``protocol``,
``quantize``), then the payload, the bytes of ``torch.export.save``.  The
magic differs from the JAX package's, so each package refuses the other's
artifact.  ``platforms`` names the device type the program was exported
on (``["cuda"]`` or ``["cpu"]``); loading onto another device raises.

``batch="dynamic"`` exports a symbolic batch.  The export bounds it where
the program branches on it: ``ops/resize.py`` sends a resize of 2^31
elements or more through another kernel, so the export keeps the branch
that the example batch takes and bounds the batch to the largest for which
it holds (53 frames for BiSeNet at 1024x2048 with 19 classes).  The bound
is part of the program (its range constraints), and ``predict`` splits a
larger batch into chunks of that size.  An int batch exports a static
program; ``predict`` then pads a short batch and chunks a long one, as
``Predictor.predict`` does.

Typical flow::

    p = Predictor.from_checkpoint("ckpts", image_size=(1024, 2048))
    export_predictor(p, "bisenet_1024x2048.rtsds")
    # ... on the serving host ...
    ep = load_predictor("bisenet_1024x2048.rtsds")
    masks = ep.predict(frames_u8)          # (N, H, W) int32 trainIds
"""

from __future__ import annotations

import io
import json
import struct

import numpy as np
import sympy
import torch
from torch import nn

from rtsds_tpu_torch.device import resolve_device

_MAGIC = b"RTSDS-TORCH1\n"
# the JAX package's magic, named in the refusal of its artifacts
_JAX_MAGIC = b"RTSDS1\n"
# the example batch of a dynamic export: 0 and 1 are specialized by
# torch.export
_EXAMPLE_BATCH = 2


class _ServingProgram(nn.Module):
    """``Predictor.masks`` as a module; the predictor's model (or int8
    module) is a submodule, so its weights travel with the program."""

    def __init__(self, predictor):
        super().__init__()
        self.model = predictor.model
        self._masks = predictor.masks

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        return self._masks(frames)


def export_predictor(predictor, path: str,
                     batch: int | str = "dynamic") -> str:
    """Write ``predictor``'s serving computation and weights to ``path``.

    Args:
      predictor: a :class:`rtsds_tpu_torch.serve.Predictor` on any protocol,
        bf16/float32 or ``quantize="int8"``; the program is exported on its
        device.
      path: output file.
      batch: ``"dynamic"`` exports a symbolic batch (any N up to the bound
        the program holds, see the module docstring); an int pins the batch.

    Returns ``path``.
    """
    if batch != "dynamic" and int(batch) < 1:
        raise ValueError(f"batch {batch!r} must be 'dynamic' or >= 1")
    h, w = predictor.image_size
    n = _EXAMPLE_BATCH if batch == "dynamic" else int(batch)
    example = torch.zeros((n, h, w, 3), dtype=torch.uint8,
                          device=predictor.device)
    exported = _export(_ServingProgram(predictor).eval(), example,
                       batch == "dynamic")
    buf = io.BytesIO()
    torch.export.save(exported, buf)

    meta = {
        "image_size": [h, w],
        "batch": batch if batch == "dynamic" else int(batch),
        "platforms": [predictor.device.type],
        "num_classes": predictor.num_classes,
        "model": predictor.model_class,
        "correct_preprocessing": predictor.correct_preprocessing,
        # the protocol baked into the program (plain and ensemble differ
        # ~12x in cost per frame; the artifact must say which it is)
        "protocol": predictor.protocol,
        # int8 artifacts carry an accuracy caveat (near-tie pixels), so
        # they must be told apart from exact bf16 exports
        "quantize": predictor.quantize,
    }
    head = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(head)))
        f.write(head)
        f.write(buf.getvalue())
    return path


def _export(program: nn.Module, example: torch.Tensor, dynamic: bool):
    """``torch.export`` of ``program`` at ``example``'s shape, with a
    symbolic batch when ``dynamic``."""
    dims = ({0: torch.export.Dim.AUTO},) if dynamic else None
    # the predictor's own calls run under inference_mode; the export must
    # not see inference tensors, so it traces outside it, without autograd
    with torch.no_grad():
        return torch.export.export(program, (example,), dynamic_shapes=dims)


def _batch_bound(exported) -> int | None:
    """The largest batch a symbolic-batch program holds for (its batch
    symbol's range), or None for any (an unbounded symbolic batch, or a
    static one)."""
    for node in exported.graph.nodes:
        if node.op == "placeholder" and node.name in (
                exported.graph_signature.user_inputs):
            size = node.meta["val"].shape[0]
            if not isinstance(size, torch.SymInt):
                return None
            bound = exported.range_constraints[size.node.expr].upper
            # an unbounded batch's upper end is torch's integer infinity
            return int(bound) if isinstance(bound, sympy.Integer) else None
    raise ValueError("the exported program has no input")


class ExportedPredictor:
    """A loaded serving artifact: ``predict`` without any model code."""

    def __init__(self, exported, meta: dict, device: torch.device):
        self.meta = meta
        self.image_size = tuple(meta["image_size"])
        self.batch = meta["batch"]
        self.device = device
        self.max_batch = (_batch_bound(exported) if self.batch == "dynamic"
                          else int(self.batch))
        self._module = exported.module()

    @torch.inference_mode()
    def _call(self, frames: np.ndarray) -> torch.Tensor:
        """(N, H, W, 3) uint8 host frames -> (N, H, W) uint8 device masks."""
        return self._module(torch.from_numpy(frames).to(self.device))

    def predict(self, frames: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) or (H, W, 3) uint8 -> (N, H, W) / (H, W) int32."""
        from rtsds_tpu_torch.serve import batched_mask_predict

        frames = np.asarray(frames, dtype=np.uint8)
        if self.batch != "dynamic":
            return batched_mask_predict(self._call, frames, self.image_size,
                                        self.max_batch)
        if (frames.ndim == 3 or self.max_batch is None
                or frames.shape[0] <= self.max_batch):
            return batched_mask_predict(self._call, frames, self.image_size,
                                        None)
        # chunks of at most the program's bound, none padded
        return np.concatenate([
            batched_mask_predict(self._call, frames[i:i + self.max_batch],
                                 self.image_size, None)
            for i in range(0, max(frames.shape[0], 1), self.max_batch)])

    def predict_colored(self, frames: np.ndarray) -> np.ndarray:
        """(..., H, W, 3) uint8 -> colorized (..., H, W, 3) uint8 masks."""
        from rtsds_tpu_torch.serve import colorize_masks

        return colorize_masks(self.predict(frames))


def load_predictor(path: str, device=None) -> ExportedPredictor:
    """Load an artifact written by :func:`export_predictor` onto
    ``device`` (``None``: the GPU, which raises without one; ``"cpu"``
    for the CPU).  The artifact must have been exported on that device
    type: the program is not moved to another."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            if magic.startswith(_JAX_MAGIC):
                raise ValueError(
                    f"{path} is a serving artifact of the JAX package "
                    f"(rtsds_tpu.serve_export); load it with "
                    f"rtsds_tpu.serve_export.load_predictor")
            raise ValueError(f"{path} is not an RTSDS serving artifact of "
                             f"rtsds_tpu_torch")
        raw = f.read(4)
        if len(raw) < 4:
            raise ValueError(f"{path}: truncated serving artifact")
        (hlen,) = struct.unpack("<I", raw)
        head = f.read(hlen)
        if len(head) < hlen:
            raise ValueError(f"{path}: truncated serving artifact")
        meta = json.loads(head.decode())
        payload = f.read()
    if meta["platforms"] != [device.type]:
        raise ValueError(
            f"{path} was exported for {meta['platforms']}, not for "
            f"{device.type!r} ({device}); export it again on that device")
    exported = torch.export.load(io.BytesIO(payload))
    return ExportedPredictor(exported, meta, device)
