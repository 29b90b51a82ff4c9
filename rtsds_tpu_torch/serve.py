"""Real-time inference: uint8 frames in, trainId masks out.

:class:`Predictor` keeps a BiSeNet or a DeepLabV2 resident on the GPU
(bf16 by default) and serves (N, H, W, 3) uint8 frames as (N, H, W) int32
masks, or as colorized RGB, through a plain forward or one of the two
accuracy-first protocols (multi-scale + flip ensemble, sliding window).
Masks cross from the device as uint8, a quarter of the bytes of int32, and
are widened on the host.

``python -m rtsds_tpu_torch.serve img.png [--model deeplab] [--protocol
sliding] [--out DIR] [--colored]`` runs it from random init on PNG frames
already at ``--size``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from rtsds_tpu_torch.config import parse_float_list, parse_int_list
from rtsds_tpu_torch.device import resolve_device
from rtsds_tpu_torch.eval.ensemble import make_ensemble_predict
from rtsds_tpu_torch.eval.sliding import make_sliding_predict
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2
from rtsds_tpu_torch.models.pretrained import load_flax_variables
from rtsds_tpu_torch.ops.preprocess import normalize
from rtsds_tpu_torch.utils.colors import apply_color_map


def batched_mask_predict(call: Callable, frames: np.ndarray,
                         image_size: tuple[int, int],
                         batch_size: int | None) -> np.ndarray:
    """Serving batch discipline: (N|_, H, W, 3) uint8 -> int32 masks.

    Promotes a single frame, checks the served size, splits N >
    ``batch_size`` into chunks, zero-pads N < ``batch_size`` and slices the
    padding off on the device, so its rows are never fetched.
    ``batch_size=None`` means ``call`` accepts any N.
    """
    frames = np.asarray(frames, dtype=np.uint8)
    single = frames.ndim == 3
    if single:
        frames = frames[None]
    if frames.shape[1:3] != tuple(image_size):
        raise ValueError(f"predictor built for {tuple(image_size)}, got "
                         f"{frames.shape[1:3]}")
    n = frames.shape[0]
    if batch_size is not None:
        if n > batch_size:
            return np.concatenate([
                batched_mask_predict(call, frames[i:i + batch_size],
                                     image_size, batch_size)
                for i in range(0, n, batch_size)])
        if n < batch_size:
            pad = np.zeros((batch_size - n, *frames.shape[1:]), np.uint8)
            frames = np.concatenate([frames, pad])
    masks = call(frames)[:n].cpu().numpy().astype(np.int32, copy=False)
    return masks[0] if single else masks


def protocol_kwargs_from_flags(protocol: str, scales: str = "0.75, 1.0, 1.25",
                               window: str = "512, 1024", stride: str = "",
                               window_chunk: int = 0) -> dict:
    """CLI flag strings -> :class:`Predictor` ``protocol_kwargs``."""
    if protocol == "ensemble":
        return {"scales": tuple(parse_float_list(scales))}
    if protocol == "sliding":
        kwargs = {"window": tuple(parse_int_list(window))}
        if stride:
            kwargs["stride"] = tuple(parse_int_list(stride))
        if window_chunk > 0:
            kwargs["window_chunk"] = window_chunk
        return kwargs
    return {}


def colorize_masks(masks: np.ndarray) -> np.ndarray:
    """(..., H, W) trainId masks -> colorized (..., H, W, 3) uint8."""
    if masks.ndim == 2:
        return apply_color_map(masks)
    return np.stack([apply_color_map(m) for m in masks])


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to rtsds_tpu_torch;"
                               f" use rtsds_tpu for it")


class Predictor:
    """Device-resident segmentation predictor.

    Args:
      model_name: ``"bisenet"`` or ``"deeplab"`` (DeepLabV2-R101).
      variables: a Flax variable tree of the JAX package's model (numpy
        leaves), loaded through
        :func:`rtsds_tpu_torch.models.pretrained.load_flax_variables`;
        ``None`` serves a random init, the same on every run.
      image_size: the (H, W) frames are served at.
      batch_size: frames per forward; fewer are zero-padded up to it.
      dtype: compute dtype of the model (bf16 by default).
      correct_preprocessing: divide by 255 before the ImageNet
        normalization (it must match how the weights were trained).
      protocol: ``"plain"``, one forward per batch; ``"ensemble"``, the
        mean probabilities over scales and flips; ``"sliding"``, over
        overlapping windows (``eval/ensemble.py``, ``eval/sliding.py``).
      protocol_kwargs: the protocol's options: ``scales`` and ``flip``, or
        ``window``, ``stride`` and ``window_chunk``.
      device: ``None`` serves on the GPU and raises without one; pass
        ``"cpu"`` to serve on the CPU.
    """

    def __init__(self, model_name: str = "bisenet",
                 variables: dict | None = None,
                 image_size: tuple[int, int] = (1024, 2048),
                 batch_size: int = 1, num_classes: int = 19,
                 backbone: str = "resnet18", dtype=torch.bfloat16,
                 correct_preprocessing: bool = False,
                 protocol: str = "plain",
                 protocol_kwargs: dict | None = None,
                 quantize: str | None = None, mesh=None, device=None):
        if model_name not in ("bisenet", "deeplab"):
            raise ValueError(model_name)
        if protocol not in ("plain", "ensemble", "sliding"):
            raise ValueError(f"unknown serving protocol {protocol!r}")
        if quantize is not None:
            raise _not_ported("int8 serving")
        if mesh is not None:
            raise _not_ported("multi-device serving")
        # masks cross to the host as uint8
        if num_classes > 256:
            raise ValueError(
                f"num_classes={num_classes} exceeds the uint8 serving wire "
                f"format (class ids must fit in a byte)")
        self.device = resolve_device(device)
        self.image_size = tuple(image_size)
        self.batch_size = batch_size
        self.dtype = dtype
        self.correct_preprocessing = correct_preprocessing
        self.protocol = protocol

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            if model_name == "deeplab":
                model = DeepLabV2(num_classes=num_classes, output_f32=False)
            else:
                model = BiSeNet(num_classes=num_classes,
                                context_path=backbone, output_f32=False)
        if variables is not None:
            load_flax_variables(model, variables)
        self.model = model.to(device=self.device, dtype=dtype).eval()

        def forward(x):
            return self.model(x.to(self.dtype))

        self._protocol = None
        if protocol == "ensemble":
            self._protocol = make_ensemble_predict(
                forward, self.image_size, **(protocol_kwargs or {}))
        elif protocol == "sliding":
            self._protocol = make_sliding_predict(
                forward, self.image_size, **(protocol_kwargs or {}))

    @torch.inference_mode()
    def _predict(self, frames: np.ndarray) -> torch.Tensor:
        """(N, H, W, 3) uint8 host frames -> (N, H, W) uint8 device masks.
        A protocol resizes and slices the float32 frames and casts each
        forward's input to the model's dtype."""
        x = torch.from_numpy(frames).to(self.device)
        x = normalize(x, self.correct_preprocessing).permute(0, 3, 1, 2)
        if self._protocol is not None:
            return self._protocol(x).to(torch.uint8)
        logits = self.model(x.to(self.dtype))
        return logits.argmax(dim=1).to(torch.uint8)

    def warmup(self) -> "Predictor":
        dummy = np.zeros((self.batch_size, *self.image_size, 3), np.uint8)
        self._predict(dummy).cpu()
        return self

    def predict(self, frames: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) uint8 -> (N, H, W) int32 trainId masks."""
        return batched_mask_predict(self._predict, frames, self.image_size,
                                    self.batch_size)

    def predict_colored(self, frames: np.ndarray) -> np.ndarray:
        """(..., H, W, 3) uint8 -> colorized (..., H, W, 3) uint8 masks."""
        return colorize_masks(self.predict(frames))


def main(argv=None):
    """Inference CLI: ``python -m rtsds_tpu_torch.serve img.png ...``.

    Decodes the images (which must already be at ``--size``), runs the
    predictor from random init, and writes ``<name>_mask.png`` (trainIds)
    or ``<name>_color.png`` (colorized) into ``--out``.
    """
    import argparse
    import os

    from PIL import Image

    parser = argparse.ArgumentParser(
        description="RTSDS real-time segmentation inference (PyTorch/CUDA)")
    parser.add_argument("images", nargs="*", help="input image paths (PNG)")
    parser.add_argument("--model", type=str, default="bisenet",
                        choices=["bisenet", "deeplab"])
    parser.add_argument("--backbone", type=str, default="resnet18")
    parser.add_argument("--size", type=str, default="1024, 2048",
                        help='inference size "H, W"')
    parser.add_argument("--out", type=str, default=".",
                        help="output directory")
    parser.add_argument("--colored", action="store_true",
                        help="write colorized masks instead of trainIds")
    parser.add_argument("--correct_preprocessing", action="store_true",
                        help="standard /255 preprocessing")
    parser.add_argument("--num_classes", type=int, default=19)
    parser.add_argument("--protocol", type=str, default="plain",
                        choices=["plain", "ensemble", "sliding"],
                        help="plain forward (real-time), multi-scale + flip "
                             "ensemble, or sliding window (frames larger "
                             "than the training size)")
    parser.add_argument("--scales", type=str, default="0.75, 1.0, 1.25",
                        help='ensemble scales, e.g. "0.75, 1.0, 1.25"')
    parser.add_argument("--window", type=str, default="512, 1024",
                        help='sliding window "H, W"')
    parser.add_argument("--stride", type=str, default="",
                        help='sliding stride "H, W" (default 3/4 window)')
    parser.add_argument("--window_chunk", type=int, default=0,
                        help="most sliding windows per forward; 0 = all "
                             "in one forward")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the GPU)")
    for flag in ("--checkpoint", "--export", "--mesh", "--quantize"):
        parser.add_argument(flag, type=str, default=None,
                            help="not yet ported")
    args = parser.parse_args(argv)

    for flag in ("checkpoint", "export", "mesh", "quantize"):
        if getattr(args, flag) is not None:
            parser.error(f"--{flag} is not yet ported to rtsds_tpu_torch")
    if not args.images:
        parser.error("no input images given")

    size = tuple(int(v) for v in args.size.replace(" ", "").split(","))
    frames = []
    for path in args.images:
        with Image.open(path) as img:
            frame = np.asarray(img.convert("RGB"))
        if frame.shape[:2] != size:
            parser.error(f"{path} is {frame.shape[:2]}, not --size {size} "
                         f"(the host resize is not yet ported)")
        frames.append(frame)
    frames = np.stack(frames)

    print("serve: running from RANDOM init")
    predictor = Predictor(
        model_name=args.model, image_size=size,
        batch_size=min(len(args.images), 8), num_classes=args.num_classes,
        backbone=args.backbone,
        correct_preprocessing=args.correct_preprocessing,
        protocol=args.protocol,
        protocol_kwargs=protocol_kwargs_from_flags(
            args.protocol, args.scales, args.window, args.stride,
            args.window_chunk),
        device=args.device)
    os.makedirs(args.out, exist_ok=True)
    outputs = (predictor.predict_colored(frames) if args.colored
               else predictor.predict(frames))
    for path, out in zip(args.images, outputs):
        stem = os.path.splitext(os.path.basename(path))[0]
        suffix = "_color.png" if args.colored else "_mask.png"
        dst = os.path.join(args.out, stem + suffix)
        Image.fromarray(out.astype(np.uint8)).save(dst)
        print(f"wrote {dst}")


if __name__ == "__main__":
    main()
