"""Real-time inference: uint8 frames in, trainId masks out.

:class:`Predictor` keeps a BiSeNet resident on the GPU (bf16 by default)
and serves (N, H, W, 3) uint8 frames as (N, H, W) int32 masks, or as
colorized RGB.  Masks cross from the device as uint8, a quarter of the
bytes of int32, and are widened on the host.

``python -m rtsds_tpu_torch.serve img.png [--out DIR] [--colored]`` runs
it from random init on PNG frames already at ``--size``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from rtsds_tpu_torch.device import resolve_device
from rtsds_tpu_torch.models.bisenet import BiSeNet
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


def colorize_masks(masks: np.ndarray) -> np.ndarray:
    """(..., H, W) trainId masks -> colorized (..., H, W, 3) uint8."""
    if masks.ndim == 2:
        return apply_color_map(masks)
    return np.stack([apply_color_map(m) for m in masks])


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to rtsds_tpu_torch;"
                               f" use rtsds_tpu for it")


class Predictor:
    """Device-resident BiSeNet segmentation predictor.

    Args:
      model_name: ``"bisenet"``.
      variables: a Flax variable tree of the JAX package's BiSeNet (numpy
        leaves), loaded through
        :func:`rtsds_tpu_torch.models.pretrained.load_flax_variables`;
        ``None`` serves a random init, the same on every run.
      image_size: the (H, W) frames are served at.
      batch_size: frames per forward; fewer are zero-padded up to it.
      dtype: compute dtype of the model (bf16 by default).
      correct_preprocessing: divide by 255 before the ImageNet
        normalization (it must match how the weights were trained).
      protocol: ``"plain"``, one forward per batch.
      device: ``None`` serves on the GPU and raises without one; pass
        ``"cpu"`` to serve on the CPU.
    """

    def __init__(self, model_name: str = "bisenet",
                 variables: dict | None = None,
                 image_size: tuple[int, int] = (1024, 2048),
                 batch_size: int = 1, num_classes: int = 19,
                 backbone: str = "resnet18", dtype=torch.bfloat16,
                 correct_preprocessing: bool = False,
                 protocol: str = "plain", quantize: str | None = None,
                 mesh=None, device=None):
        if model_name == "deeplab":
            raise _not_ported("DeepLabV2 serving")
        if model_name != "bisenet":
            raise ValueError(model_name)
        if protocol in ("ensemble", "sliding"):
            raise _not_ported(f"the {protocol!r} serving protocol")
        if protocol != "plain":
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
            model = BiSeNet(num_classes=num_classes, context_path=backbone,
                            output_f32=False)
        if variables is not None:
            load_flax_variables(model, variables)
        self.model = model.to(device=self.device, dtype=dtype).eval()

    @torch.inference_mode()
    def _predict(self, frames: np.ndarray) -> torch.Tensor:
        """(N, H, W, 3) uint8 host frames -> (N, H, W) uint8 device masks."""
        x = torch.from_numpy(frames).to(self.device)
        x = normalize(x, self.correct_preprocessing)
        logits = self.model(x.permute(0, 3, 1, 2).to(self.dtype))
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
                        choices=["plain", "ensemble", "sliding"])
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the GPU)")
    for flag in ("--checkpoint", "--export", "--mesh", "--quantize"):
        parser.add_argument(flag, type=str, default=None,
                            help="not yet ported")
    args = parser.parse_args(argv)

    for flag in ("checkpoint", "export", "mesh", "quantize"):
        if getattr(args, flag) is not None:
            parser.error(f"--{flag} is not yet ported to rtsds_tpu_torch")
    if args.model != "bisenet":
        parser.error(f"--model {args.model} is not yet ported")
    if args.protocol != "plain":
        parser.error(f"--protocol {args.protocol} is not yet ported")
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
    predictor = Predictor(image_size=size,
                          batch_size=min(len(args.images), 8),
                          num_classes=args.num_classes,
                          backbone=args.backbone,
                          correct_preprocessing=args.correct_preprocessing,
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
