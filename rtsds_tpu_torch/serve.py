"""Real-time inference: uint8 frames in, trainId masks out.

:class:`Predictor` keeps a BiSeNet or a DeepLabV2 resident on the GPU
(bf16 by default) and serves (N, H, W, 3) uint8 frames as (N, H, W) int32
masks, or as colorized RGB, through a plain forward or one of the two
accuracy-first protocols (multi-scale + flip ensemble, sliding window).
Masks cross from the device as uint8, a quarter of the bytes of int32, and
are widened on the host.  :meth:`Predictor.from_checkpoint` serves a trained
checkpoint (its ``ema`` item when it holds one), and
:meth:`Predictor.predict_iter` streams batches with one in flight.

``python -m rtsds_tpu_torch.serve img.png [--checkpoint DIR] [--model
deeplab] [--protocol sliding] [--out DIR] [--colored]`` decodes PNG frames,
resizes them to ``--size`` and serves them; without ``--checkpoint`` it runs
from random init.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from rtsds_tpu_torch.callbacks.checkpoint import CheckpointManager
from rtsds_tpu_torch.config import parse_float_list, parse_int_list
from rtsds_tpu_torch.device import resolve_device
from rtsds_tpu_torch.eval.ensemble import make_ensemble_predict
from rtsds_tpu_torch.eval.sliding import make_sliding_predict
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2
from rtsds_tpu_torch.models.pretrained import (
    load_flax_variables, load_segmentor_state, state_dict_from_reference)
from rtsds_tpu_torch.ops.preprocess import normalize
from rtsds_tpu_torch.utils.colors import apply_color_map


def load_checkpoint_state(source: str, use_ema: bool = True
                          ) -> dict[str, torch.Tensor]:
    """A trained segmentor's state dict (parameters and BN buffers), on the
    CPU, from ``source``:

    * a directory of the port's checkpoints (``callbacks/checkpoint.py``):
      the best epoch, else the latest; the ``model`` item (a supervised
      run), else ``generator`` (domain adaptation); its parameters replaced
      by the ``ema`` item's when ``use_ema`` and the checkpoint holds one
      (the weights its validation scored);
    * a file written by ``python -m rtsds_tpu_torch.export_torch`` or
      ``python -m rtsds_tpu.export_torch`` (any ``--model`` layout;
      ``--prefix`` stripped), which already holds the EMA weights unless
      it was exported with ``--no-ema``.

    Load the result into the model with
    :func:`rtsds_tpu_torch.models.pretrained.load_segmentor_state`.
    """
    if os.path.isfile(source):
        state = torch.load(source, map_location="cpu", weights_only=True)
        return state_dict_from_reference(state)
    if not os.path.isdir(source):
        raise FileNotFoundError(f"no checkpoint directory or file at "
                                f"{source}")
    mgr = CheckpointManager(source)
    step = mgr.best_step()
    if step is None:
        step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {source}")
    payload = mgr.load(step)
    item = payload.get("model", payload.get("generator"))
    if item is None:
        raise KeyError(f"epoch {step} under {source} holds "
                       f"{sorted(payload)}, neither 'model' nor 'generator'")
    state = dict(item["model"])
    if use_ema and "ema" in payload:
        state.update(payload["ema"]["params"])
        print("serve: using the checkpoint's EMA weights "
              "(use_ema=False for the raw training params)")
    return state


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
        :func:`rtsds_tpu_torch.models.pretrained.load_flax_variables`.
      state: a torch state dict of the model (:func:`load_checkpoint_state`
        gives one), loaded through
        :func:`rtsds_tpu_torch.models.pretrained.load_segmentor_state`.
        With neither ``variables`` nor ``state`` it serves a random init,
        the same on every run.
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
                 state: dict | None = None,
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
        if variables is not None and state is not None:
            raise ValueError("pass the weights as variables or as state, "
                             "not both")
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
        if state is not None:
            load_segmentor_state(model, state)
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

    def predict_iter(self, frames_iter: Iterable[np.ndarray]
                     ) -> Iterator[np.ndarray]:
        """Streaming inference: yields the (N, H, W) int32 masks of each
        input batch ((N, H, W, 3), N at most ``batch_size``, or one (H, W,
        3) frame as N = 1), in order, while ONE batch stays in flight on the device: batch k+1 is
        enqueued before batch k's masks are read, so the device computes
        k+1 while the host widens k's masks and the caller uses them (the
        real-time camera-feed pattern).  A short batch is zero-padded and
        the padding sliced off on the device.  Masks come back with a
        non-blocking copy into pinned host memory, read after an event
        that follows the copy."""
        pending = None
        for frames in frames_iter:
            frames = np.asarray(frames, dtype=np.uint8)
            if frames.ndim == 3:
                frames = frames[None]
            n = frames.shape[0]
            if frames.shape[1:3] != self.image_size:
                raise ValueError(f"predictor built for {self.image_size}, "
                                 f"got {frames.shape[1:3]}")
            if n > self.batch_size:
                raise ValueError(
                    f"stream batches must be <= compiled batch "
                    f"{self.batch_size}, got {n}")
            if n < self.batch_size:
                pad = np.zeros((self.batch_size - n, *frames.shape[1:]),
                               np.uint8)
                frames = np.concatenate([frames, pad])
            fetch = self._fetch_async(self._predict(frames)[:n])
            if pending is not None:
                yield pending()
            pending = fetch
        if pending is not None:
            yield pending()

    def _fetch_async(self, masks: torch.Tensor) -> Callable[[], np.ndarray]:
        """Starts the copy of device ``masks`` to the host; the returned
        call waits for it and gives them as int32."""
        if masks.device.type != "cuda":
            return lambda: masks.numpy().astype(np.int32)
        host = torch.empty(masks.shape, dtype=masks.dtype, pin_memory=True)
        host.copy_(masks, non_blocking=True)
        done = torch.cuda.Event()
        done.record()

        def wait() -> np.ndarray:
            done.synchronize()
            return host.numpy().astype(np.int32)
        return wait

    def predict_colored(self, frames: np.ndarray) -> np.ndarray:
        """(..., H, W, 3) uint8 -> colorized (..., H, W, 3) uint8 masks."""
        return colorize_masks(self.predict(frames))

    @classmethod
    def from_checkpoint(cls, path: str, use_ema: bool = True,
                        **kwargs) -> "Predictor":
        """A predictor of the weights at ``path``: a port checkpoint
        directory (best epoch, else latest; the ``model`` or ``generator``
        item; the ``ema`` item's weights unless ``use_ema=False``) or an
        ``export_torch`` file, read by :func:`load_checkpoint_state`.
        ``kwargs`` are the constructor's (``model_name``, ``image_size``,
        ``batch_size``, ...); the model must match the weights."""
        return cls(state=load_checkpoint_state(path, use_ema=use_ema),
                   **kwargs)


def main(argv=None):
    """Inference CLI: ``python -m rtsds_tpu_torch.serve [--checkpoint PATH]
    img.png ...``.

    Decodes the images, resizes them to ``--size`` on the host, runs the
    predictor, and writes ``<name>_mask.png`` (trainIds) or
    ``<name>_color.png`` (colorized) into ``--out``.  Without
    ``--checkpoint`` the model runs from random init.
    """
    import argparse

    from PIL import Image

    from rtsds_tpu_torch.data.pipeline import decode_image

    parser = argparse.ArgumentParser(
        description="RTSDS real-time segmentation inference (PyTorch/CUDA)")
    parser.add_argument("images", nargs="*", help="input image paths (PNG)")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="a ModelCheckpoint directory (best, else "
                             "latest epoch; EMA weights preferred) or an "
                             "export_torch .pth")
    parser.add_argument("--model", type=str, default="bisenet",
                        choices=["bisenet", "deeplab"])
    parser.add_argument("--backbone", type=str, default="resnet18")
    parser.add_argument("--size", type=str, default="1024, 2048",
                        help='inference size "H, W"; frames are resized '
                             "to it")
    parser.add_argument("--out", type=str, default=".",
                        help="output directory")
    parser.add_argument("--colored", action="store_true",
                        help="write colorized masks instead of trainIds")
    parser.add_argument("--correct_preprocessing", action="store_true",
                        help="standard /255 preprocessing (must match how "
                             "the checkpoint was trained)")
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
    for flag in ("--export", "--artifact", "--mesh", "--quantize"):
        parser.add_argument(flag, type=str, default=None,
                            help="not yet ported")
    args = parser.parse_args(argv)

    for flag in ("export", "artifact", "mesh", "quantize"):
        if getattr(args, flag) is not None:
            parser.error(f"--{flag} is not yet ported to rtsds_tpu_torch")
    if not args.images:
        parser.error("no input images given")
    if args.checkpoint is not None and not os.path.exists(args.checkpoint):
        parser.error(f"--checkpoint {args.checkpoint} does not exist")

    size = tuple(parse_int_list(args.size))
    frames = np.stack([decode_image(p, size) for p in args.images])
    kwargs = dict(
        model_name=args.model, image_size=size,
        batch_size=min(len(args.images), 8), num_classes=args.num_classes,
        backbone=args.backbone,
        correct_preprocessing=args.correct_preprocessing,
        protocol=args.protocol,
        protocol_kwargs=protocol_kwargs_from_flags(
            args.protocol, args.scales, args.window, args.stride,
            args.window_chunk),
        device=args.device)
    if args.checkpoint:
        predictor = Predictor.from_checkpoint(args.checkpoint, **kwargs)
    else:
        print("serve: no --checkpoint given, running from RANDOM init")
        predictor = Predictor(**kwargs)
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
