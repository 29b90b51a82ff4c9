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
deeplab] [--protocol sliding] [--quantize int8] [--out DIR] [--colored]``
decodes PNG frames, resizes them to ``--size`` and serves them; without
``--checkpoint`` it runs from random init.  ``quantize="int8"`` serves the
W8A8 quantized model (``ops/quant.py``), under any protocol.
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
from rtsds_tpu_torch.ops.quant import QuantizedSegmentor, quantize_model
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
      quantize: ``"int8"`` serves through the W8A8 post-training quantized
        path (``ops/quant.py``, ``models/bisenet_int8.py``,
        ``models/deeplab_int8.py``: BN folded, the policy's convs as int8
        GEMMs with int32 accumulation, the rest in bf16).  Needs
        ``calib_frames`` or ``act_scales``.
      calib_frames: (N, H, W, 3) uint8 frames, used once at construction to
        calibrate the static activation scales; they go through the
        production preprocess, in chunks of ``batch_size`` (the last chunk
        wraps around to the first frames).
      calib_stat: the activation-scale statistic, ``"max"`` (max-abs) or
        ``"percentile"`` (outlier-robust; ``ops/quant.py:calibrate_net``).
      calib_percentile: the percentile of ``calib_stat="percentile"``.
      act_scales: precomputed ``{conv_name: scale}`` activation scales (a
        QAT run's ``qat_act_scales.json``, which :meth:`from_checkpoint`
        reads); no calibration then.  They must name exactly the model's
        convs: an unknown or missing name raises, so no conv is ever served
        in bf16 by accident.
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
                 quantize: str | None = None, calib_frames=None,
                 calib_stat: str = "max", calib_percentile: float = 99.9,
                 act_scales: dict | None = None, mesh=None, device=None):
        if model_name not in ("bisenet", "deeplab"):
            raise ValueError(model_name)
        if protocol not in ("plain", "ensemble", "sliding"):
            raise ValueError(f"unknown serving protocol {protocol!r}")
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r} "
                             f"(supported: 'int8')")
        if quantize and calib_frames is None and act_scales is None:
            raise ValueError(
                "quantize='int8' needs calib_frames (a few representative "
                "(N, H, W, 3) uint8 frames to calibrate the static "
                "activation scales) or precomputed act_scales")
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
        self.quantize = quantize
        if quantize:
            self.model = self._quantized(model_name, model.state_dict(),
                                         calib_frames, calib_stat,
                                         calib_percentile, act_scales)
        else:
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

    def _normalized(self, frames: np.ndarray) -> torch.Tensor:
        """(N, H, W, 3) uint8 host frames -> normalized float32 (N, 3, H,
        W) on the device."""
        x = torch.from_numpy(frames).to(self.device)
        return normalize(x, self.correct_preprocessing).permute(0, 3, 1, 2)

    def _quantized(self, model_name: str, state: dict, calib_frames,
                   calib_stat: str, calib_percentile: float,
                   act_scales: dict | None) -> QuantizedSegmentor:
        """The int8 model of ``state`` on the device
        (``ops/quant.py:quantize_model``), its scales ``act_scales`` or
        calibrated on ``calib_frames`` in chunks of the serving batch; the
        scales served are kept as ``act_scales``."""
        chunks = []
        if act_scales is None:
            calib = np.asarray(calib_frames, dtype=np.uint8)
            if calib.ndim == 3:
                calib = calib[None]
            # the tail wraps around: repeated frames cannot change a max,
            # and barely reweight a percentile
            if calib.shape[0] > self.batch_size:
                pad = (-calib.shape[0]) % self.batch_size
                if pad:
                    calib = np.concatenate([calib, calib[:pad]])
            chunks = [calib[i:i + self.batch_size]
                      for i in range(0, calib.shape[0], self.batch_size)]
        model = quantize_model(
            model_name, state, (self._normalized(c) for c in chunks),
            calib_stat=calib_stat, calib_percentile=calib_percentile,
            device=self.device, act_scales=act_scales)
        self.act_scales = model.act_scales
        return model

    @torch.inference_mode()
    def _predict(self, frames: np.ndarray) -> torch.Tensor:
        """(N, H, W, 3) uint8 host frames -> (N, H, W) uint8 device masks.
        A protocol resizes and slices the float32 frames and casts each
        forward's input to the model's dtype."""
        x = self._normalized(frames)
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
                        use_qat_scales: bool = True,
                        **kwargs) -> "Predictor":
        """A predictor of the weights at ``path``: a port checkpoint
        directory (best epoch, else latest; the ``model`` or ``generator``
        item; the ``ema`` item's weights unless ``use_ema=False``) or an
        ``export_torch`` file, read by :func:`load_checkpoint_state`.
        ``kwargs`` are the constructor's (``model_name``, ``image_size``,
        ``batch_size``, ...); the model must match the weights.

        A QAT write-back checkpoint (``python -m rtsds_tpu_torch.qat``)
        carries a ``qat_act_scales.json`` sidecar; with ``quantize='int8'``
        its scales are served, so the deployed grid is the one the weights
        were tuned for.  The sidecar takes precedence over ``calib_frames``
        and ``calib_stat``; ``use_qat_scales=False`` (the CLI's
        ``--recalibrate``) ignores it, and an explicit ``act_scales``
        serves another grid."""
        if (use_qat_scales and kwargs.get("quantize")
                and "act_scales" not in kwargs):
            from rtsds_tpu_torch.train.qat import load_act_scales

            sidecar = load_act_scales(path) if os.path.isdir(path) else None
            if sidecar is not None:
                scales, meta = sidecar
                kwargs["act_scales"] = scales
                print(f"serving the QAT activation scales from {path} "
                      f"({meta.get('calib_stat')} calibration, "
                      f"{len(scales)} convs)")
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
    parser.add_argument("--quantize", type=str, default=None,
                        choices=["int8"],
                        help="serve through the W8A8 post-training "
                             "quantized path (activation scales are "
                             "calibrated on the given input images)")
    parser.add_argument("--calib_stat", type=str, default="max",
                        choices=["max", "percentile"],
                        help="activation-scale statistic for --quantize: "
                             "max-abs or an outlier-robust percentile")
    parser.add_argument("--calib_percentile", type=float, default=99.9,
                        help="percentile for --calib_stat percentile")
    parser.add_argument("--recalibrate", action="store_true",
                        help="ignore a QAT act-scales sidecar in the "
                             "checkpoint and recalibrate from the input "
                             "images (otherwise the sidecar takes "
                             "precedence over --calib_stat/"
                             "--calib_percentile)")
    for flag in ("--export", "--artifact", "--mesh"):
        parser.add_argument(flag, type=str, default=None,
                            help="not yet ported")
    args = parser.parse_args(argv)

    for flag in ("export", "artifact", "mesh"):
        if getattr(args, flag) is not None:
            parser.error(f"--{flag} is not yet ported to rtsds_tpu_torch")
    if not args.images:
        if args.quantize:
            parser.error("--quantize needs input images to calibrate the "
                         "activation scales")
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
    if args.quantize:
        kwargs.update(quantize=args.quantize, calib_frames=frames,
                      calib_stat=args.calib_stat,
                      calib_percentile=args.calib_percentile)
        if args.recalibrate and args.checkpoint:
            # without a checkpoint there is no sidecar to ignore
            kwargs["use_qat_scales"] = False
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
