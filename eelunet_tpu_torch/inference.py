"""Batch inference API (counterpart of ``eelunet_tpu/inference.py``).

Loads a checkpoint once, folds BN, casts the weights to the serving dtype on
the device, and serves numpy-in / numpy-out batch prediction in the JAX
package's layout: (B,H,W,3) images in, (B,H,W,1) out. A slim (physically
pruned) checkpoint swaps in its slim module, unfolded; ``quantize="int8"``
runs the W8A8 model of ``quantize.py``. With a mesh, a batch is split
across the devices of its ``data`` axis, one served replica on each.
"""

from __future__ import annotations

import copy
import os
from contextlib import nullcontext
from typing import Any, Optional, Tuple

import numpy as np
import torch

from eelunet_tpu_torch.bnfold import FOLDABLE_MODELS, fold_bn_eval
from eelunet_tpu_torch.data.augment import normalize_imagenet
from eelunet_tpu_torch.models.convert import load_upstream_checkpoint
from eelunet_tpu_torch.nn.layers import init_weights, nchw, nhwc
from eelunet_tpu_torch.registry import (
    create_model,
    model_dtype,
    predict_probabilities,
    resolve_device,
    seg_probabilities,
)


def _probs_to_mask(probs: np.ndarray, threshold: float) -> np.ndarray:
    """(B,H,W,C) probabilities -> (B,H,W,1) mask: thresholded binary for
    C == 1, argmax class ids for multi-class."""
    if probs.shape[-1] > 1:
        return np.argmax(probs, axis=-1)[..., None].astype(np.float32)
    return (probs > threshold).astype(np.float32)


def read_checkpoint(path: str, model_name: str):
    """The port's unfolded ``state_dict`` from a checkpoint of family
    ``model_name``: an upstream-layout state dict (``.npz`` or ``.pth``,
    such as a best tag of ``cli.train``), or a full snapshot of the port (a
    ``<name>_epoch_N``/``<name>_last`` directory or its ``state.pt``)."""
    if os.path.isdir(path):
        path = os.path.join(path, "state.pt")
    if path.endswith(".pt"):
        return torch.load(path, map_location="cpu", weights_only=True)["model"]
    return load_upstream_checkpoint(path, model_name)


def random_state_dict(model_cfg, seed: int = 0, widths=None):
    """A seeded random-init (unfolded, float32, CPU) ``state_dict``."""
    model, _ = create_model(model_cfg, widths=widths)
    return init_weights(model, torch.Generator().manual_seed(seed)).state_dict()


def build_serving_model(state_dict, model_cfg, device, fold_bn: Optional[bool] = None,
                        widths=None) -> torch.nn.Module:
    """An eval-mode model on ``device`` in ``model_cfg.dtype`` and
    channels_last, from an unfolded float32 port ``state_dict``. With
    ``fold_bn`` the conv-adjacent BNs are folded first (``bnfold.py``);
    None folds the families that have a fold map (``FOLDABLE_MODELS``)."""
    n_folded = 0
    if fold_bn is None:
        fold_bn = model_cfg.name in FOLDABLE_MODELS
    if fold_bn:
        state_dict, n_folded = fold_bn_eval(state_dict, model_cfg.name)
    model, _ = create_model(model_cfg, bn_folded=n_folded > 0, device="meta", widths=widths)
    model.load_state_dict(state_dict, strict=True, assign=True)
    model = model.to(device=device, dtype=model_dtype(model_cfg),
                     memory_format=torch.channels_last)
    return model.eval().requires_grad_(False)


class Predictor:
    def __init__(
        self,
        model_cfg,
        checkpoint: Optional[str] = None,
        threshold: float = 0.5,
        bucket_batches: bool = True,
        normalize_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406),
        normalize_std: Tuple[float, float, float] = (0.229, 0.224, 0.225),
        mesh=None,
        tta: bool = False,
        quantize: Optional[str] = None,
        proba_wire_dtype: Optional[str] = "auto",
        fold_bn: Any = "auto",
        device=None,
    ):
        """``checkpoint``: an upstream-layout state dict of the family
        ``model_cfg.name`` (``.npz`` from ``python -m
        eelunet_tpu.cli.export_torch --numpy`` or a port best tag, or
        ``.pth``) or a full snapshot of the port (``read_checkpoint``);
        None = seeded random init (seed 0).

        ``bucket_batches`` pads each batch up to a bucket size (the next
        power of two up to 16, then the next multiple of 16) and slices the
        outputs back, so ragged serving traffic sees a bounded set of shapes.
        Padding rows are zeros; their outputs are discarded.

        ``proba_wire_dtype``: dtype of predict_proba's device->host copy.
        "auto" ships bfloat16 for bfloat16-compute models (their logits are
        bf16 already); the returned array is float32 either way.

        ``device``: torch device; None = "cuda". Without a card that raises
        a RuntimeError: the CPU is taken only when asked for (``"cpu"``).

        ``quantize="int8"``: every eligible conv and dot of the served model
        (the folded one, as in the JAX package) runs W8A8 with dynamic
        activation scales (``quantize.py``); ``quant_stats`` holds the
        quantized op counts of the latest forward.

        A slim (physically pruned) ``checkpoint``, a directory with
        ``widths.json`` (``cli.prune --physical``), swaps in its slim module,
        left unfolded as in the JAX package.

        ``mesh`` (``parallel/mesh.create_mesh``, one process): batch-parallel
        serving over the devices of its ``data`` axis (JAX
        ``inference.py:70-111, 255-280``). Each device holds a replica of the
        served model (folded, quantized or slim, as on one device); the
        bucket is rounded up to a multiple of the data size, and each equal
        shard is uploaded to its device and runs there on that device's
        current stream; ``collect`` gathers the shards in order. A device
        may be listed twice. ``device`` is then the mesh's first device."""
        self.devices = None
        if mesh is not None:
            from eelunet_tpu_torch.parallel.mesh import NOT_PORTED_AXES

            if mesh.shape["model"] > 1 or mesh.shape["spatial"] > 1:
                raise NotImplementedError(NOT_PORTED_AXES)
            self.devices = [resolve_device(d) for d in mesh.data_devices]
            device = self.devices[0]
        if quantize not in (None, "", "none", "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}; use 'int8'")
        self.quantize = "int8" if quantize == "int8" else None
        self.quant_stats: Optional[dict] = {} if self.quantize else None
        self.model_cfg = model_cfg
        self.device = resolve_device(device)
        if self.devices is None:
            self.devices = [self.device]
        self.data_size = len(self.devices)
        self.dtype = model_dtype(model_cfg)
        self.threshold = threshold
        self.bucket_batches = bucket_batches
        self.tta = tta
        self.mean = tuple(normalize_mean)
        self.std = tuple(normalize_std)
        self.out_channels = int(getattr(model_cfg, "out_channels", 1) or 1)
        if fold_bn == "auto":
            self._fold_bn = model_cfg.name in FOLDABLE_MODELS
        else:
            self._fold_bn = bool(fold_bn)
            if self._fold_bn and model_cfg.name not in FOLDABLE_MODELS:
                raise ValueError(f"fold_bn=True: no BN fold map for '{model_cfg.name}' "
                                 f"(supported: {FOLDABLE_MODELS})")
        _, self.meta = create_model(model_cfg, device="meta")

        if proba_wire_dtype == "auto":
            self._proba_wire = torch.bfloat16 if self.dtype == torch.bfloat16 else None
        elif proba_wire_dtype in (None, "", "none", "float32"):
            self._proba_wire = None
        elif proba_wire_dtype in ("bfloat16", "bf16"):
            self._proba_wire = torch.bfloat16
        else:
            raise ValueError(f"unknown proba_wire_dtype {proba_wire_dtype!r}; "
                             "use 'auto', 'float32' or 'bfloat16'")

        if checkpoint:
            self.load(checkpoint)
        else:
            self.commit(self.stage_state_dict(random_state_dict(model_cfg)))

    # -- weights -------------------------------------------------------------

    def stage_state_dict(self, state_dict, widths=None, fold_bn=None) -> torch.nn.Module:
        """Fold, build, cast (and with ``quantize`` quantize) a model from an
        unfolded port state_dict on the host, WITHOUT touching the live one
        (no CUDA call). ``widths``: a slim model's. Returns the handle for
        ``commit``."""
        model = build_serving_model(state_dict, self.model_cfg, "cpu",
                                    self._fold_bn if fold_bn is None else fold_bn, widths)
        if self.quantize:
            from eelunet_tpu_torch.quantize import quantize_model

            model = quantize_model(model, stats=self.quant_stats)
        return model

    def stage(self, checkpoint: str) -> torch.nn.Module:
        """Phase 1 of a (hot) reload: read, convert and fold a checkpoint
        off the serving path. A slim checkpoint builds its slim module,
        unfolded (JAX ``inference.py:209-252``)."""
        from eelunet_tpu_torch.prune_physical import is_slim_checkpoint, read_slim

        if is_slim_checkpoint(checkpoint):
            name, widths, sd = read_slim(checkpoint)
            if name != self.model_cfg.name:
                raise ValueError(f"{checkpoint} holds a slim {name!r} model; this Predictor "
                                 f"serves {self.model_cfg.name!r}")
            return self.stage_state_dict(sd, widths=widths, fold_bn=False)
        return self.stage_state_dict(read_checkpoint(checkpoint, self.model_cfg.name))

    def commit(self, staged: torch.nn.Module) -> None:
        """Phase 2: upload the staged model, one replica per device, and
        swap them in. Concurrent callers serialise this with dispatches (the
        MicroBatcher's device lock); batches already dispatched hold the old
        model's tensors and complete unaffected."""
        # copied on the host; the copies share the quantized model's op counts
        keep = {id(self.quant_stats): self.quant_stats}
        models = [staged] + [copy.deepcopy(staged, dict(keep)) for _ in self.devices[1:]]
        self.replicas = [m.to(d) for m, d in zip(models, self.devices)]
        self.model = self.replicas[0]

    def load(self, checkpoint: str) -> None:
        self.commit(self.stage(checkpoint))

    # -- device programs -----------------------------------------------------

    def _probs(self, x: torch.Tensor, model: Optional[torch.nn.Module] = None) -> torch.Tensor:
        """NHWC images on ``model``'s device (None: the first replica's) ->
        NHWC float32 probabilities."""
        if model is None:
            model = self.model
        if x.dtype == torch.uint8:
            # uint8 serving input: scale + ImageNet-normalise on the device
            x = normalize_imagenet(x.float() / 255.0, self.mean, self.std)
        else:
            x = x.float()

        def fwd(imgs):
            out = model(nchw(imgs).to(self.dtype))
            return nhwc(seg_probabilities(out, self.meta))

        return predict_probabilities(fwd, x, tta=self.tta)

    @staticmethod
    def _upload(images, device: torch.device) -> torch.Tensor:
        if isinstance(images, torch.Tensor):
            return images.to(device)
        t = torch.from_numpy(np.ascontiguousarray(images))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    def _dispatch(self, images, threshold: Optional[float] = None):
        """Pad to the batch bucket, upload and enqueue the forward, one
        equal shard per device. Returns ``(device_outs, b)`` without waiting
        for the devices: the caller can dispatch the next batch before
        collecting this one. ``images`` is a numpy array, or a tensor
        (already on a device: ``cli.predict`` feeds the output of the
        device-side input chain)."""
        on_device = isinstance(images, torch.Tensor)
        if not on_device:
            images = np.asarray(images)
        b = int(images.shape[0])
        target = b
        if self.bucket_batches and b > 0:
            target = 1 << (b - 1).bit_length() if b <= 16 else -(-b // 16) * 16
        if target > 0:  # equal shards on the data axis
            target = -(-target // self.data_size) * self.data_size
        if target != b:
            if on_device:
                images = torch.cat([images, images.new_zeros((target - b, *images.shape[1:]))])
            else:
                pad = np.zeros((target - b, *images.shape[1:]), dtype=images.dtype)
                images = np.concatenate([images, pad], axis=0)
        k = target // self.data_size
        outs = []
        with torch.inference_mode():
            for i, (model, dev) in enumerate(zip(self.replicas, self.devices)):
                with torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
                    probs = self._probs(self._upload(images[i * k:(i + 1) * k], dev), model)
                    if threshold is not None:  # mask program: 1 byte/pixel on the wire
                        if self.out_channels > 1:
                            out = probs.argmax(dim=-1, keepdim=True).to(torch.uint8)
                        else:
                            out = (probs > threshold).to(torch.uint8)
                    else:
                        out = probs if self._proba_wire is None else probs.to(self._proba_wire)
                outs.append(out)
        return outs, b

    # -- two-phase (dispatch/collect) API: collect(dispatch_x(b)) == predict_x(b)

    def dispatch_proba(self, images: np.ndarray):
        out, b = self._dispatch(images)
        return (out, b, "f32")

    def dispatch_mask_wire(self, images: np.ndarray, threshold: Optional[float] = None):
        thr = float(self.threshold if threshold is None else threshold)
        out, b = self._dispatch(images, thr)
        return (out, b, None)

    def collect(self, handle) -> np.ndarray:
        """Copy a dispatch_* result to the host, its shards in order (this
        waits for the devices), and apply the public dtype contract."""
        outs, b, post = handle
        arr = torch.cat([o.cpu() for o in outs])[:b]
        if post == "f32":
            return arr.float().numpy()
        return arr.numpy()

    def predict_proba(self, images: np.ndarray) -> np.ndarray:
        """(B,H,W,3) uint8 or ImageNet-normalised float32 images ->
        (B,H,W,C) float32 probabilities."""
        return self.collect(self.dispatch_proba(images))

    def predict_mask_wire(self, images: np.ndarray,
                          threshold: Optional[float] = None) -> np.ndarray:
        """(B,H,W,3) images -> (B,H,W,1) uint8 masks computed on the device:
        {0,1} for binary models, argmax class ids in multi-class mode."""
        return self.collect(self.dispatch_mask_wire(images, threshold))

    def predict(self, images: np.ndarray) -> np.ndarray:
        """Binary masks at the configured threshold (argmax ids when
        multi-class), (B,H,W,1) float32."""
        return self.predict_mask_wire(images).astype(np.float32)

    def predict_proba_tiled(
        self,
        images: np.ndarray,
        tile: int = 512,
        overlap: int = 64,
        tiles_per_batch: int = 16,
    ) -> np.ndarray:
        """Sliding-window inference at NATIVE resolution: images of any size
        run through the fixed ``tile``-shaped forward as overlapping windows,
        blended with a separable linear ramp over the ``overlap`` margin.
        Windows at the right/bottom edge shift back inside the image; images
        smaller than the tile are reflect-padded and cropped back. Returns
        (B, H, W, C) float32 probabilities."""
        if not 0 <= overlap < tile:
            raise ValueError(f"overlap {overlap} must be in [0, tile={tile})")
        images = np.asarray(images)
        b, h, w = images.shape[:3]
        ph, pw = max(tile - h, 0), max(tile - w, 0)
        if ph or pw:
            images = np.pad(images, [(0, 0), (0, ph), (0, pw), (0, 0)], mode="reflect")
        hp, wp = images.shape[1:3]

        stride = tile - overlap
        ys = self._tile_origins(hp, tile, stride)
        xs = self._tile_origins(wp, tile, stride)
        ramp = self._blend_window(tile, overlap)  # (tile, tile, 1) float32

        acc = None  # allocated after the first chunk (C = prob channels)
        wsum = np.zeros((hp, wp, 1), np.float32)
        tiles, origins = [], []
        for y in ys:
            for x in xs:
                wsum[y : y + tile, x : x + tile] += ramp
                for i in range(b):
                    tiles.append(images[i, y : y + tile, x : x + tile])
                    origins.append((i, y, x))
        for start in range(0, len(tiles), tiles_per_batch):
            chunk = np.stack(tiles[start : start + tiles_per_batch])
            probs = self.predict_proba(chunk)
            if acc is None:
                acc = np.zeros((b, hp, wp, probs.shape[-1]), np.float32)
            for (i, y, x), p in zip(origins[start : start + tiles_per_batch], probs):
                acc[i, y : y + tile, x : x + tile] += p * ramp
        return (acc / wsum)[:, :h, :w]

    def predict_tiled(self, images: np.ndarray, **kw) -> np.ndarray:
        return _probs_to_mask(self.predict_proba_tiled(images, **kw), self.threshold)

    @staticmethod
    def _tile_origins(size: int, tile: int, stride: int):
        if size <= tile:
            return [0]
        origins = list(range(0, size - tile + 1, stride))
        if origins[-1] != size - tile:
            origins.append(size - tile)
        return origins

    @staticmethod
    def _blend_window(tile: int, overlap: int) -> np.ndarray:
        """Separable blend weights: 1 in the tile interior, ramping linearly
        to ~0 over the overlap margin, strictly positive everywhere."""
        ramp1d = np.ones(tile, np.float32)
        if overlap > 0:
            edge = np.arange(1, overlap + 1, dtype=np.float32) / (overlap + 1)
            ramp1d[:overlap] = edge
            ramp1d[tile - overlap :] = edge[::-1]
        return (ramp1d[:, None] * ramp1d[None, :])[..., None]
