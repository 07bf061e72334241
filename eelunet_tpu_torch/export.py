"""Deployment artifacts: ``torch.export`` programs with baked weights
(counterpart of ``eelunet_tpu/export.py``).

``export_model`` exports the uint8-in -> probabilities-out forward once per
batch bucket and platform and saves it; the artifact directory is a complete deployment
unit that runs without the model code. Weights, the /255 scale, ImageNet
normalisation and the sigmoid/softmax head are baked into each program.

Artifact layout:
    <dir>/meta.json            the JAX package's keys: model, image_size,
                               batch_sizes, platforms, input, output, quantize
    <dir>/b<N>.<platform>.pt2  one ``torch.export`` program per bucket and
                               platform ("cuda" or "cpu")

As the JAX package exports each bucket for ``tpu,cpu``, the port exports it
for ``cuda,cpu`` by default, so an artifact made on the card also serves on
a host without one. Each platform's programs are traced on that device,
with the model the Predictor builds there: ``torch.export`` bakes the
weights in as tensors of that device, and the int8 model its device's
``int8_mm`` route (``torch._int_mm`` on the card, the float64 twin on the
CPU). So exporting for "cuda" needs a card: a host without one has no CUDA
tensors to trace (fake tensors cannot be moved to a device that torch was
built without), and the export stops with that reason. ``ExportedModel``
runs the programs of the device it is given, the card by default, and
refuses a device the artifact lacks. An artifact of one platform with
``b<N>.pt2`` names (written before platforms were several) still loads.

As in the JAX package, the export pins the EELUnet's high-pass to the plain
low-rank formula (``highpass_impl="lowrank"``): the ctypes-bound CUDA
kernels cannot be traced, so no hand-written kernel enters an artifact.
``quantize="int8"`` bakes in the W8A8 model of ``quantize.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

_META = "meta.json"


class _UInt8Forward(torch.nn.Module):
    """(B,H,W,3) uint8 -> (B,H,W,C) float32 probabilities: /255, ImageNet
    normalisation, the model, its probability head."""

    def __init__(self, model, meta, mean, std, dtype):
        super().__init__()
        self.model, self.meta, self.dtype = model, meta, dtype
        # buffers, not data.augment's cached constants: a constant made while
        # export traces would be a fake tensor
        self.register_buffer("mean", torch.tensor(mean, dtype=torch.float32).view(1, 1, 1, -1))
        self.register_buffer("std", torch.tensor(std, dtype=torch.float32).view(1, 1, 1, -1))

    def forward(self, u8: torch.Tensor) -> torch.Tensor:
        # the Predictor's forward (inference.Predictor._probs), op for op
        from eelunet_tpu_torch.nn.layers import nchw, nhwc
        from eelunet_tpu_torch.registry import seg_probabilities

        x = (u8.float() / 255.0 - self.mean) / self.std
        return nhwc(seg_probabilities(self.model(nchw(x).to(self.dtype)), self.meta)).contiguous()


PLATFORMS = ("cuda", "cpu")


def export_model(
    model_cfg,
    checkpoint: Optional[str],
    image_size: Tuple[int, int],
    batch_sizes: Sequence[int] = (1, 8),
    out_dir: str = "exported",
    normalize_mean: Sequence[float] = (0.485, 0.456, 0.406),
    normalize_std: Sequence[float] = (0.229, 0.224, 0.225),
    platforms: Sequence[str] = PLATFORMS,
    quantize: Optional[str] = None,
) -> str:
    """Export uint8 -> probabilities programs for each batch bucket and each
    of ``platforms``, with the model the Predictor serves (BN folded where
    the family folds, slim checkpoints unfolded, ``model_cfg.dtype``; None =
    seeded random init)."""
    from eelunet_tpu_torch.inference import Predictor

    if quantize not in (None, "", "none", "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}; use 'int8'")
    quantize = quantize if quantize == "int8" else None
    platforms = list(dict.fromkeys(platforms))
    for platform in platforms:
        if platform not in PLATFORMS:
            raise ValueError(f"unknown platform {platform!r} (choices: {', '.join(PLATFORMS)})")
    if "cuda" in platforms and not torch.cuda.is_available():
        raise RuntimeError(
            "exporting for platform 'cuda' needs a CUDA card: each platform's programs are "
            "traced on its device, and this host has none. Export with --platforms cpu "
            "here, or on a machine with a card.")
    if getattr(model_cfg, "highpass_impl", None) in (None, "auto", "pallas"):
        # The ctypes-bound kernels do not trace; the low-rank formula is the
        # plain twin of the same function.
        model_cfg = dataclasses.replace(model_cfg, highpass_impl="lowrank")
    h, w = image_size
    os.makedirs(out_dir, exist_ok=True)
    buckets = sorted(set(int(b) for b in batch_sizes))
    n_out = None
    for platform in platforms:
        predictor = Predictor(model_cfg, checkpoint=checkpoint,
                              normalize_mean=tuple(normalize_mean),
                              normalize_std=tuple(normalize_std), quantize=quantize,
                              device=platform)
        wrapper = _UInt8Forward(predictor.model, predictor.meta, tuple(normalize_mean),
                                tuple(normalize_std), predictor.dtype).to(predictor.device).eval()
        for b in buckets:
            example = torch.zeros((b, h, w, 3), dtype=torch.uint8, device=predictor.device)
            with torch.no_grad():
                program = torch.export.export(wrapper, (example,), strict=False)
            torch.export.save(program, _program_path(out_dir, b, platform))
            n_out = _out_channels(program)
        del predictor, wrapper
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump({
            "model": model_cfg.name,
            "image_size": [h, w],
            "batch_sizes": buckets,
            "platforms": platforms,
            "input": "uint8 (B,H,W,3); scale+ImageNet-normalize baked in",
            "output": f"float32 probabilities (B,H,W,{n_out})",
            "quantize": quantize,
        }, f, indent=2)
    return out_dir


def _program_path(artifact_dir: str, bucket: int, platform: str) -> str:
    return os.path.join(artifact_dir, f"b{bucket}.{platform}.pt2")


def _out_channels(program) -> int:
    """The C of a program's (B,H,W,C) output, from its graph."""
    out = next(n for n in program.graph.nodes if n.op == "output")
    return int(out.args[0][0].meta["val"].shape[-1])


def read_meta(artifact_dir: str) -> dict:
    """An artifact's ``meta.json``."""
    with open(os.path.join(artifact_dir, _META)) as f:
        return json.load(f)


class ExportedModel:
    """Runs the programs that a directory holds for ``device`` (None = the
    card); pads ragged batches up to the next exported bucket (rows
    discarded), like ``inference.Predictor``. Needs no model code. A device
    whose platform the artifact lacks is refused."""

    def __init__(self, artifact_dir: str, device=None):
        from eelunet_tpu_torch.registry import resolve_device

        self.meta = read_meta(artifact_dir)
        self.device = resolve_device(device)
        platforms = list(self.meta["platforms"])
        platform = self.device.type
        if platform not in platforms:
            raise ValueError(
                f"{artifact_dir} holds programs for {', '.join(map(repr, platforms))}, not "
                f"for device {str(self.device)!r}: re-export it with --platforms {platform}, "
                f"or run it on {platforms[0]!r}")
        self._fns = {}
        for b in self.meta["batch_sizes"]:
            path = _program_path(artifact_dir, b, platform)
            if not os.path.exists(path) and platforms == [platform]:
                path = os.path.join(artifact_dir, f"b{b}.pt2")  # one platform, older names
            program = torch.export.load(path)
            self.out_channels = _out_channels(program)
            self._fns[b] = program.module()

    def predict_proba(self, images: np.ndarray) -> np.ndarray:
        """(B,H,W,3) uint8 -> (B,H,W,C) float32 probabilities."""
        images = np.asarray(images)
        if images.dtype != np.uint8:
            # The artifact bakes u8/255 + ImageNet-normalize into the
            # program; casting floats here would wrap negatives to ~255
            # and silently produce garbage.
            raise ValueError(
                f"exported artifacts take uint8 images, got {images.dtype}; "
                "pre-normalized float input needs the live Predictor")
        b = int(images.shape[0])
        buckets = [k for k in sorted(self._fns) if k >= b]
        if not buckets:
            raise ValueError(
                f"batch {b} exceeds largest exported bucket "
                f"{max(self._fns)}; re-export with a larger batch_sizes")
        target = buckets[0]
        if target != b:
            pad = np.zeros((target - b, *images.shape[1:]), np.uint8)
            images = np.concatenate([images, pad], axis=0)
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        with torch.no_grad():
            out = self._fns[target](x)
        return out[:b].cpu().numpy()
