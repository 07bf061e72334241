"""Deployment artifacts: ``torch.export`` programs with baked weights
(counterpart of ``eelunet_tpu/export.py``).

``export_model`` exports the uint8-in -> probabilities-out forward once per
batch bucket and saves it; the artifact directory is a complete deployment
unit that runs without the model code. Weights, the /255 scale, ImageNet
normalisation and the sigmoid/softmax head are baked into each program.

Artifact layout:
    <dir>/meta.json        the JAX package's keys: model, image_size,
                           batch_sizes, platforms, input, output, quantize
    <dir>/b<N>.pt2         one ``torch.export`` program per bucket

``platforms`` names the device the programs were exported for ("cuda" or
"cpu"); ``ExportedModel`` runs them there. As in the JAX package, the export
pins the EELUnet's high-pass to the plain low-rank formula
(``highpass_impl="lowrank"``): the ctypes-bound CUDA kernels cannot be
traced, so no hand-written kernel enters an artifact. ``quantize="int8"``
bakes in the W8A8 model of ``quantize.py`` (``torch._int_mm`` on the card).
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


def export_model(
    model_cfg,
    checkpoint: Optional[str],
    image_size: Tuple[int, int],
    batch_sizes: Sequence[int] = (1, 8),
    out_dir: str = "exported",
    normalize_mean: Sequence[float] = (0.485, 0.456, 0.406),
    normalize_std: Sequence[float] = (0.229, 0.224, 0.225),
    quantize: Optional[str] = None,
    device=None,
) -> str:
    """Export uint8 -> probabilities programs for each batch bucket, with
    the model the Predictor serves (BN folded where the family folds, slim
    checkpoints unfolded, ``model_cfg.dtype``; None = seeded random init),
    on ``device`` (None = "cuda")."""
    from eelunet_tpu_torch.inference import Predictor

    if quantize not in (None, "", "none", "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}; use 'int8'")
    quantize = quantize if quantize == "int8" else None
    if getattr(model_cfg, "highpass_impl", None) in (None, "auto", "pallas"):
        # The ctypes-bound kernels do not trace; the low-rank formula is the
        # plain twin of the same function.
        model_cfg = dataclasses.replace(model_cfg, highpass_impl="lowrank")
    predictor = Predictor(model_cfg, checkpoint=checkpoint,
                          normalize_mean=tuple(normalize_mean),
                          normalize_std=tuple(normalize_std), quantize=quantize, device=device)
    h, w = image_size
    wrapper = _UInt8Forward(predictor.model, predictor.meta, tuple(normalize_mean),
                            tuple(normalize_std), predictor.dtype).to(predictor.device).eval()
    os.makedirs(out_dir, exist_ok=True)
    buckets = sorted(set(int(b) for b in batch_sizes))
    n_out = None
    for b in buckets:
        example = torch.zeros((b, h, w, 3), dtype=torch.uint8, device=predictor.device)
        with torch.no_grad():
            program = torch.export.export(wrapper, (example,), strict=False)
        torch.export.save(program, os.path.join(out_dir, f"b{b}.pt2"))
        n_out = _out_channels(program)
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump({
            "model": model_cfg.name,
            "image_size": [h, w],
            "batch_sizes": buckets,
            "platforms": [predictor.device.type],
            "input": "uint8 (B,H,W,3); scale+ImageNet-normalize baked in",
            "output": f"float32 probabilities (B,H,W,{n_out})",
            "quantize": quantize,
        }, f, indent=2)
    return out_dir


def _out_channels(program) -> int:
    """The C of a program's (B,H,W,C) output, from its graph."""
    out = next(n for n in program.graph.nodes if n.op == "output")
    return int(out.args[0][0].meta["val"].shape[-1])


def read_meta(artifact_dir: str) -> dict:
    """An artifact's ``meta.json``."""
    with open(os.path.join(artifact_dir, _META)) as f:
        return json.load(f)


class ExportedModel:
    """Runs a directory of exported programs on the device they were
    exported for; pads ragged batches up to the next exported bucket (rows
    discarded), like ``inference.Predictor``. Needs no model code."""

    def __init__(self, artifact_dir: str):
        self.meta = read_meta(artifact_dir)
        self.device = torch.device(self.meta["platforms"][0])
        self._fns = {}
        for b in self.meta["batch_sizes"]:
            program = torch.export.load(os.path.join(artifact_dir, f"b{b}.pt2"))
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
