"""Feature-map visualization CLI (counterpart of
``eelunet_tpu/cli/visualize.py``; reference utils/tools.py:12-123).

    python -m eelunet_tpu_torch.cli.visualize --model_type eelunet --data_dir D \\
        --image_size 512 --set model.dtype=bfloat16 \\
        --checkpoint checkpoints/eelunet/eelunet_best.npz [--max_depth 1]

The reference writes feature-map PNG grids from inside ``EELUnet.forward``
on every call (EELUnet.py:389-462). Here they are made offline on demand:
load a checkpoint (or visualize the untrained init, as evaluate.py:172-176
does), run one sample of ``--split`` through the model, and write one
channel-grid PNG per captured module output, plus the input image, the
probability map and the thresholded mask. For models with auxiliary heads
the seg-vs-edge contribution diagnostic (tools.py:422-470) is printed.

Forward hooks on ``named_modules()`` take the place of flax's
``capture_intermediates``: a module called N times gives ``~call{i}``
names, and one that returns several feature maps ``_out{i}`` suffixes.
Where a family's module names differ from flax's (U-Net's ``enc1`` is flax's
``ConvBlock_0``, EGE-UNet's ``encoder3.0`` its ``encoder3_conv``), the
top-level names are mapped to flax's through the family's weight-conversion
rules (``models/convert.RULES``), so the files carry the JAX package's names;
the levels below keep the port's. The input goes through the Trainer's
device-side preprocess, so the Canny flags act as in training (kernel 5 on
the card). Runs on the CUDA card; ``--device cpu`` is the only way onto the
CPU. The last line is the run's ``kernel launches:``.
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Dict, List, Optional

import numpy as np
import torch

from eelunet_tpu_torch.cli.common import (
    base_parser,
    kernel_launches,
    load_config,
    make_folder_dataset,
)
from eelunet_tpu_torch.utils.visualize import edge_seg_contribution, save_feature_grid, save_image


def flax_names(model_name: str) -> Dict[str, str]:
    """Port module path -> flax module name, for the shortest port prefixes
    whose weights all sit under one top-level flax module (empty for the
    EELUnet, whose port names are flax's)."""
    from eelunet_tpu_torch.models.convert import RULES

    if model_name not in RULES:
        return {}
    pairs = [(tp.split("."), fd.split("/")[0]) for fd, tp, _ in RULES[model_name]()]
    out = {}
    for parts, _ in pairs:
        for n in range(1, len(parts) + 1):
            tops = {top for p, top in pairs if p[:n] == parts[:n]}
            if len(tops) == 1:
                out[".".join(parts[:n])] = tops.pop()
                break
    return out


def jax_path(port_path: str, names: Dict[str, str]) -> Optional[str]:
    """The dotted flax path of a port module; None for a port container
    whose parts are separate flax modules."""
    parts = port_path.split(".")
    for n in range(len(parts), 0, -1):
        prefix = ".".join(parts[:n])
        if prefix in names:
            return ".".join([names[prefix], *parts[n:]])
    if any(k.startswith(port_path + ".") for k in names):
        return None
    return port_path


def _feature_arrays(output) -> List:
    """Flatten one captured output into nameable (suffix, tensor) feature
    maps: only spatial maps ((B,C,H,W) or (C,H,W)) become channel grids."""
    leaves = []

    def walk(o):
        if isinstance(o, torch.Tensor):
            leaves.append(o)
        elif isinstance(o, (tuple, list)):
            for v in o:
                walk(v)
        elif isinstance(o, dict):
            for k in sorted(o):
                walk(o[k])

    walk(output)
    arrays = [a for a in leaves if a.ndim in (3, 4)]
    if len(arrays) == 1:
        return [("", arrays[0])]
    return [(f"_out{i}", a) for i, a in enumerate(arrays)]


def capture_outputs(model: torch.nn.Module, model_name: str, forward, keep) -> Dict[str, list]:
    """Run ``forward()`` with forward hooks on every submodule of ``model``;
    returns {flax path: [output of each call]} for the paths ``keep``
    accepts."""
    names = flax_names(model_name)
    captured: Dict[str, list] = {}
    hooks = []
    for path, mod in model.named_modules():
        name = jax_path(path, names) if path else None
        if name is None or not keep(name):
            continue
        hooks.append(mod.register_forward_hook(
            lambda _m, _a, out, name=name: captured.setdefault(name, []).append(out)))
    try:
        out = forward()
    finally:
        for h in hooks:
            h.remove()
    return out, captured


def main(argv=None):
    p = base_parser("Dump per-module feature-map grids for one sample (PyTorch + CUDA)")
    p.add_argument("--checkpoint", type=str, default="",
                   help="optional; without it the untrained init is visualized")
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--index", type=int, default=0, help="sample index within the split")
    p.add_argument("--results_dir", type=str, default="visualizations")
    p.add_argument("--modules", type=str, default="",
                   help="comma-separated substring filters on dotted module "
                   "paths (e.g. 'enc1,edge'); default: everything at --max_depth")
    p.add_argument("--max_depth", type=int, default=1,
                   help="module-tree depth to visualize (1 = top-level blocks, "
                   "the reference's granularity; higher descends into submodules)")
    p.add_argument("--num_cols", type=int, default=8)
    args = p.parse_args(argv)
    cfg = load_config(args)

    from eelunet_tpu_torch.data.pipeline import to_device
    from eelunet_tpu_torch.inference import read_checkpoint
    from eelunet_tpu_torch.nn.layers import nchw, nhwc
    from eelunet_tpu_torch.registry import seg_probabilities
    from eelunet_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, device=args.device)
    state = trainer.init_state()
    if args.checkpoint and os.path.exists(args.checkpoint):
        state.model.load_state_dict(read_checkpoint(args.checkpoint, cfg.model.name),
                                    strict=True)
        print(f"Loaded model weights from {args.checkpoint}")
    elif args.checkpoint:
        print(f"Checkpoint not found at {args.checkpoint}. Visualizing untrained model.")

    ds = make_folder_dataset(cfg.data, args.split, cfg.model.out_channels)
    if not 0 <= args.index < len(ds):
        raise IndexError(f"--index {args.index} out of range for split "
                         f"{args.split!r} ({len(ds)} samples)")
    image, label = ds[args.index]
    images, labels = (to_device(a[None], trainer.device) for a in (image, label))

    filters = [f for f in args.modules.split(",") if f]

    def keep(name: str) -> bool:
        if filters:
            return any(f in name for f in filters)
        return name.count(".") + 1 <= args.max_depth

    model, meta = state.model.eval(), trainer.meta
    amp = trainer.amp_dtype

    @torch.no_grad()
    def forward():
        x, _ = trainer._preprocess(images, labels)
        with torch.autocast(x.device.type, dtype=amp or torch.float32, enabled=amp is not None):
            return model(nchw(x))

    out, captured = capture_outputs(model, cfg.model.name, forward, keep)

    out_dir = os.path.join(
        args.results_dir, f"{cfg.model.name}_{datetime.now().strftime('%Y%m%d_%H%M%S')}")
    os.makedirs(out_dir, exist_ok=True)

    # Input (the uint8 feed renders directly; float feeds are ImageNet-
    # normalized: render the raw dataset pixels instead).
    raw = np.asarray(image)
    save_image(raw if raw.dtype == np.uint8 else np.clip(
        raw * np.asarray(cfg.data.normalize_std) + np.asarray(cfg.data.normalize_mean), 0, 1
    ), os.path.join(out_dir, "input.png"))

    probs = nhwc(seg_probabilities(out, meta)).float().cpu().numpy()[0]
    if cfg.model.out_channels > 1:
        save_image(probs.max(axis=-1), os.path.join(out_dir, "probabilities.png"))
        mask = probs.argmax(axis=-1).astype(np.float32) / max(cfg.model.out_channels - 1, 1)
    else:
        save_image(probs[:, :, 0], os.path.join(out_dir, "probabilities.png"))
        mask = (probs[:, :, 0] > cfg.threshold).astype(np.float32)
    save_image(mask, os.path.join(out_dir, "mask.png"))

    n = 0
    for name in sorted(captured):
        calls = captured[name]
        for i, output in enumerate(calls):
            call = name if len(calls) == 1 else f"{name}~call{i}"
            for suffix, fm in _feature_arrays(output):
                fname = call.replace(".", "_") + suffix + ".png"
                save_feature_grid(fm, os.path.join(out_dir, fname), num_cols=args.num_cols,
                                  title=call + suffix)
                n += 1

    if out.aux and out.aux[-1].shape == out.seg.shape:
        contrib = edge_seg_contribution(seg_probabilities(out, meta), out.aux[-1])
        print("seg/edge contribution (tools.py:422-470): "
              f"seg {contrib['seg_out_contribution']:.1f}%  "
              f"edge {contrib['edge_out_contribution']:.1f}%  "
              f"equal {contrib['equal_elements']:.1f}%")

    print(f"Saved input/probabilities/mask + {n} feature grids to {out_dir}")
    print("kernel launches: " + json.dumps(kernel_launches()), flush=True)
    return out_dir


if __name__ == "__main__":
    main()
