"""Inference and PNG mask export (counterpart of ``eelunet_tpu/cli/predict.py``;
reference test.py:33-128).

    python -m eelunet_tpu_torch.cli.predict --model_type eelunet --data_dir D \\
        --image_size 512 --batch_size 16 --set model.dtype=bfloat16 \\
        --checkpoint checkpoints/eelunet/eelunet_best.npz [--set tta=true]
    # native resolution, by overlapping tiles:
    ... --tile 512 --tile_overlap 64

Masks are written as L-mode PNGs ``pred_{i}.png`` into
``results_dir/<model>_<timestamp>``: {0, 255} for a binary model, raw class
ids for a multi-class one (``model.out_channels > 1``). The model is the
Predictor's (``inference.py``): BN folded where the family folds, in
``model.dtype``. ``--checkpoint`` takes what ``cli.evaluate`` takes: a best
tag (upstream-layout ``.npz``/``.pth``) or a full snapshot.

Resize mode (default): the split is resized to ``data.image_size``, goes
through the device-side input chain of ``cli.train`` (the uint8 scale, the
Canny augmentations when their flags are on), then the forward, with flip
TTA when ``tta`` is set. Tiled mode (``--tile``): each image at its own
size through ``Predictor.predict_tiled``; the Canny flags are refused there.
``--quantize int8`` runs the W8A8 model (``quantize.py``). A slim checkpoint
(``cli.prune --physical``'s ``<out>_slim``) is served by its slim module,
unfolded; the Canny flags are refused there, as in the JAX package. Runs
on the CUDA card; ``--device cpu`` is the only way onto the CPU. The last
line is the run's ``kernel launches:``.

With more than one card (or ``--set mesh.data_axis=N``) each batch is split
across the cards of the process (``Predictor(mesh=...)``). Under ``torchrun``
every rank predicts on its own card and only rank 0 writes and prints.
"""

from __future__ import annotations

import dataclasses
import json
import os
from datetime import datetime

import numpy as np

from eelunet_tpu_torch.cli.common import (
    base_parser,
    kernel_launches,
    load_config,
    make_folder_dataset,
    slim_config,
    wants_raw_images,
)
from eelunet_tpu_torch.parallel.distributed import (
    init_distributed,
    is_primary,
    shutdown_distributed,
)


def say(*args, **kwargs) -> None:
    """``print`` on rank 0 (every print of a single-process run)."""
    if is_primary():
        print(*args, **kwargs)


def save_mask(pred01: np.ndarray, path: str, multiclass: bool = False) -> None:
    """(H,W) binary mask -> {0,255} L-mode PNG (test.py:23-31); a multi-class
    class-id map is stored as raw ids (what the multi-class folder dataset
    reads back)."""
    from PIL import Image

    arr = pred01 if multiclass else pred01 * 255
    Image.fromarray(arr.astype(np.uint8), mode="L").save(path)


def _out_dir(args, cfg) -> str:
    out = os.path.join(args.results_dir,
                       f"{cfg.model.name}_{datetime.now().strftime('%Y%m%d_%H%M%S')}")
    if is_primary():
        os.makedirs(out, exist_ok=True)
    return out


def _save(pred01: np.ndarray, path: str, multiclass: bool) -> None:
    if is_primary():  # under a process group only rank 0 writes
        save_mask(pred01, path, multiclass)


def _predictor(args, cfg, model_cfg):
    from eelunet_tpu_torch.cli.common import serving_mesh
    from eelunet_tpu_torch.inference import Predictor
    from eelunet_tpu_torch.parallel.distributed import process_count

    d = cfg.data
    mesh = serving_mesh(cfg, args.device) if process_count() == 1 else None
    return Predictor(model_cfg, checkpoint=args.checkpoint, threshold=cfg.threshold,
                     tta=cfg.tta, normalize_mean=tuple(d.normalize_mean),
                     normalize_std=tuple(d.normalize_std), mesh=mesh,
                     quantize=args.quantize or None, device=args.device)


def _predict_tiled(args, cfg) -> str:
    """Native-resolution masks: each image is decoded at its own size (not
    resized to data.image_size) and swept by overlapping ``--tile`` windows,
    so the mask matches the source image pixel for pixel."""
    from eelunet_tpu_torch.data.dataset import SegmentationFolderDataset

    if wants_raw_images(cfg.data):
        raise ValueError(
            "add_canny_edge/canny_enhance are not supported with --tile "
            "(the augment chain runs at the training resolution); predict "
            "without tiling or disable the augment flags.")
    d = cfg.data
    ds = SegmentationFolderDataset(d.data_dir, args.split, image_size=None, as_uint8=True,
                                   normalize_mean=d.normalize_mean,
                                   normalize_std=d.normalize_std)
    predictor = _predictor(args, cfg, cfg.model)
    out_dir = _out_dir(args, cfg)
    for i in range(len(ds)):
        image, _ = ds[i]
        mask = predictor.predict_tiled(image[None], tile=args.tile, overlap=args.tile_overlap)
        _save(mask[0, :, :, 0], os.path.join(out_dir, f"pred_{i}.png"),
              multiclass=cfg.model.out_channels > 1)
    say(f"Saved {len(ds)} native-resolution masks to {out_dir}")
    return out_dir


def _predict_resized(args, cfg) -> str:
    from eelunet_tpu_torch.data.augment import make_input_preprocess
    from eelunet_tpu_torch.data.pipeline import DataLoader, prefetch_to_device

    d = cfg.data
    model_cfg = cfg.model
    if d.add_canny_edge and model_cfg.in_channels == 3:
        # The edge map is a 4th input channel (AddCannyEdge.py:8-41).
        model_cfg = dataclasses.replace(model_cfg, in_channels=4)
    predictor = _predictor(args, cfg, model_cfg)
    preprocess = make_input_preprocess(d, model_cfg.out_channels)
    ds = make_folder_dataset(d, args.split, model_cfg.out_channels)
    loader = DataLoader(ds, d.batch_size, num_workers=d.num_workers, drop_remainder=False)
    out_dir = _out_dir(args, cfg)
    i = 0
    for images, labels in prefetch_to_device(loader, predictor.device, d.prefetch_depth):
        x, _ = preprocess(images, labels)
        masks = predictor.predict(x)
        for b in range(masks.shape[0]):
            _save(masks[b, :, :, 0], os.path.join(out_dir, f"pred_{i}.png"),
                  multiclass=model_cfg.out_channels > 1)
            i += 1
    say(f"Saved {i} masks to {out_dir}")
    return out_dir


def main(argv=None):
    p = base_parser("Run inference and export predicted masks as PNGs (PyTorch + CUDA)")
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--results_dir", type=str, default="results")
    p.add_argument("--tile", type=int, default=0,
                   help="sliding-window inference at NATIVE image resolution with this "
                   "tile size (0 = off, resize to data.image_size like the reference)")
    p.add_argument("--tile_overlap", type=int, default=64,
                   help="overlap between adjacent tiles (blended seam-free)")
    p.add_argument("--quantize", type=str, default="", choices=["", "int8"],
                   help="int8: W8A8 dynamic-scale convs and dots (eelunet_tpu_torch.quantize)")
    args = p.parse_args(argv)
    cfg = load_config(args)

    if not os.path.exists(args.checkpoint):
        raise FileNotFoundError(f"Checkpoint not found: {args.checkpoint}")  # test.py:86
    from eelunet_tpu_torch.prune_physical import is_slim_checkpoint

    if is_slim_checkpoint(args.checkpoint) and not args.tile:
        # the model the sidecar names; the Predictor builds it unfolded
        cfg = slim_config(cfg, args.checkpoint, "predict")
    init_distributed(device=args.device)
    out_dir = _predict_tiled(args, cfg) if args.tile else _predict_resized(args, cfg)
    say("kernel launches: " + json.dumps(kernel_launches()), flush=True)
    shutdown_distributed()
    return out_dir


if __name__ == "__main__":
    main()
