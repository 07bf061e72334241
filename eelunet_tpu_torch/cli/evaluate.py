"""Evaluation entry point (counterpart of ``eelunet_tpu/cli/evaluate.py``;
reference evaluate.py:126-203): loads a checkpoint, or warns and evaluates
the untrained model (evaluate.py:172-176), and prints the nine metrics.

    python -m eelunet_tpu_torch.cli.evaluate --model_type eelunet --data_dir D \\
        --image_size 512 --batch_size 8 --set model.dtype=bfloat16 \\
        --checkpoint checkpoints/eelunet/eelunet_best.npz

``--checkpoint`` takes what the port's ``cli.train`` writes: a best tag
(upstream-layout ``.npz``) or a full snapshot (``<name>_last/`` or its
``state.pt``). The data flags (``data.add_canny_edge``, ``data.canny_enhance``,
``data.uint8_feed``) act as in training: the batches go through the same
device-side input chain. Runs on the CUDA card; ``--device cpu`` is the only
way onto the CPU.
"""

from __future__ import annotations

import json
import os
from datetime import datetime

from eelunet_tpu_torch.cli.common import (
    base_parser,
    kernel_launches,
    load_config,
    make_folder_dataset,
)
from eelunet_tpu_torch.data.pipeline import DataLoader


def _load_weights(model, checkpoint: str, model_name: str) -> None:
    """Load a best tag (``.npz``/``.pth``, upstream layout) or a full
    snapshot (a ``<name>_epoch_N``/``<name>_last`` directory or its
    ``state.pt``) into ``model``, strictly."""
    import torch

    from eelunet_tpu_torch.models.convert import load_upstream_checkpoint

    if os.path.isdir(checkpoint):
        checkpoint = os.path.join(checkpoint, "state.pt")
    if checkpoint.endswith(".pt"):
        sd = torch.load(checkpoint, map_location="cpu", weights_only=True)["model"]
    else:
        sd = load_upstream_checkpoint(checkpoint, model_name)
    model.load_state_dict(sd, strict=True)


def main(argv=None):
    p = base_parser("Evaluate segmentation model and output metrics (PyTorch + CUDA)")
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--checkpoint", type=str, default="")
    args = p.parse_args(argv)
    cfg = load_config(args)
    if args.checkpoint and os.path.isfile(os.path.join(args.checkpoint, "widths.json")):
        raise NotImplementedError("slim (physically pruned) checkpoints are not ported to "
                                  "eelunet_tpu_torch yet; see ROADMAP.md")
    if cfg.model.out_channels > 1:
        raise NotImplementedError("multi-class evaluation (model.out_channels > 1) is not "
                                  "ported to eelunet_tpu_torch yet; see ROADMAP.md")

    from eelunet_tpu_torch.train.trainer import Trainer

    d = cfg.data
    ds = make_folder_dataset(d, args.split, cfg.model.out_channels)
    # Never drop tail samples: the metrics cover the whole split
    # (the reference's loader drops none either, evaluate.py:147).
    loader = DataLoader(ds, d.batch_size, num_workers=d.num_workers, drop_remainder=False)
    trainer = Trainer(cfg, device=args.device)
    state = trainer.init_state()
    if args.checkpoint and os.path.exists(args.checkpoint):
        _load_weights(state.model, args.checkpoint, trainer.cfg.model.name)
        print(f"Loaded model weights from {args.checkpoint}")
    elif args.checkpoint:
        print(f"Checkpoint not found at {args.checkpoint}. Evaluating untrained model.")

    print(f"Evaluation date: {datetime.now().strftime('%Y%m%d_%H%M%S')}")
    print(f"Model: {cfg.model.name}")
    m = trainer.evaluate(state, loader)
    print("Evaluation Metrics:")
    print(f"Pixel Accuracy: {m['pixel_accuracy']:.4f}")
    print(f"Precision: {m['precision']:.4f}")
    print(f"Recall: {m['recall']:.4f}")
    print(f"F1 Score: {m['f1_score']:.4f}")
    print(f"IoU (foreground): {m['iou']:.4f}")
    print(f"Dice Coefficient (foreground): {m['dice']:.4f}")
    print(f"Mean IoU: {m['miou']:.4f}")
    print(f"Boundary F1 Score: {m['boundary_f1']:.4f}")
    print(f"mDice: {m['mdice']:.4f}")
    # Unrounded, for scripts that compare a run with the training history.
    print("metrics: " + json.dumps(m))
    print("kernel launches: " + json.dumps(kernel_launches()), flush=True)
    return m


if __name__ == "__main__":
    main()
