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
device-side input chain. A slim checkpoint (``cli.prune --physical``'s
``<out>_slim``, detected by its ``widths.json``) is evaluated with its slim
module; the Canny flags are refused there, as in the JAX package. A
multi-class model (``--set model.out_channels=C``, masks of class ids)
prints the macro metrics, then a per-class table. Runs on the CUDA card;
``--device cpu`` is the only way onto the CPU. Under ``torchrun`` (one
process per card) each batch whose rows divide the ranks is split among
them and the metric counts are summed over the ranks (``Trainer.evaluate``);
only rank 0 prints.
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
    slim_config,
)
from eelunet_tpu_torch.data.pipeline import DataLoader
from eelunet_tpu_torch.inference import read_checkpoint
from eelunet_tpu_torch.metrics import MetricAccumMC, per_class_metrics


def main(argv=None):
    p = base_parser("Evaluate segmentation model and output metrics (PyTorch + CUDA)")
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--checkpoint", type=str, default="")
    args = p.parse_args(argv)
    cfg = load_config(args)

    from eelunet_tpu_torch.parallel.distributed import (
        init_distributed,
        is_primary,
        shutdown_distributed,
    )
    from eelunet_tpu_torch.parallel.mesh import create_mesh
    from eelunet_tpu_torch.prune_physical import is_slim_checkpoint
    from eelunet_tpu_torch.train.trainer import Trainer, check_supported

    slim = is_slim_checkpoint(args.checkpoint)
    if slim:
        cfg = slim_config(cfg, args.checkpoint, "evaluate")

    check_supported(cfg)  # refuses what is not ported, first
    distributed = init_distributed(device=args.device)
    mesh = create_mesh(cfg.mesh.data_axis, cfg.mesh.model_axis, cfg.mesh.spatial_axis,
                       devices=None if distributed else [args.device])
    trainer = Trainer(cfg, device=args.device, mesh=mesh)
    say = print if is_primary() else (lambda *a, **k: None)
    d = cfg.data
    ds = make_folder_dataset(d, args.split, cfg.model.out_channels)
    # Never drop tail samples: the metrics cover the whole split
    # (the reference's loader drops none either, evaluate.py:147).
    loader = DataLoader(ds, d.batch_size, num_workers=d.num_workers, drop_remainder=False)
    state = trainer.init_state()  # a slim checkpoint's weights load here (slim_init)
    if slim:
        say(f"Loaded slim (physically pruned) weights from {args.checkpoint}")
    elif args.checkpoint and os.path.exists(args.checkpoint):
        state.model.load_state_dict(read_checkpoint(args.checkpoint, trainer.cfg.model.name),
                                    strict=True)
        say(f"Loaded model weights from {args.checkpoint}")
    elif args.checkpoint:
        say(f"Checkpoint not found at {args.checkpoint}. Evaluating untrained model.")

    say(f"Evaluation date: {datetime.now().strftime('%Y%m%d_%H%M%S')}")
    say(f"Model: {cfg.model.name}" + (" (slim)" if slim else ""))
    m, acc = trainer.evaluate(state, loader, return_accum=True)
    say("Evaluation Metrics:")
    say(f"Pixel Accuracy: {m['pixel_accuracy']:.4f}")
    say(f"Precision: {m['precision']:.4f}")
    say(f"Recall: {m['recall']:.4f}")
    say(f"F1 Score: {m['f1_score']:.4f}")
    say(f"IoU (foreground): {m['iou']:.4f}")
    say(f"Dice Coefficient (foreground): {m['dice']:.4f}")
    say(f"Mean IoU: {m['miou']:.4f}")
    say(f"Boundary F1 Score: {m['boundary_f1']:.4f}")
    say(f"mDice: {m['mdice']:.4f}")
    if isinstance(acc, MetricAccumMC):
        # multi-class: the per-class rows behind the macro scalars
        pc = per_class_metrics(acc)
        say("Per-class metrics:")
        say("| class | IoU | Dice | precision | recall | support |")
        for c in range(len(pc["iou"])):
            say(f"| {c} | {pc['iou'][c]:.4f} | {pc['dice'][c]:.4f} | "
                f"{pc['precision'][c]:.4f} | {pc['recall'][c]:.4f} | "
                f"{int(pc['support'][c])} |")
    # Unrounded, for scripts that compare a run with the training history.
    say("metrics: " + json.dumps(m))
    say("kernel launches: " + json.dumps(kernel_launches()), flush=True)
    shutdown_distributed()
    return m


if __name__ == "__main__":
    main()
