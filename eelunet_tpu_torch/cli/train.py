"""Training entry point (counterpart of ``eelunet_tpu/cli/train.py``;
reference train.py:217-319).

    python -m eelunet_tpu_torch.cli.train --model_type eelunet --data_dir D \\
        --image_size 512 --batch_size 8 --set model.dtype=bfloat16

``--model_type`` takes any of the seven families; each trains on its
``auto`` loss (``losses.AUTO_LOSS``). Runs on the CUDA card; ``--device
cpu`` is the only way onto the CPU. Checkpoints go to ``save_dir/<model>/``
(``train/checkpoint.py``); a best tag such as
``checkpoints/unext_s/unext_s_best.npz`` is served with ``python -m
eelunet_tpu_torch.cli.serve --model_type unext_s --checkpoint`` as it is.

Data-parallel training, one process per card, on DDP:

    torchrun --standalone --nproc_per_node=<cards> -m eelunet_tpu_torch.cli.train \
        --model_type eelunet --data_dir D --image_size 512 --batch_size 16 \
        --set model.dtype=bfloat16

``--batch_size`` is the global batch: each rank trains on its share, and a
step equals the single-process step on the whole batch (global-batch BN
statistics, gradients averaged over the ranks). ``--device cpu`` runs the
ranks on the CPU over gloo. Only rank 0 prints and writes.
"""

from __future__ import annotations

import json

from eelunet_tpu_torch.cli.common import (
    base_parser,
    build_loaders,
    kernel_launches,
    load_config,
)
from eelunet_tpu_torch.config import apply_overrides, config_to_json


def main(argv=None):
    p = base_parser("Train segmentation model with edge supervision (PyTorch + CUDA)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--lambda_edge", type=float, default=None)
    p.add_argument("--resume", type=str, default=None,
                   help="full snapshot to resume from ('auto' = the newest)")
    p.add_argument("--summary", action="store_true",
                   help="print a per-layer shape/param table at startup (the reference "
                   "always runs torchsummary.summary, train.py:291); built on the meta "
                   "device, so no forward runs on the card")
    args = p.parse_args(argv)

    ov = []
    if args.epochs is not None:
        ov.append(f"epochs={args.epochs}")
    if args.lr is not None:
        ov.append(f"optimizer.lr={args.lr}")
    if args.log_dir is not None:
        ov.append(f"log_dir={args.log_dir}")
    if args.lambda_edge is not None:
        ov.append(f"loss.lambda_edge={args.lambda_edge}")
    if args.resume is not None:
        ov.append(f"resume_from={args.resume}")
    args.set = list(args.set) + ov
    cfg = load_config(args)

    from eelunet_tpu_torch.parallel.distributed import (
        init_distributed,
        is_primary,
        process_count,
        shutdown_distributed,
        sync_seed,
    )
    from eelunet_tpu_torch.parallel.mesh import create_mesh
    from eelunet_tpu_torch.train.trainer import Trainer, check_supported
    from eelunet_tpu_torch.utils.seeding import set_seed

    # Join the ranks first (each onto its own card), then agree on one seed:
    # the ranks' slices partition each global batch only if every rank
    # shuffles alike.
    distributed = init_distributed(device=args.device)
    say = print if is_primary() else (lambda *a, **k: None)
    if distributed:
        say(f"Distributed runtime: {process_count()} processes")
    seed = sync_seed(cfg.seed)
    if cfg.seed is None:
        say(f"Using seed: {seed}")
    cfg = apply_overrides(cfg, [f"seed={set_seed(seed)}"])
    say(config_to_json(cfg))
    check_supported(cfg)
    devices = None if distributed else [args.device]
    mesh = create_mesh(cfg.mesh.data_axis, cfg.mesh.model_axis, cfg.mesh.spatial_axis,
                       devices=devices)
    say(f"Mesh: {mesh.shape} over {mesh.devices.size} device(s)")
    trainer = Trainer(cfg, device=args.device, mesh=mesh)
    if args.summary:
        from eelunet_tpu_torch.utils.summary import model_summary

        h, w = cfg.data.image_size
        say(model_summary(trainer.model, (1, trainer.cfg.model.in_channels, h, w)))
    train_loader, val_loader, test_loader = build_loaders(cfg, device=args.device)
    say(f"Device: {trainer.device}; criterion: {trainer.loss_name}; "
        f"{len(train_loader)} steps per epoch", flush=True)
    trainer.fit(train_loader, val_loader, test_loader)
    say("kernel launches: " + json.dumps(kernel_launches()), flush=True)
    shutdown_distributed()


if __name__ == "__main__":
    main()
