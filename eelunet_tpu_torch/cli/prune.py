"""Pruning entry point (counterpart of ``eelunet_tpu/cli/prune.py``; the
intent of the reference's prune.py:178-304).

    python -m eelunet_tpu_torch.cli.prune --model_type eelunet --data_dir D \\
        --image_size 512 --batch_size 8 --set model.dtype=bfloat16 \\
        --checkpoint checkpoints/eelunet/eelunet_best.npz \\
        --prune_amount 0.3 --finetune_epochs 5 [--physical]

Flow: load pretrained -> evaluate the original -> L2-structured channel
masks per conv -> sparsity report -> evaluate the pruned model -> masked
finetune at lr/10 -> evaluate -> comparison table -> save a full snapshot
(``--out``: a tag under ``save_dir/<model>/``, default ``pruned_<pct>``, or
a path). With ``--physical`` (unet and eelunet) the masks zero whole
channels (kernel, bias and, for the EELUnet, the BN affine), and after the
finetune the channels are sliced out: the slim model is evaluated and saved
as ``<path>_slim`` (``model.pt`` + ``widths.json``), which ``cli.evaluate``,
``cli.predict``, ``cli.serve``, ``cli.export`` and ``model.slim_init`` read.

``--checkpoint`` takes what ``cli.evaluate`` takes. Runs on the CUDA card;
``--device cpu`` is the only way onto the CPU. The slim metrics are printed
unrounded on a ``slim metrics:`` line; the last line is the run's
``kernel launches:``.
"""

from __future__ import annotations

import json
import os
import types

import torch

from eelunet_tpu_torch.cli.common import base_parser, build_loaders, kernel_launches, load_config
from eelunet_tpu_torch.inference import read_checkpoint
from eelunet_tpu_torch.prune import (
    apply_masks,
    compute_prune_masks,
    finetune_pruned,
    global_sparsity,
    sparsity_report,
)
from eelunet_tpu_torch.prune_physical import SLIM_MODELS


def main(argv=None):
    p = base_parser("Structured channel pruning + finetune (PyTorch + CUDA)")
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--prune_amount", type=float, default=0.3)
    p.add_argument("--finetune_epochs", type=int, default=5)
    p.add_argument("--out", type=str, default="",
                   help="checkpoint destination: a tag saved under save_dir/<model>/ "
                   "(default pruned_<pct>), or a path (anything containing a path "
                   "separator / absolute path) saved verbatim")
    p.add_argument("--physical", action="store_true",
                   help="after finetune, physically remove the pruned channels "
                   "(unet and eelunet) and save a slim checkpoint (model.pt + widths.json)")
    p.add_argument("--prune_round_to", type=int, default=0,
                   help="round KEPT channel counts up to this multiple (0 = auto: with "
                   "--physical 64 for unet and 32 for eelunet, whose full-resolution "
                   "64-wide stages never shrink at 64; 1 otherwise)")
    args = p.parse_args(argv)
    cfg = load_config(args)
    if args.physical and cfg.model.name not in SLIM_MODELS:
        p.error("--physical supports model_type unet/eelunet (see prune_physical.py docs)")
    if args.prune_round_to == 0:
        args.prune_round_to = (32 if cfg.model.name == "eelunet" else 64) if args.physical else 1

    from eelunet_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, device=args.device)
    train_loader, val_loader, test_loader = build_loaders(cfg, trainer.device)
    state = trainer.init_state(steps_per_epoch=max(len(train_loader), 1))
    state.model.load_state_dict(read_checkpoint(args.checkpoint, cfg.model.name), strict=True)
    model = state.model

    print("== original ==")
    m0 = trainer.evaluate(state, test_loader)
    print({k: round(v, 4) for k, v in m0.items()})

    # Physical removal needs masks that zero the whole channel (kernel and
    # bias, and the BN affine for the EELUnet) so slicing is exact; the
    # default masks are torch ln_structured's (weights only).
    if args.physical and cfg.model.name == "eelunet":
        from eelunet_tpu_torch.prune_physical import eelunet_prune_masks

        masks, _keeps = eelunet_prune_masks(model.state_dict(), args.prune_amount,
                                            args.prune_round_to)
    else:
        masks, _report = compute_prune_masks(model, args.prune_amount, zero_bias=args.physical,
                                             round_to=args.prune_round_to)
    apply_masks(model, masks)
    print(f"== pruned (amount={args.prune_amount}) ==")
    for name, frac in sparsity_report(model).items():
        print(f"  {name}: {frac:.1%} zero")
    print(f"global sparsity: {global_sparsity(model):.1%}")
    m1 = trainer.evaluate(state, test_loader)
    print({k: round(v, 4) for k, v in m1.items()})

    state = finetune_pruned(trainer, state, masks, train_loader, val_loader,
                            epochs=args.finetune_epochs)
    print("== finetuned ==")
    m2 = trainer.evaluate(state, test_loader)
    print({k: round(v, 4) for k, v in m2.items()})

    print("\nmetric          original   pruned  finetuned")
    for k in ("iou", "dice", "miou", "mdice", "boundary_f1"):
        print(f"{k:14s}  {m0[k]:8.4f} {m1[k]:8.4f}  {m2[k]:8.4f}")

    if args.out and (os.path.isabs(args.out) or os.sep in args.out):
        path = trainer.ckpt.save_to(os.path.abspath(args.out), state)
    else:
        path = trainer.ckpt.save(args.out or f"pruned_{int(args.prune_amount * 100)}", state)
    print(f"Saved pruned+finetuned checkpoint to {path}")

    if args.physical:
        from eelunet_tpu_torch.prune_physical import (
            param_count,
            physical_prune_eelunet,
            physical_prune_unet,
            save_slim,
        )
        from eelunet_tpu_torch.registry import create_model

        # The masked finetune keeps the pruned channels exactly zero, so the
        # slice is a re-indexing of the same function.
        sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        mc = trainer.cfg.model  # 4 input channels with data.add_canny_edge
        prune_fn = physical_prune_eelunet if mc.name == "eelunet" else physical_prune_unet
        slim_sd, widths = prune_fn(sd, args.prune_amount, args.prune_round_to)
        slim, _ = create_model(mc, widths=widths)
        slim.load_state_dict(slim_sd, strict=True)
        slim = slim.to(trainer.device, memory_format=torch.channels_last)
        n0, n1 = param_count(model), param_count(slim)
        print(f"== physical ==\nparams: {n0 / 1e6:.2f}M -> {n1 / 1e6:.2f}M ({n1 / n0:.1%})")
        # the eval step reads nothing of a train state but its model
        m3 = trainer.evaluate(types.SimpleNamespace(model=slim), test_loader)
        print({k: round(v, 4) for k, v in m3.items()})
        print("slim metrics: " + json.dumps(m3))
        slim_path = save_slim(path + "_slim", slim_sd, widths, model_name=mc.name)
        print(f"Saved slim checkpoint to {slim_path}")
    print("kernel launches: " + json.dumps(kernel_launches()), flush=True)


if __name__ == "__main__":
    main()
