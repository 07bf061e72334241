"""Export a checkpoint as a reference-compatible PyTorch state dict
(counterpart of ``eelunet_tpu/cli/export_torch.py``).

    python -m eelunet_tpu_torch.cli.export_torch --model_type eelunet \\
        --checkpoint checkpoints/eelunet/eelunet_last --output eelunet_for_torch.pth

Reads any checkpoint that ``inference.read_checkpoint`` reads (a full
snapshot of ``cli.train`` or ``cli.prune``, or an upstream-layout ``.npz``
or ``.pth``) and writes the upstream layout
(``models/convert.to_upstream_state_dict``): upstream module names and the
EELUnet's interleaved bridge order, which the reference stack loads with
``load_state_dict`` (evaluate.py:172-176, test.py:82-86). The output is a
``torch.save`` ``.pth``, or an ``.npz`` of the same names with ``--numpy``
or an ``.npz`` path. U-Net++ has no upstream layout and is refused, as in
the JAX package. It only reads and writes files: nothing runs on a device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from eelunet_tpu_torch.cli.common import base_parser, load_config

# The families with an upstream layout (the JAX package's export RULES).
UPSTREAM_FAMILIES = ("eelunet", "egeunet", "malunet", "unet", "unext", "unext_s")


def main(argv=None):
    p = base_parser("Export checkpoint as reference PyTorch state_dict")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="full snapshot dir (or its state.pt), or an upstream-layout "
                   ".npz/.pth")
    p.add_argument("--output", type=str, required=True, help=".pth (or .npz) path")
    p.add_argument("--numpy", action="store_true",
                   help="write an .npz of the same tensor names instead of "
                   "a torch-pickled .pth")
    args = p.parse_args(argv)
    cfg = load_config(args)

    from eelunet_tpu_torch.inference import read_checkpoint
    from eelunet_tpu_torch.models.convert import to_upstream_state_dict

    name = cfg.model.name
    if name not in UPSTREAM_FAMILIES:
        raise KeyError(f"no torch export mapping for model '{name}' "
                       f"(supported: {sorted(UPSTREAM_FAMILIES)})")
    if not os.path.exists(args.checkpoint):
        raise FileNotFoundError(f"checkpoint not found: {args.checkpoint}")
    sd = to_upstream_state_dict(read_checkpoint(args.checkpoint, name), name)

    if args.numpy or args.output.endswith(".npz"):
        np.savez(args.output, **sd)
    else:
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, args.output)
    n = sum(int(np.asarray(v).size) for v in sd.values())
    print(f"Exported {name} ({n / 1e6:.2f}M params) "
          f"from {args.checkpoint} -> {args.output}")
    return args.output


if __name__ == "__main__":
    main()
