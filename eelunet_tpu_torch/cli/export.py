"""Export a checkpoint as a model-free ``torch.export`` artifact
(counterpart of ``eelunet_tpu/cli/export.py``).

    python -m eelunet_tpu_torch.cli.export --model_type eelunet \\
        --checkpoint checkpoints/eelunet/eelunet_best.npz --image_size 512 \\
        --set model.dtype=bfloat16 --batch_sizes 1,8,16 --output exported/eelunet512

The artifact (``eelunet_tpu_torch/export.py``) embeds the weights and the
preprocessing and runs with torch alone through ``ExportedModel``; ``python
-m eelunet_tpu_torch.cli.serve --artifact DIR`` serves it. ``--checkpoint``
takes what ``cli.serve`` takes, a slim checkpoint included; empty exports
the seeded random init. The programs are exported for the device the run is
on: the CUDA card, or ``--device cpu``. The last line is the run's
``kernel launches:`` (all 0: no hand-written kernel enters an artifact).
"""

from __future__ import annotations

import json
import os

from eelunet_tpu_torch.cli.common import base_parser, kernel_launches, load_config


def main(argv=None):
    p = base_parser("Export a torch.export inference artifact (PyTorch + CUDA)")
    p.add_argument("--checkpoint", type=str, default="",
                   help="checkpoint (state dict, snapshot or slim dir); empty exports the "
                   "seeded random init")
    p.add_argument("--batch_sizes", type=str, default="1,8")
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--quantize", type=str, default="", choices=["", "int8"],
                   help="int8: bake W8A8 dynamic-scale convs and dots into the artifact")
    args = p.parse_args(argv)
    cfg = load_config(args)

    from eelunet_tpu_torch.export import export_model

    out = export_model(
        cfg.model, args.checkpoint or None, cfg.data.image_size,
        [int(b) for b in args.batch_sizes.split(",")], args.output,
        cfg.data.normalize_mean, cfg.data.normalize_std,
        quantize=args.quantize or None, device=args.device)
    print(f"exported {cfg.model.name} -> {out}: {', '.join(sorted(os.listdir(out)))}")
    # the export pins the low-rank high-pass: no hand-written kernel runs
    print("kernel launches: " + json.dumps(kernel_launches()), flush=True)
    return out


if __name__ == "__main__":
    main()
