"""Pack a ToothDataset-style PNG tree into memmap arrays (counterpart of
``eelunet_tpu/cli/pack.py``):

    python -m eelunet_tpu_torch.cli.pack --data_dir /data/tooth \\
        --out /data/tooth_packed --image_size 512 [--multiclass]

Train on it with ``--data_dir <out> --set data.packed=true``. The files are
the JAX package's layout, so either package reads them. Packing runs on the
host and launches no kernel; the last line is the ``kernel launches:``
record all the same, as every CLI of the port prints it.
"""

from __future__ import annotations

import argparse
import json

from eelunet_tpu_torch.cli.common import kernel_launches
from eelunet_tpu_torch.data.packed import pack_dataset


def main(argv=None):
    p = argparse.ArgumentParser(description="Pack dataset into memmaps")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--splits", type=str, default="train,test")
    p.add_argument("--multiclass", action="store_true",
                   help="masks hold class ids (model.out_channels > 1): "
                   "resize with NEAREST and keep ids unscaled")
    args = p.parse_args(argv)

    for split in args.splits.split(","):
        pack_dataset(args.data_dir, args.out, split,
                     (args.image_size, args.image_size), multiclass=args.multiclass)
        print(f"packed {split} -> {args.out}")
    print("kernel launches: " + json.dumps(kernel_launches()), flush=True)


if __name__ == "__main__":
    main()
