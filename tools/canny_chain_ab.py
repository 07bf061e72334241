#!/usr/bin/env python3
"""Time the Canny input chain and the steps behind it on the card, for one
checkout of the PyTorch port.

    python tools/canny_chain_ab.py [--root DIR] [--tag NAME]

Imports ``eelunet_tpu_torch`` from the checkout at DIR (default: this one),
builds a seeded EELUnet at full width with ``data.canny_enhance`` and
``data.add_canny_edge`` (4 input channels), 512^2, batch 8, bf16 autocast,
and prints one JSON line: the device-side input chain's ms per batch, the
train step behind the chain and fed pre-made inputs, and the eval step
likewise (CUDA events around 4 warm iterations each), with the card's name
and power limit. To compare two checkouts, run it for both in one call, in
turns (A, B, B, A): numbers from two calls may come from two cards.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="the checkout whose eelunet_tpu_torch is timed")
    ap.add_argument("--tag", default="", help="a name for this checkout in the output")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("canny_chain_ab: no CUDA card", file=sys.stderr)
        return 1
    from eelunet_tpu_torch.config import TrainConfig, apply_overrides
    from eelunet_tpu_torch.data.augment import make_input_preprocess
    from eelunet_tpu_torch.data.synthetic import make_blob_sample
    from eelunet_tpu_torch.train.trainer import Trainer, make_eval_step, make_train_step

    import eelunet_tpu_torch

    dev = torch.device("cuda")
    cfg = apply_overrides(TrainConfig(), [
        "model.name=eelunet", "model.dtype=bfloat16", "model.fft_mask_range=20",
        "data.image_size=512", "data.batch_size=8", "seed=0", "data.add_canny_edge=true",
        "data.canny_enhance=true"])
    trainer = Trainer(cfg, device="cuda")
    state = trainer.init_state(steps_per_epoch=6)
    step = make_train_step(trainer.loss_fn, trainer.amp_dtype)
    eval_step = make_eval_step(trainer.meta, cfg.threshold, cfg.tta, trainer.amp_dtype)
    preprocess = make_input_preprocess(cfg.data)
    rng = np.random.default_rng(4)
    raw = []
    for _ in range(2):
        pairs = [make_blob_sample(rng, 512, 512) for _ in range(8)]
        raw.append(tuple(torch.from_numpy(np.stack([(p[k] * 255).astype(np.uint8)
                                                    for p in pairs])).to(dev) for k in (0, 1)))
    prepped = [preprocess(*b) for b in raw]

    def events_ms(fn, n: int = 4) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            fn(i)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    for i in range(2):  # warm
        step(state, *prepped[i])
        eval_step(state, *prepped[i])
    out = {
        "tag": args.tag, "root": os.path.abspath(args.root),
        "package": os.path.dirname(eelunet_tpu_torch.__file__),
        "chain_ms": events_ms(lambda i: preprocess(*raw[i % 2])),
        "step_with_chain_ms": events_ms(lambda i: step(state, *preprocess(*raw[i % 2]))),
        "step_ms": events_ms(lambda i: step(state, *prepped[i % 2])),
        "eval_with_chain_ms": events_ms(lambda i: eval_step(state, *preprocess(*raw[i % 2]))),
        "eval_ms": events_ms(lambda i: eval_step(state, *prepped[i % 2])),
    }
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    out["card"] = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
