#!/usr/bin/env python3
"""How far one bf16 train step on the high-pass kernels lies from the same
step on the plain low-rank op, next to how far each lies from the float32
step, over several seeded batches, on the card.

    python tools/bf16_step_spread.py [--seeds 4 5 6 11 12]

Full-width EELUnet (seed 0 weights), 512^2, batch 8: binary on blob
samples, 3-class on the synthetic 3-class samples. For each batch, the loss
and the gradient's global norm of three steps from the same weights: the
float32 step on ``highpass_impl="lowrank"`` and the bf16-autocast steps on
the kernels and on lowrank. Prints one line per batch with the relative
differences, and the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import copy
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[4, 5, 6, 11, 12])
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bf16_step_spread: no CUDA card", file=sys.stderr)
        return 1
    from eelunet_tpu_torch.config import TrainConfig, apply_overrides
    from eelunet_tpu_torch.data.augment import make_input_preprocess
    from eelunet_tpu_torch.data.synthetic import make_blob_sample, make_multiclass_sample
    from eelunet_tpu_torch.train.trainer import Trainer, forward_loss

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")

    def rel(a, b):
        return abs(a - b) / abs(b)

    for classes in (1, 3):
        cfg = apply_overrides(TrainConfig(), ["model.name=eelunet", "model.dtype=bfloat16",
                                              f"model.out_channels={classes}", "seed=0"])
        trainer = Trainer(cfg, device="cuda")
        state = trainer.init_state()
        preprocess = make_input_preprocess(cfg.data, classes)
        for seed in args.seeds:
            rng = np.random.default_rng(seed)
            if classes > 1:
                pairs = [make_multiclass_sample(rng, 512, 512, classes) for _ in range(8)]
                y = np.stack([p[1].astype(np.uint8) for p in pairs])
            else:
                pairs = [make_blob_sample(rng, 512, 512) for _ in range(8)]
                y = np.stack([(p[1] * 255).astype(np.uint8) for p in pairs])
            u8 = np.stack([(p[0] * 255).astype(np.uint8) for p in pairs])
            x, labels = preprocess(torch.from_numpy(u8).to(dev), torch.from_numpy(y).to(dev))
            got = {}
            for name, impl, amp in (("f32", "lowrank", None), ("kernels", "auto", torch.bfloat16),
                                    ("lowrank", "lowrank", torch.bfloat16)):
                model = copy.deepcopy(state.model).train()
                model.highpass_impl = impl
                loss = forward_loss(model, trainer.loss_fn, x, labels, amp)
                loss.backward()
                gnorm = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(p.grad.double()) for p in model.parameters()]))
                got[name] = (loss.item(), gnorm.item())
                del model, loss
            (l32, g32), (lk, gk), (ll, gl) = got["f32"], got["kernels"], got["lowrank"]
            print(f"classes {classes} seed {seed}: kernels vs lowrank (bf16): loss "
                  f"{rel(lk, ll):.2e} grad norm {rel(gk, gl):.2e} | vs the float32 step: "
                  f"kernels loss {rel(lk, l32):.2e} grad norm {rel(gk, g32):.2e}; lowrank loss "
                  f"{rel(ll, l32):.2e} grad norm {rel(gl, g32):.2e}", flush=True)
            torch.cuda.empty_cache()
        del trainer, state
    return 0


if __name__ == "__main__":
    sys.exit(main())
