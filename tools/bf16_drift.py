"""How far a family's bf16 forward drifts from its float32 forward on the
same weights, in the PyTorch port and in the JAX package, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tools/bf16_drift.py egeunet [--eager]

Weights and inputs are those of tests/torch_port_families.py (seeded random
init, constants randomised). Prints, for each package, the mean |d prob|
and the share of mask pixels (p > 0.5) that differ between the served bf16
model (BN folded where the family folds) and the float32 one. The JAX model
runs jitted, where XLA may fuse elementwise chains and skip their bf16
roundings, and, with ``--eager``, op by op (slow: about a minute).
"""

from __future__ import annotations

import argparse
import dataclasses

import jax
import numpy as np
import torch

from eelunet_tpu.config import ModelConfig as JaxModelConfig
from eelunet_tpu.registry import create_model as jax_create_model
from eelunet_tpu.registry import seg_probabilities as jax_seg_probabilities
from eelunet_tpu_torch.config import ModelConfig
from eelunet_tpu_torch.inference import build_serving_model
from eelunet_tpu_torch.models.convert import from_flax_variables
from eelunet_tpu_torch.nn.layers import nchw, nhwc
from eelunet_tpu_torch.registry import MODEL_REGISTRY, seg_probabilities
from torch_port_families import family_input, family_variables


def drift(probs):
    d = np.abs(probs["bfloat16"] - probs["float32"])
    return d.mean(), np.mean((probs["bfloat16"] > 0.5) != (probs["float32"] > 0.5))


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("name")
    p.add_argument("--eager", action="store_true", help="also run the JAX model op by op")
    args = p.parse_args()
    variables, x = family_variables(args.name), family_input()
    runs = {"jax jitted": False, **({"jax op by op": True} if args.eager else {})}
    for label, eager in runs.items():
        probs = {}
        for dt in ("float32", "bfloat16"):
            model, meta = jax_create_model(JaxModelConfig(name=args.name, dtype=dt))
            fwd = lambda v, x: model.apply(v, x, train=False)  # noqa: E731
            if eager:
                with jax.disable_jit():
                    out = fwd(variables, x)
            else:
                out = jax.jit(fwd)(variables, x)
            probs[dt] = np.asarray(jax_seg_probabilities(out, meta), np.float32)
        print(f"{args.name} {label}: mean|d prob| %.3e, mask pixels differing %.3e" % drift(probs))
    sd = from_flax_variables(variables, args.name)
    cfg = ModelConfig(name=args.name)
    xt = nchw(torch.from_numpy(x)).contiguous(memory_format=torch.channels_last)
    probs = {}
    with torch.inference_mode():
        for dt in ("float32", "bfloat16"):
            model = build_serving_model(sd, dataclasses.replace(cfg, dtype=dt), "cpu")
            out = model(xt.to(getattr(torch, dt)))
            probs[dt] = nhwc(seg_probabilities(out, MODEL_REGISTRY[args.name])).numpy()
    print(f"{args.name} port: mean|d prob| %.3e, mask pixels differing %.3e" % drift(probs))


if __name__ == "__main__":
    main()
