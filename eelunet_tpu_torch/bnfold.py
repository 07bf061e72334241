"""Eval-time BatchNorm folding on the port's ``state_dict``
(counterpart of ``eelunet_tpu/bnfold.py``).

For conv -> BN(eval),

    y = (Wx + b - mean) / sqrt(var + eps) * scale + beta
      = (W * k) x + ((b - mean) * k + beta),      k = scale / sqrt(var + eps)

so the BN disappears from the graph: the model is built with
``bn_folded=True``, which creates no BN after a conv.

Pairs, by the port's module names (``models/convert.port_prefix``):

- ``X.conv{i}`` -> ``X.bn{i}``             (ConvBlock, MlpConvBlock 1st pair)
- ``X.capmlp.conv1`` -> ``X.bn{i}``        (the CAPMLP's last 1x1 conv:
  MlpConvBlock 2nd pair, MlpUpConvBlock)
- ``X.convt`` -> ``X.bn0``                 (UpConvBN). A ConvTranspose2d
  weight is (cin, cout, kh, kw): the per-channel scale multiplies dim 1.

``bottleneck_bn`` is a BN *before* a padded conv: folding it forward would
leak its affine into the padding zeros, so it stays live.

UNeXt and UNeXt-S name their pairs at the model's root (``NAMED_PAIRS``:
``encoderN -> ebnN``, ``decoderN -> dbnN``; ``eelunet_tpu/bnfold.py:44-57``).
U-Net has no BN, so its fold is a no-op. EGE-UNet (BN before a conv in
``Down``, GroupNorm elsewhere) and MALUNet (GroupNorm only) stay unfolded,
as in the JAX package; U-Net++ has no BN and no fold map there either.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import torch

EPS = 1e-5  # nn.BatchNorm2d's default, as in nn/layers.BatchNorm2d

FOLDABLE_MODELS = ("eelunet", "unet", "unext", "unext_s")  # unet: no BN -> no-op fold

# Families whose conv -> BN pairs are named modules at the model's root
# (models/unext.py): the BN output feeds max-pool, ReLU or the upsampling,
# all after the folded conv.
NAMED_PAIRS = {
    "unext": [(f"encoder{i}", f"ebn{i}") for i in (1, 2, 3)]
    + [(f"decoder{i}", f"dbn{i}") for i in (1, 2, 3, 4)],
}
NAMED_PAIRS["unext_s"] = NAMED_PAIRS["unext"]

StateDict = Dict[str, torch.Tensor]
_BN_SUFFIXES = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")


def find_fold_pairs(sd: StateDict) -> Tuple[List[Tuple[str, str, bool]], List[str]]:
    """([(conv_prefix, bn_prefix, transposed)], [bn prefixes left live])."""
    pairs: List[Tuple[str, str, bool]] = []
    skipped: List[str] = []
    for key in sd:
        if not key.endswith(".running_mean"):
            continue
        bn = key[: -len(".running_mean")]
        parent, _, leaf = bn.rpartition(".")
        m = re.fullmatch(r"bn(\d+)", leaf)
        if not (m and parent):
            skipped.append(bn)
        elif f"{parent}.conv{m.group(1)}.weight" in sd:
            pairs.append((f"{parent}.conv{m.group(1)}", bn, False))
        elif f"{parent}.capmlp.conv1.weight" in sd:
            pairs.append((f"{parent}.capmlp.conv1", bn, False))
        elif m.group(1) == "0" and f"{parent}.convt.weight" in sd:
            pairs.append((f"{parent}.convt", bn, True))
        else:
            skipped.append(bn)
    return pairs, skipped


@torch.no_grad()
def fold_bn_eval(sd: StateDict, model_name: str = "eelunet") -> Tuple[StateDict, int]:
    """Return (state_dict', n_folded): every foldable BN of family
    ``model_name`` absorbed into its producing conv and its entries removed —
    the structure of a model built with ``bn_folded=True``. Unfoldable BNs
    keep their entries. Raises for a family outside ``FOLDABLE_MODELS``."""
    if model_name not in FOLDABLE_MODELS:
        raise ValueError(f"BN folding is implemented for {FOLDABLE_MODELS}, not "
                         f"{model_name!r} (its norms are GroupNorm, or BN before a conv)")
    sd = {k: v.clone() for k, v in sd.items()}
    pairs, _ = find_fold_pairs(sd)
    pairs += [(conv, bn, False) for conv, bn in NAMED_PAIRS.get(model_name, ())
              if f"{bn}.running_mean" in sd and f"{conv}.weight" in sd]
    for conv, bn, transposed in pairs:
        k = sd[f"{bn}.weight"].double() / torch.sqrt(sd[f"{bn}.running_var"].double() + EPS)
        w = sd[f"{conv}.weight"]
        shape = [1] * w.dim()
        shape[1 if transposed else 0] = -1
        sd[f"{conv}.weight"] = (w.double() * k.view(shape)).to(w.dtype)
        b = sd[f"{conv}.bias"]
        sd[f"{conv}.bias"] = ((b.double() - sd[f"{bn}.running_mean"].double()) * k
                              + sd[f"{bn}.bias"].double()).to(b.dtype)
        for suf in _BN_SUFFIXES:
            sd.pop(f"{bn}.{suf}", None)
    return sd, len(pairs)
