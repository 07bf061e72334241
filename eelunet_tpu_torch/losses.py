"""Losses (counterpart of ``eelunet_tpu/losses.py``; reference utils/Loss.py).

All losses take **probabilities** (not logits), NHWC tensors with a trailing
channel of 1 as in the JAX package, and compute in float32.

``F.binary_cross_entropy`` is exactly what the JAX package's ``_bce_elem``
emulates (``losses.py:19-54``): each log term clamped at -100 in the forward
and the gradient (p - t) / max(p (1 - p), 1e-12) in the backward, finite at
p in {0, 1}. So no custom backward is needed here.

The binary criteria of the seven families' ``auto`` choices are ported
(``dice``, ``bce``, ``bce_dice``, ``edge_bce_dice``, ``gt_bce_dice``); the
pyramid variants ``edge_dice``/``edge_bce``, ``focal`` and the multi-class
family raise ``NotImplementedError`` (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from eelunet_tpu_torch.nn.layers import nchw, nhwc


def dice_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-sample soft Dice, smooth=1 (Loss.py:28-42)."""
    b = pred.shape[0]
    p = pred.reshape(b, -1).float()
    t = target.reshape(b, -1).float()
    inter = torch.sum(p * t, dim=1)
    score = (2.0 * inter + 1.0) / (torch.sum(p, dim=1) + torch.sum(t, dim=1) + 1.0)
    return 1.0 - torch.mean(score)


def bce_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on probabilities: ``nn.BCELoss``
    (Loss.py:45-55), with its -100 log clamp and 1e-12 gradient floor.

    ``F.binary_cross_entropy`` asserts that its input lies in [0, 1], on a
    card as a device-side assert that ends the process. A NaN probability
    (a poisoned batch, which the non-finite guard is there to skip) is kept
    out of it, and the loss is NaN instead."""
    p = pred.float()
    nan = torch.isnan(p)
    loss = F.binary_cross_entropy(torch.where(nan, 0.5, p), target.float())
    return torch.where(nan.any(), torch.nan, loss)


def bce_dice_loss(pred: torch.Tensor, target: torch.Tensor, wb: float = 1.0,
                  wd: float = 1.0) -> torch.Tensor:
    """wd*dice + wb*bce (Loss.py:59-73)."""
    return wd * dice_loss(pred, target) + wb * bce_loss(pred, target)


_DS_WEIGHTS = (0.1, 0.2, 0.3, 0.4, 0.5)  # deep-supervision weights (Loss.py:108-113)


def _max_pool_nhwc(x: torch.Tensor, k: int) -> torch.Tensor:
    return nhwc(F.max_pool2d(nchw(x), k))


def _pyramid_targets(target: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Max-pooled target pyramid at 1/16, 1/8, 1/4, 1/2, 1/1 (Loss.py:102-106)."""
    return (
        _max_pool_nhwc(target, 16),
        _max_pool_nhwc(target, 8),
        _max_pool_nhwc(target, 4),
        _max_pool_nhwc(target, 2),
        target,
    )


def edge_bce_dice_loss(
    aux: Sequence[torch.Tensor],
    out: torch.Tensor,
    target: torch.Tensor,
    wb: float = 1.0,
    wd: float = 1.0,
    lambda_edge: float = 1.0,
) -> torch.Tensor:
    """The EELUnet training criterion (Loss.py:92-113; selected train.py:305).

    ``aux``: the five sigmoid heads at 1/16..1/1 resolution, NHWC. Their
    targets are max-pooled masks. ``lambda_edge`` scales the
    deep-supervision sum (1.0 is the reference's behaviour)."""
    main = bce_dice_loss(out, target, wb, wd)
    targets = _pyramid_targets(target)
    ds = sum(w * bce_dice_loss(p, t, wb, wd) for p, t, w in zip(aux, targets, _DS_WEIGHTS))
    return main + lambda_edge * ds


def gt_bce_dice_loss(
    aux: Sequence[torch.Tensor],
    out: torch.Tensor,
    target: torch.Tensor,
    wb: float = 1.0,
    wd: float = 1.0,
    lambda_edge: float = 1.0,
) -> torch.Tensor:
    """The EGE-UNet criterion (Loss.py:76-89): its aux maps are already at
    full resolution, so each is held to the mask itself, with the
    deep-supervision weights 0.1..0.5, low to high stage."""
    main = bce_dice_loss(out, target, wb, wd)
    ds = sum(w * bce_dice_loss(p, target, wb, wd) for p, w in zip(aux, _DS_WEIGHTS))
    return main + lambda_edge * ds


def _not_ported(name: str) -> Callable:
    def fn(*_args, **_kwargs):
        raise NotImplementedError(f"loss {name!r} is not ported to eelunet_tpu_torch yet; "
                                  "see ROADMAP.md")

    return fn


LOSS_REGISTRY: Dict[str, Callable] = {
    "dice": lambda aux, out, t, cfg: dice_loss(out, t),
    "bce": lambda aux, out, t, cfg: bce_loss(out, t),
    "bce_dice": lambda aux, out, t, cfg: bce_dice_loss(out, t, cfg.wb, cfg.wd),
    "edge_bce_dice": lambda aux, out, t, cfg: edge_bce_dice_loss(
        aux, out, t, cfg.wb, cfg.wd, cfg.lambda_edge),
    "gt_bce_dice": lambda aux, out, t, cfg: gt_bce_dice_loss(
        aux, out, t, cfg.wb, cfg.wd, cfg.lambda_edge),
}
# The JAX package's other criteria: the pyramid variants, focal loss and the
# multi-class family.
for _name in ("edge_dice", "edge_bce", "focal", "ce", "mc_dice", "ce_dice",
              "edge_ce_dice", "gt_ce_dice"):
    LOSS_REGISTRY[_name] = _not_ported(_name)

# Default criterion per model family when LossConfig.name == "auto".
AUTO_LOSS = {
    "eelunet": "edge_bce_dice",
    "egeunet": "gt_bce_dice",
    "unet": "bce_dice",
    "unet++": "bce_dice",
    "unext": "bce_dice",
    "unext_s": "bce_dice",
    "malunet": "bce_dice",
}
AUTO_LOSS_MULTICLASS = {
    "eelunet": "edge_ce_dice",
    "egeunet": "gt_ce_dice",
}


def resolve_loss_name(loss_name: str, model_name: str, out_channels: int = 1) -> str:
    if loss_name != "auto":
        return loss_name
    if out_channels > 1:
        return AUTO_LOSS_MULTICLASS.get(model_name, "ce_dice")
    return AUTO_LOSS.get(model_name, "bce_dice")
