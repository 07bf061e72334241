"""Losses (counterpart of ``eelunet_tpu/losses.py``; reference utils/Loss.py).

All losses take **probabilities** (not logits), NHWC tensors with a trailing
channel of 1 as in the JAX package, and compute in float32.

``F.binary_cross_entropy`` is exactly what the JAX package's ``_bce_elem``
emulates (``losses.py:19-54``): each log term clamped at -100 in the forward
and the gradient (p - t) / max(p (1 - p), 1e-12) in the backward, finite at
p in {0, 1}. So no custom backward is needed here.

Every criterion of the JAX package's ``LOSS_REGISTRY`` is here: the binary
family and, for ``model.out_channels > 1``, the multi-class family on
softmax probabilities and class-id targets.
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


def edge_dice_loss(aux, out, target, lambda_edge: float = 1.0) -> torch.Tensor:
    """Dice-only pyramid variant (Loss.py:115-135)."""
    main = dice_loss(out, target)
    targets = _pyramid_targets(target)
    ds = sum(w * dice_loss(p, t) for p, t, w in zip(aux, targets, _DS_WEIGHTS))
    return main + lambda_edge * ds


def edge_bce_loss(aux, out, target, lambda_edge: float = 1.0) -> torch.Tensor:
    """BCE-only pyramid variant (Loss.py:137-157)."""
    main = bce_loss(out, target)
    targets = _pyramid_targets(target)
    ds = sum(w * bce_loss(p, t) for p, t, w in zip(aux, targets, _DS_WEIGHTS))
    return main + lambda_edge * ds


def focal_loss(pred: torch.Tensor, target: torch.Tensor, alpha: float = 0.25,
               gamma: float = 2.0) -> torch.Tensor:
    """Focal loss on probabilities (Loss.py:197-219), its BCE term with
    ``F.binary_cross_entropy``'s semantics (Loss.py:211); a NaN probability
    gives a NaN loss, as in ``bce_loss``."""
    p = pred.float()
    t = target.float()
    nan = torch.isnan(p)
    bce = F.binary_cross_entropy(torch.where(nan, 0.5, p), t, reduction="none")
    pt = torch.where(t == 1.0, p, 1.0 - p)
    return torch.mean(alpha * (1.0 - pt) ** gamma * torch.where(nan, torch.nan, bce))


# Multi-class criteria (model.out_channels > 1), as in the JAX package:
# probabilities from the softmax head, NHWC (B,H,W,C); targets (B,H,W,1)
# class ids in [0, C).
_PROB_EPS = 1e-7
_LOG_CLAMP = -100.0


def _one_hot_target(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B,H,W,1) class ids (float or int) -> (B,H,W,C) one-hot float32. An id
    outside [0, C) gives a zero row, as ``jax.nn.one_hot`` does
    (``F.one_hot`` would raise, or assert on the card)."""
    ids = torch.round(target[..., 0].float()).long()
    classes = torch.arange(num_classes, device=target.device)
    return (ids[..., None] == classes).float()


def ce_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean categorical cross-entropy on probabilities, -mean log p[true],
    with p clipped to [1e-7, 1 - 1e-7] so the log and its gradient stay
    finite at saturation."""
    p = torch.clamp(pred.float(), _PROB_EPS, 1.0 - _PROB_EPS)
    onehot = _one_hot_target(target, pred.shape[-1])
    log_p = torch.clamp(torch.log(p), min=_LOG_CLAMP)
    return -torch.mean(torch.sum(onehot * log_p, dim=-1))


def multiclass_dice_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Macro soft Dice over all classes, background included, smooth=1:
    ``dice_loss`` per sample and class, averaged over both."""
    b, c = pred.shape[0], pred.shape[-1]
    onehot = _one_hot_target(target, c)
    p = pred.float().reshape(b, -1, c)
    t = onehot.reshape(b, -1, c)
    inter = torch.sum(p * t, dim=1)
    score = (2.0 * inter + 1.0) / (torch.sum(p, dim=1) + torch.sum(t, dim=1) + 1.0)
    return 1.0 - torch.mean(score)


def ce_dice_loss(pred: torch.Tensor, target: torch.Tensor, wb: float = 1.0,
                 wd: float = 1.0) -> torch.Tensor:
    """wd*multiclass_dice + wb*ce: the multi-class ``bce_dice_loss``."""
    return wd * multiclass_dice_loss(pred, target) + wb * ce_loss(pred, target)


def _foreground_target(target: torch.Tensor) -> torch.Tensor:
    """(B,H,W,1) class ids -> the binary foreground (class != 0) map. The
    EELUnet and EGE-UNet aux heads are one-channel sigmoid maps whatever
    ``out_channels`` is, so they are held to the foreground."""
    return (target > 0.5).float()


def edge_ce_dice_loss(aux, out, target, wb: float = 1.0, wd: float = 1.0,
                      lambda_edge: float = 1.0) -> torch.Tensor:
    """Multi-class EELUnet criterion: ``ce_dice`` on the main head and the
    binary deep-supervision pyramid on the foreground mask."""
    main = ce_dice_loss(out, target, wb, wd)
    targets = _pyramid_targets(_foreground_target(target))
    ds = sum(w * bce_dice_loss(p, t, wb, wd) for p, t, w in zip(aux, targets, _DS_WEIGHTS))
    return main + lambda_edge * ds


def gt_ce_dice_loss(aux, out, target, wb: float = 1.0, wd: float = 1.0,
                    lambda_edge: float = 1.0) -> torch.Tensor:
    """Multi-class EGE-UNet criterion: its full-resolution aux maps are held
    to the foreground mask."""
    main = ce_dice_loss(out, target, wb, wd)
    fg = _foreground_target(target)
    ds = sum(w * bce_dice_loss(p, fg, wb, wd) for p, w in zip(aux, _DS_WEIGHTS))
    return main + lambda_edge * ds


LOSS_REGISTRY: Dict[str, Callable] = {
    "dice": lambda aux, out, t, cfg: dice_loss(out, t),
    "bce": lambda aux, out, t, cfg: bce_loss(out, t),
    "bce_dice": lambda aux, out, t, cfg: bce_dice_loss(out, t, cfg.wb, cfg.wd),
    "edge_bce_dice": lambda aux, out, t, cfg: edge_bce_dice_loss(
        aux, out, t, cfg.wb, cfg.wd, cfg.lambda_edge),
    "gt_bce_dice": lambda aux, out, t, cfg: gt_bce_dice_loss(
        aux, out, t, cfg.wb, cfg.wd, cfg.lambda_edge),
    "edge_dice": lambda aux, out, t, cfg: edge_dice_loss(aux, out, t, cfg.lambda_edge),
    "edge_bce": lambda aux, out, t, cfg: edge_bce_loss(aux, out, t, cfg.lambda_edge),
    "focal": lambda aux, out, t, cfg: focal_loss(out, t),
    # multi-class (model.out_channels > 1; the probabilities are a softmax)
    "ce": lambda aux, out, t, cfg: ce_loss(out, t),
    "mc_dice": lambda aux, out, t, cfg: multiclass_dice_loss(out, t),
    "ce_dice": lambda aux, out, t, cfg: ce_dice_loss(out, t, cfg.wb, cfg.wd),
    "edge_ce_dice": lambda aux, out, t, cfg: edge_ce_dice_loss(
        aux, out, t, cfg.wb, cfg.wd, cfg.lambda_edge),
    "gt_ce_dice": lambda aux, out, t, cfg: gt_ce_dice_loss(
        aux, out, t, cfg.wb, cfg.wd, cfg.lambda_edge),
}

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
