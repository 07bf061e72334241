"""Evaluation metrics on the device (counterpart of ``eelunet_tpu/metrics.py``;
reference evaluate.py).

Binary masks, NHWC as in the JAX package. Boundary F1 is batched device math:
the erosion is one (2d+1)x(2d+1) min-pool, exact for binary masks and equal
to ``cv2.erode`` with its default +inf border. The accumulator holds summable
counts, so batches add up without a host round trip; in multi-class mode
(``model.out_channels > 1``) that state is a confusion matrix.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from eelunet_tpu_torch.nn.layers import nchw, nhwc

EPS = 1e-7  # evaluate.py:111


class MetricAccum(NamedTuple):
    """Summable accumulator: add across batches."""

    tp: torch.Tensor
    tn: torch.Tensor
    fp: torch.Tensor
    fn: torch.Tensor
    boundary_f1_sum: torch.Tensor
    samples: torch.Tensor

    def __add__(self, other: "MetricAccum") -> "MetricAccum":
        return MetricAccum(*(a + b for a, b in zip(self, other)))


def erode_binary(mask: torch.Tensor, iterations: int) -> torch.Tensor:
    """Binary erosion by an iterated 3x3 ones kernel == one (2d+1)^2 min-pool
    of the (B,H,W,1) mask, borders treated as +inf (evaluate.py:36-38)."""
    k = 2 * iterations + 1
    # max_pool2d pads with -inf, so -maxpool(-m) pads the min-pool with +inf.
    return nhwc(-F.max_pool2d(-nchw(mask.float()), k, stride=1, padding=iterations))


def seg2bnd(mask: torch.Tensor, dilation_ratio: float = 0.02) -> torch.Tensor:
    """Boundary extraction (evaluate.py:25-41): mask - erode(mask), as bool.
    Erosion iterations = round(mean(H, W) * ratio), at least 1."""
    h, w = mask.shape[1], mask.shape[2]
    d = max(int(round((h + w) / 2.0 * dilation_ratio)), 1)
    m = (mask > 0.5).float()
    return (m - erode_binary(m, d)) > 0.5


def boundary_f1_batch(gt: torch.Tensor, pred: torch.Tensor,
                      dilation_ratio: float = 0.02) -> torch.Tensor:
    """Per-sample Boundary F1 (evaluate.py:43-60). -> (B,)"""
    gt_b = seg2bnd(gt, dilation_ratio)
    pred_b = seg2bnd(pred, dilation_ratio)
    dims = (1, 2, 3)
    tp = torch.sum(gt_b & pred_b, dim=dims).float()
    precision = tp / (torch.sum(pred_b, dim=dims).float() + EPS)
    recall = tp / (torch.sum(gt_b, dim=dims).float() + EPS)
    denom = precision + recall
    f1 = 2.0 * precision * recall / torch.where(denom == 0, 1.0, denom)
    return torch.where(denom == 0, 0.0, f1)


def update_metrics(seg_prob: torch.Tensor, labels: torch.Tensor, threshold: float = 0.5,
                   dilation_ratio: float = 0.02) -> MetricAccum:
    """One batch of metric state (evaluate.py:92-109). seg_prob and labels
    (B,H,W,1)."""
    preds = (seg_prob > threshold).float()
    t = (labels > 0.5).float()
    p = preds.reshape(-1)
    lbl = t.reshape(-1)
    tp = torch.sum(p * lbl)
    tn = torch.sum((1 - p) * (1 - lbl))
    fp = torch.sum(p * (1 - lbl))
    fn = torch.sum((1 - p) * lbl)
    bf1 = torch.sum(boundary_f1_batch(t, preds, dilation_ratio))
    n = torch.tensor(float(preds.shape[0]), device=preds.device)
    return MetricAccum(tp, tn, fp, fn, bf1, n)


def finalize_metrics(acc: MetricAccum) -> Dict[str, torch.Tensor]:
    """Closed-form scalar metrics (evaluate.py:111-124)."""
    tp, tn, fp, fn = acc.tp, acc.tn, acc.fp, acc.fn
    pixel_accuracy = (tp + tn) / (tp + tn + fp + fn + EPS)
    precision = tp / (tp + fp + EPS)
    recall = tp / (tp + fn + EPS)
    f1 = 2 * precision * recall / (precision + recall + EPS)
    iou = tp / (tp + fp + fn + EPS)
    dice_fg = 2 * tp / (2 * tp + fp + fn + EPS)
    dice_bg = 2 * tn / (2 * tn + fp + fn + EPS)
    mdice = (dice_fg + dice_bg) / 2
    iou_bg = tn / (tn + fp + fn + EPS)
    miou = (iou + iou_bg) / 2
    boundary_f1 = acc.boundary_f1_sum / (acc.samples + EPS)
    return {
        "pixel_accuracy": pixel_accuracy,
        "precision": precision,
        "recall": recall,
        "f1_score": f1,
        "iou": iou,
        "dice": dice_fg,
        "miou": miou,
        "boundary_f1": boundary_f1,
        "mdice": mdice,
    }


METRIC_NAMES: Tuple[str, ...] = (
    "pixel_accuracy", "precision", "recall", "f1_score", "iou",
    "dice", "miou", "boundary_f1", "mdice",
)


# Multi-class metrics (model.out_channels > 1), as in the JAX package: a
# C x C confusion matrix is the summable state. iou, dice, precision, recall
# and f1 are macros over the foreground classes 1..C-1; miou and mdice over
# all classes; boundary_f1 on the foreground mask (class != 0).


class MetricAccumMC(NamedTuple):
    """Summable multi-class state: add across batches."""

    confusion: torch.Tensor       # (C, C) float32; rows = true, cols = pred
    boundary_f1_sum: torch.Tensor
    samples: torch.Tensor

    def __add__(self, other: "MetricAccumMC") -> "MetricAccumMC":
        return MetricAccumMC(*(a + b for a, b in zip(self, other)))


def update_metrics_multiclass(seg_prob: torch.Tensor, labels: torch.Tensor,
                              dilation_ratio: float = 0.02) -> MetricAccumMC:
    """One batch of multi-class state. ``seg_prob`` (B,H,W,C) softmax
    probabilities, ``labels`` (B,H,W,1) class ids; the prediction is the
    argmax class. True ids are clipped to [0, C-1] (the losses do not
    clip)."""
    c = seg_prob.shape[-1]
    pred = torch.argmax(seg_prob, dim=-1)
    true = torch.clamp(torch.round(labels[..., 0].float()).long(), 0, c - 1)
    flat = (true * c + pred).reshape(-1)
    confusion = torch.bincount(flat, minlength=c * c).reshape(c, c).float()
    fg_pred = (pred > 0).float()[..., None]
    fg_true = (true > 0).float()[..., None]
    bf1 = torch.sum(boundary_f1_batch(fg_true, fg_pred, dilation_ratio))
    n = torch.tensor(float(seg_prob.shape[0]), device=seg_prob.device)
    return MetricAccumMC(confusion, bf1, n)


def per_class_metrics(acc: MetricAccumMC) -> Dict[str, np.ndarray]:
    """Per-class iou, dice, precision, recall and support (host numpy) from
    the confusion matrix: the drill-down behind the macro scalars."""
    conf = acc.confusion.detach().cpu().numpy()
    tp = np.diag(conf)
    fn = conf.sum(1) - tp
    fp = conf.sum(0) - tp
    return {
        "iou": tp / (tp + fp + fn + EPS),
        "dice": 2 * tp / (2 * tp + fp + fn + EPS),
        "precision": tp / (tp + fp + EPS),
        "recall": tp / (tp + fn + EPS),
        "support": conf.sum(1),
    }


def finalize_metrics_multiclass(acc: MetricAccumMC) -> Dict[str, torch.Tensor]:
    """The scalar metrics (names == METRIC_NAMES) from the confusion matrix."""
    conf = acc.confusion
    tp = torch.diagonal(conf)
    fn = torch.sum(conf, dim=1) - tp
    fp = torch.sum(conf, dim=0) - tp
    iou_c = tp / (tp + fp + fn + EPS)
    dice_c = 2 * tp / (2 * tp + fp + fn + EPS)
    prec_c = tp / (tp + fp + EPS)
    rec_c = tp / (tp + fn + EPS)
    f1_c = 2 * prec_c * rec_c / (prec_c + rec_c + EPS)
    return {
        "pixel_accuracy": torch.sum(tp) / (torch.sum(conf) + EPS),
        "precision": torch.mean(prec_c[1:]),
        "recall": torch.mean(rec_c[1:]),
        "f1_score": torch.mean(f1_c[1:]),
        "iou": torch.mean(iou_c[1:]),
        "dice": torch.mean(dice_c[1:]),
        "miou": torch.mean(iou_c),
        "boundary_f1": acc.boundary_f1_sum / (acc.samples + EPS),
        "mdice": torch.mean(dice_c),
    }
