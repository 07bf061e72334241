"""Evaluation metrics on the device (counterpart of ``eelunet_tpu/metrics.py``;
reference evaluate.py).

Binary masks, NHWC as in the JAX package. Boundary F1 is batched device math:
the erosion is one (2d+1)x(2d+1) min-pool, exact for binary masks and equal
to ``cv2.erode`` with its default +inf border. The accumulator holds summable
counts, so batches add up without a host round trip. The multi-class metrics
are not ported yet (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

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


def update_metrics_multiclass(*_args, **_kwargs):
    """Multi-class metric state (the JAX package's ``update_metrics_multiclass``)."""
    raise NotImplementedError("multi-class metrics are not ported to eelunet_tpu_torch yet; "
                              "see ROADMAP.md")


def finalize_metrics_multiclass(*_args, **_kwargs):
    raise NotImplementedError("multi-class metrics are not ported to eelunet_tpu_torch yet; "
                              "see ROADMAP.md")
