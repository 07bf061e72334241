"""Edge-enhancement preprocessing toolbox (counterpart of
``eelunet_tpu/ops/enhance.py``): batched versions of the reference's
per-image OpenCV scripts (augmentation/canny.py, RGB_canny.py, Sobel.py,
Sobel_gradient.py, hsv.py).

All functions take NHWC float batches in [0, 1]. Their Canny calls go
through ``ops/edge.py``, so on a CUDA tensor they launch kernel 5.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from eelunet_tpu_torch.ops.edge import (
    canny_edge_improve,
    gaussian_blur,
    rgb_to_grayscale,
    sobel_gradients,
)


def _morph_close(x: torch.Tensor, k: int) -> torch.Tensor:
    """Morphological close of an NHWC map, dilate then erode with a k x k
    window anchored as cv2 anchors it ((k-1)//2 before, k//2 after)
    (augmentation/canny.py's cv2.morphologyEx MORPH_CLOSE)."""
    lo, hi = (k - 1) // 2, k // 2
    pads = (lo, hi, lo, hi)
    t = x.permute(0, 3, 1, 2)
    dil = F.max_pool2d(F.pad(t, pads, value=float("-inf")), k, stride=1)
    ero = -F.max_pool2d(F.pad(-dil, pads, value=float("-inf")), k, stride=1)
    return ero.permute(0, 2, 3, 1)


def edge_brighten(images: torch.Tensor, alpha: float = 0.3, close_k: int = 10) -> torch.Tensor:
    """Gaussian blur -> Canny -> morphological close -> masked edge
    brightening (augmentation/canny.py:9-62, batched)."""
    gray = rgb_to_grayscale(gaussian_blur(images))
    edges = canny_edge_improve(gray, 5.0 / 255.0, 200.0 / 255.0)
    closed = _morph_close(edges, close_k)
    brightened = torch.clamp(images * (1.0 + alpha), 0.0, 1.0)
    return torch.where(closed > 0.5, brightened, images)


def per_channel_canny_enhance(
    images: torch.Tensor,
    thresholds: Tuple[Tuple[float, float], ...] = ((0.17, 0.59), (0.2, 0.63), (0.23, 0.67)),
    gain: float = 20.0,
    mix: Tuple[float, float] = (0.7, 0.3),
) -> torch.Tensor:
    """Per-RGB-channel Canny with per-channel thresholds, the edge-amplified
    channel blended back in (augmentation/RGB_canny.py)."""
    outs = []
    for c, (lo, hi) in enumerate(thresholds):
        ch = images[..., c:c + 1]
        edges = canny_edge_improve(ch, lo, hi)
        amplified = torch.clamp(ch + edges * gain / 255.0 * gain, 0.0, 1.0)
        outs.append(mix[0] * ch + mix[1] * amplified)
    return torch.clamp(torch.cat(outs, dim=-1), 0.0, 1.0)


def sobel_magnitude(images: torch.Tensor) -> torch.Tensor:
    """Sobel gradient magnitude of the grayscale image (augmentation/Sobel.py:8-18)."""
    gx, gy = sobel_gradients(rgb_to_grayscale(images))
    return torch.sqrt(gx * gx + gy * gy)


def laplacian(images: torch.Tensor) -> torch.Tensor:
    """3x3 Laplacian of the grayscale image, zero padding (cv2.Laplacian in
    augmentation/Sobel.py)."""
    gray = rgb_to_grayscale(images).permute(0, 3, 1, 2)
    k = torch.tensor([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]],
                     dtype=gray.dtype, device=gray.device)
    return F.conv2d(gray, k[None, None], padding=1).permute(0, 2, 3, 1)


def rgb_to_hsv_value(images: torch.Tensor) -> torch.Tensor:
    """The HSV V channel, max over RGB (what augmentation/hsv.py:8-13 indexes)."""
    return images.amax(dim=-1, keepdim=True)


def hsv_value_canny(images: torch.Tensor, low: float = 180.0 / 255.0,
                    high: float = 220.0 / 255.0) -> torch.Tensor:
    """Canny on the HSV V channel (augmentation/hsv.py)."""
    return canny_edge_improve(rgb_to_hsv_value(images), low, high)


def hsv_hue_sobel(images: torch.Tensor) -> torch.Tensor:
    """Sobel gradient magnitude of the HSV hue channel
    (augmentation/Sobel_gradient.py:8-20)."""
    r, g, b = images[..., 0:1], images[..., 1:2], images[..., 2:3]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    delta = mx - mn + 1e-8
    h = torch.where(mx == r, torch.remainder((g - b) / delta, 6.0),
                    torch.where(mx == g, (b - r) / delta + 2.0, (r - g) / delta + 4.0)) / 6.0
    gx, gy = sobel_gradients(h)
    return torch.sqrt(gx * gx + gy * gy)
