"""Bilinear resizing (counterpart of ``eelunet_tpu/nn/resize.py``).

The JAX module emulates ``F.interpolate(mode="bilinear")`` in both
``align_corners`` modes, source coordinates clamped to the image; here it is
that call itself, on NCHW tensors. EGE-UNet and MALUNet resize with
``align_corners=True``, UNeXt with ``False`` (torch's default).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int, *,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinearly resize an NCHW tensor to (out_h, out_w)."""
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=align_corners)


def upsample2x_bilinear(x: torch.Tensor, *, align_corners: bool = False) -> torch.Tensor:
    """2x bilinear upsampling of an NCHW tensor."""
    return resize_bilinear(x, x.shape[-2] * 2, x.shape[-1] * 2, align_corners=align_corners)
