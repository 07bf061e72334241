"""Vanilla 4-level U-Net (counterpart of ``eelunet_tpu/models/unet.py``;
reference models/Unet.py:4-98).

Conv blocks without BN, transposed-conv upsampling, center-crop and concat
skips ``[dec | enc]``, a 1x1 final conv; returns logits. 31.03M params.
Module names are the upstream's (``enc1.0``, ``upconv4.0``, ``conv4.2``,
``final_conv``), so an upstream ``state_dict`` loads as it is.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from eelunet_tpu_torch.nn.layers import (
    ConvReLUBlock,
    center_crop,
    conv1x1,
    conv_transpose2x2,
    max_pool2d,
)
from eelunet_tpu_torch.registry import ModelOutput


class Unet(nn.Module):
    """The width tuples default to the reference sizes (Unet.py:58-74); a
    physically pruned model carries slimmed per-conv counts: (mid, out) per
    conv block, out per upconv."""

    def __init__(
        self,
        in_channels: int = 3,
        out_channels: int = 1,
        enc_widths: Tuple[Tuple[int, int], ...] = ((64, 64), (128, 128), (256, 256), (512, 512)),
        bottleneck_widths: Tuple[int, int] = (1024, 1024),
        up_widths: Tuple[int, ...] = (512, 256, 128, 64),
        dec_widths: Tuple[Tuple[int, int], ...] = ((512, 512), (256, 256), (128, 128), (64, 64)),
        device=None,
        dtype=None,
    ):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        ew, bw, uw, dw = enc_widths, bottleneck_widths, up_widths, dec_widths
        self.enc1 = ConvReLUBlock(in_channels, ew[0][1], ew[0][0], **kw)
        self.enc2 = ConvReLUBlock(ew[0][1], ew[1][1], ew[1][0], **kw)
        self.enc3 = ConvReLUBlock(ew[1][1], ew[2][1], ew[2][0], **kw)
        self.enc4 = ConvReLUBlock(ew[2][1], ew[3][1], ew[3][0], **kw)
        self.bottleneck = ConvReLUBlock(ew[3][1], bw[1], bw[0], **kw)
        ups, decs, cin = [], [], bw[1]
        for i in range(4):
            # upstream's upconv_block: Sequential(ConvTranspose2d) (Unet.py:42-46)
            ups.append(nn.Sequential(conv_transpose2x2(cin, uw[i], **kw)))
            decs.append(ConvReLUBlock(uw[i] + ew[3 - i][1], dw[i][1], dw[i][0], **kw))
            cin = dw[i][1]
        self.upconv4, self.upconv3, self.upconv2, self.upconv1 = ups
        self.conv4, self.conv3, self.conv2, self.conv1 = decs
        self.final_conv = conv1x1(cin, out_channels, **kw)

    def forward(self, x: torch.Tensor) -> ModelOutput:
        enc1 = self.enc1(x)
        enc2 = self.enc2(max_pool2d(enc1))
        enc3 = self.enc3(max_pool2d(enc2))
        enc4 = self.enc4(max_pool2d(enc3))
        out = self.bottleneck(max_pool2d(enc4))
        for up, conv, skip in ((self.upconv4, self.conv4, enc4), (self.upconv3, self.conv3, enc3),
                               (self.upconv2, self.conv2, enc2), (self.upconv1, self.conv1, enc1)):
            out = up(out)
            out = conv(torch.cat([out, center_crop(skip, out.shape[2], out.shape[3])], dim=1))
        return ModelOutput(seg=self.final_conv(out).float())
