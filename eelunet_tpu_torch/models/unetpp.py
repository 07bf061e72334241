"""UNet++, the repaired nested-skip U-Net (counterpart of
``eelunet_tpu/models/unetpp.py``).

Upstream's UnetPlusPlus crashes on its forward (UnetPlusPlus.py:50-76), so
this is the JAX package's working design, held to the JAX model: five
levels, features (32, 64, 128, 256, 512); node X[i][j] takes every
X[i][0..j-1] and the 2x transposed-conv upsampling of X[i+1][j-1]; conv
blocks without BN; logits from X[0][4]. No upstream layout exists, so the
port's own module names (``x_{i}_{j}``, ``up_{i}_{j}``, ``final``) are its
checkpoint layout.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from eelunet_tpu_torch.nn.layers import ConvReLUBlock, conv1x1, conv_transpose2x2, max_pool2d
from eelunet_tpu_torch.registry import ModelOutput


class UnetPlusPlus(nn.Module):
    def __init__(self, in_channels: int = 3, out_channels: int = 1,
                 features: Tuple[int, ...] = (32, 64, 128, 256, 512), device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        f = self.features = tuple(features)
        depth = len(f)
        for i in range(depth):
            self.add_module(f"x_{i}_0", ConvReLUBlock(in_channels if i == 0 else f[i - 1],
                                                      f[i], **kw))
        for j in range(1, depth):
            for i in range(depth - j):
                self.add_module(f"up_{i}_{j}", conv_transpose2x2(f[i + 1], f[i], **kw))
                self.add_module(f"x_{i}_{j}", ConvReLUBlock((j + 1) * f[i], f[i], **kw))
        self.final = conv1x1(f[0], out_channels, **kw)

    def forward(self, x: torch.Tensor) -> ModelOutput:
        depth = len(self.features)
        nodes = [[None] * depth for _ in range(depth)]
        h = x
        for i in range(depth):
            if i > 0:
                h = max_pool2d(h)
            h = nodes[i][0] = getattr(self, f"x_{i}_0")(h)
        for j in range(1, depth):
            for i in range(depth - j):
                up = getattr(self, f"up_{i}_{j}")(nodes[i + 1][j - 1])
                cat = torch.cat([*(nodes[i][k] for k in range(j)), up], dim=1)
                nodes[i][j] = getattr(self, f"x_{i}_{j}")(cat)
        return ModelOutput(seg=self.final(nodes[0][depth - 1]).float())
