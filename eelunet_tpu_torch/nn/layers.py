"""NCHW layer library (counterpart of ``eelunet_tpu/nn/layers.py:239-338``).

Modules take NCHW tensors in ``torch.channels_last`` memory format, so the
NHWC view ``x.permute(0, 2, 3, 1)`` is contiguous and free: the channel-axis
ops (LayerNorm, the token MLP) run on that view.

Submodule names follow the flax module names with a fixed rewrite
(``TorchConv_i`` -> ``conv{i}``, ``BatchNorm_i`` -> ``bn{i}``; see
``models/convert.py``), which keeps the weight mapping mechanical.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NHWC view (contiguous when ``x`` is channels_last)."""
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels_last strides when ``x`` is contiguous)."""
    return x.permute(0, 3, 1, 2)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d(eps=1e-5)`` whose eval-mode affine runs in float32.

    flax's BatchNorm in a bf16 model normalises with f32 statistics and casts
    the result to bf16 (``eelunet_tpu/nn/layers.py:208-226``); this does the
    same whatever dtype the parameters were cast to.

    Train mode is ``nn.BatchNorm2d``'s own, which is what the JAX package's
    ``_TorchExactBatchNorm`` (``nn/layers.py:98-206``) emulates: batch
    statistics with the biased variance, running statistics with momentum
    0.1 (flax's 0.9) and the Bessel-corrected variance. Under bf16 autocast
    it takes a bf16 input with f32 affine and statistics and returns bf16."""

    def __init__(self, num_features: int, device=None, dtype=None):
        super().__init__(num_features, eps=1e-5, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return super().forward(x)
        y = F.batch_norm(
            x.float(), self.running_mean.float(), self.running_var.float(),
            self.weight.float(), self.bias.float(), False, 0.0, self.eps,
        )
        return y.to(x.dtype)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis, eps 1e-6, statistics in float32
    (``eelunet_tpu/nn/layers.py:239-253``)."""

    def __init__(self, channels: int, eps: float = 1e-6, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(channels, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(nhwc(x).float(), (x.shape[1],), self.weight.float(),
                         self.bias.float(), self.eps)
        return nchw(y.to(x.dtype))


def conv3x3(cin: int, cout: int, device=None, dtype=None) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, device=device, dtype=dtype)


def conv1x1(cin: int, cout: int, device=None, dtype=None) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, device=device, dtype=dtype)


def max_pool2d(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """F.max_pool2d(kernel=k, stride=k) over NCHW."""
    return F.max_pool2d(x, k)


def center_crop(x: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
    """Center-crop the spatial dims of an NCHW tensor."""
    h, w = x.shape[-2], x.shape[-1]
    top = (h - target_h) // 2
    left = (w - target_w) // 2
    return x[..., top : top + target_h, left : left + target_w]


class ConvBlock(nn.Module):
    """conv3x3 [+BN] ReLU conv3x3 [+BN] ReLU (``nn/layers.py:309-338``).

    ``bn_folded=True``: the BN affines were absorbed into the convs
    (``bnfold.py``), so the block has no BN modules. Eval-only."""

    def __init__(self, cin: int, features: int, features_mid: Optional[int] = None,
                 use_bn: bool = True, bn_folded: bool = False, device=None, dtype=None):
        super().__init__()
        mid = features_mid or features
        kw = dict(device=device, dtype=dtype)
        self.conv0 = conv3x3(cin, mid, **kw)
        self.conv1 = conv3x3(mid, features, **kw)
        self.bn = use_bn and not bn_folded
        if self.bn:
            self.bn0 = BatchNorm2d(mid, **kw)
            self.bn1 = BatchNorm2d(features, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv0(x)
        if self.bn:
            x = self.bn0(x)
        x = self.conv1(F.relu(x))
        if self.bn:
            x = self.bn1(x)
        return F.relu(x)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """PyTorch's default initialisation, drawn from ``generator``.

    Conv, transposed conv and Linear layers get ``reset_parameters``' own
    distributions (kaiming-uniform weights with a=sqrt(5), bias uniform in
    +-1/sqrt(fan_in)); norms keep their identity init. Returns ``module``."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)
            if m.bias is not None:
                fan_in, _ = nn.init._calculate_fan_in_and_fan_out(m.weight)
                bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
    return module
