"""EGE-UNet (counterpart of ``eelunet_tpu/models/egeunet.py``; reference
models/egeunet.py:217-391). 0.044M params.

A six-stage tiny encoder (``c_list`` 8, 16, 24, 32, 48, 64) with Grouped
multi-axis Hadamard Product Attention (GHPA) in the deep stages; a decoder
with a one-channel ``gt_pre`` head per stage and sigmoid-gated ``merge``
skips (weights 0.1..0.5); every ``gt_pre`` is upsampled bilinearly
(``align_corners=True``) to full resolution. Returns seg = sigmoid(out) and,
with ``gt_ds``, the five sigmoid ``gt_pre`` maps as aux, low to high stage.

Module names are the upstream's (``encoder3.1.conv1``, ``encoder4.0.params_xy``,
``Down1.bn``, ``pred1.conv``, ...); GHPA's parameter maps keep the upstream
shapes, (1, c, x, y) and (1, 1, c, x), and are resized on every call, so
their gradient flows through ``F.interpolate``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from eelunet_tpu_torch.nn import init as tinit
from eelunet_tpu_torch.nn.layers import (
    BatchNorm2d,
    ChannelLayerNorm,
    Float32Params,
    GroupNorm4,
    max_pool2d,
)
from eelunet_tpu_torch.nn.resize import resize_bilinear, upsample2x_bilinear
from eelunet_tpu_torch.registry import ModelOutput


def _gelu(x):
    """Exact-erf GELU (``egeunet.py:31``)."""
    return F.gelu(x)


class KaimingConv(nn.Conv2d):
    """Conv2d with the reference's ``_init_weights``: kaiming-normal over
    fan_out / groups, zero bias (egeunet.py:316-321)."""

    def init_(self, generator: torch.Generator) -> None:
        tinit.kaiming_normal_fan_out_(self.weight, self.groups, generator)
        if self.bias is not None:
            self.bias.data.zero_()


class KaimingConv1d(nn.Conv1d):
    """Conv1d with the reference's Conv1d init, N(0, sqrt(2 / (k x out)))
    with no division by the groups, zero bias (egeunet.py:313-315)."""

    def init_(self, generator: torch.Generator) -> None:
        tinit.conv1d_normal_init_(self.weight, generator)
        if self.bias is not None:
            self.bias.data.zero_()


def _gelu_pair(first: nn.Module, second: nn.Module) -> nn.Sequential:
    """Sequential(first, GELU, second): the upstream's indices 0 and 2."""
    return nn.Sequential(first, nn.GELU(), second)


class GHPA(Float32Params, nn.Module):
    """Grouped multi-axis Hadamard Product Attention (egeunet.py:96-160).

    Channels are chunked into 4 groups. Group 1 is multiplied by a learnable
    (1, c, x, y) map resized to (H, W); groups 2 and 3 by (1, 1, c, x) and
    (1, 1, c, y) curves resized to (c, H) and (c, W), each through a small
    conv stack (Conv1d for the curves); group 4 takes a depthwise path. A
    channel LayerNorm and a depthwise tail mix the groups back together.

    The three maps stay float32 when the module is cast to bf16, and are
    resized in float32, as flax keeps them (``param_dtype``) in a bf16
    model; the resized map takes the compute type before its convs."""

    MAPS = ("params_xy", "params_zx", "params_zy")

    def __init__(self, dim_in: int, dim_out: int, x: int = 8, y: int = 8,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        c = dim_in // 4
        self.params_xy = nn.Parameter(torch.ones(1, c, x, y, **kw))
        self.conv_xy = _gelu_pair(KaimingConv(c, c, 3, padding=1, groups=c, **kw),
                                  KaimingConv(c, c, 1, **kw))
        self.params_zx = nn.Parameter(torch.ones(1, 1, c, x, **kw))
        self.conv_zx = _gelu_pair(KaimingConv1d(c, c, 3, padding=1, groups=c, **kw),
                                  KaimingConv1d(c, c, 1, **kw))
        self.params_zy = nn.Parameter(torch.ones(1, 1, c, y, **kw))
        self.conv_zy = _gelu_pair(KaimingConv1d(c, c, 3, padding=1, groups=c, **kw),
                                  KaimingConv1d(c, c, 1, **kw))
        self.dw = _gelu_pair(KaimingConv(c, c, 1, **kw),
                             KaimingConv(c, c, 3, padding=1, groups=c, **kw))
        self.norm1 = ChannelLayerNorm(dim_in, eps=1e-6, **kw)
        self.norm2 = ChannelLayerNorm(dim_in, eps=1e-6, **kw)
        self.ldw = _gelu_pair(KaimingConv(dim_in, dim_in, 3, padding=1, groups=dim_in, **kw),
                              KaimingConv(dim_in, dim_out, 1, **kw))

    def init_(self, generator: torch.Generator) -> None:
        for name in self.MAPS:
            getattr(self, name).data.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.ldw[0].weight.dtype  # the compute type (a served model's)
        # A float32 input (EGE-UNet's merged skips) is normalised in float32,
        # and the result takes the compute type, as flax's LayerNorm returns.
        x = self.norm1(x).to(dtype)
        x1, x2, x3, x4 = torch.chunk(x, 4, dim=1)
        c, h, w = x1.shape[1:]
        resize = lambda p, oh, ow: resize_bilinear(p, oh, ow, align_corners=True).to(dtype)  # noqa: E731
        x1 = x1 * self.conv_xy(resize(self.params_xy, h, w))
        # (1,1,c,x) -> (1,1,c,H) -> Conv1d over H with c channels: a (c, H) map
        zx = self.conv_zx(resize(self.params_zx, c, h)[0])
        x2 = x2 * zx.view(1, c, h, 1)
        zy = self.conv_zy(resize(self.params_zy, c, w)[0])
        x3 = x3 * zy.view(1, c, 1, w)
        x4 = self.dw(x4)
        x = self.norm2(torch.cat([x1, x2, x3, x4], dim=1))
        return self.ldw(x)


class ConvLayer(nn.Module):
    """k7 depthwise reflect-padded conv, BN, 1x1 up 4x, GELU, 1x1 down, BN,
    GELU (egeunet.py:163-183)."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv1 = KaimingConv(dim, dim, 7, padding=3, groups=dim, padding_mode="reflect",
                                 **kw)
        self.norm1 = BatchNorm2d(dim, **kw)
        self.conv2 = KaimingConv(dim, 4 * dim, 1, **kw)
        self.conv3 = KaimingConv(4 * dim, dim, 1, **kw)
        self.norm2 = BatchNorm2d(dim, **kw)

    def forward(self, x):
        x = _gelu(self.conv2(self.norm1(self.conv1(x))))
        return _gelu(self.norm2(self.conv3(x)))


class Down(nn.Module):
    """BN, then conv k2 s2 (egeunet.py:186-193). The BN comes before a conv,
    so it is not folded."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.bn = BatchNorm2d(dim, device=device, dtype=dtype)
        self.conv = KaimingConv(dim, dim, 2, stride=2, device=device, dtype=dtype)

    def forward(self, x):
        return self.conv(self.bn(x))


class ImagePredictionGenerator(nn.Module):
    """1x1 head and sigmoid gating: (x + x sigmoid(gt_pre), gt_pre)
    (egeunet.py:196-205)."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.conv = KaimingConv(dim, 1, 1, device=device, dtype=dtype)

    def forward(self, x):
        gt_pre = self.conv(x)
        return x + x * torch.sigmoid(gt_pre), gt_pre


def merge(x1, x2, gt_pre, w: float):
    """x1 + x2 + sigmoid(gt_pre) x2 w (egeunet.py:208-214)."""
    return x1 + x2 + torch.sigmoid(gt_pre) * x2 * w


class EGEUNet(nn.Module):
    """``bridge`` is the reference's flag; its GAB bridge is commented out
    upstream, so it changes nothing, as in the JAX model."""

    def __init__(self, in_channels: int = 3, num_classes: int = 1,
                 c_list: Tuple[int, ...] = (8, 16, 24, 32, 48, 64), bridge: bool = True,
                 gt_ds: bool = True, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        c = self.c_list = tuple(c_list)
        self.num_classes, self.bridge, self.gt_ds = num_classes, bridge, gt_ds
        conv = lambda cin, cout: nn.Sequential(KaimingConv(cin, cout, 3, padding=1, **kw))  # noqa: E731
        self.encoder1 = conv(in_channels, c[0])
        self.encoder2 = conv(c[0], c[1])
        self.encoder3 = nn.Sequential(KaimingConv(c[1], c[2], 3, padding=1, **kw),
                                      ConvLayer(c[2], **kw))
        self.encoder4 = nn.Sequential(GHPA(c[2], c[3], **kw))
        self.encoder5 = nn.Sequential(GHPA(c[3], c[4], **kw))
        self.encoder6 = nn.Sequential(GHPA(c[4], c[5], **kw))
        self.decoder1 = nn.Sequential(GHPA(c[5], c[4], **kw))
        self.decoder2 = nn.Sequential(GHPA(c[4], c[3], **kw))
        self.decoder3 = nn.Sequential(GHPA(c[3], c[2], **kw))
        self.decoder4 = conv(c[2], c[1])
        self.decoder5 = conv(c[1], c[0])
        for i, ch in enumerate((c[4], c[3], c[2], c[1], c[0]), 1):
            self.add_module(f"pred{i}", ImagePredictionGenerator(ch, **kw))
        for i in (1, 2, 3):
            self.add_module(f"Down{i}", Down(c[i - 1], **kw))
        for i in range(1, 6):
            self.add_module(f"ebn{i}", GroupNorm4(c[i - 1], **kw))
        for i, ch in enumerate((c[4], c[3], c[2], c[1], c[0]), 1):
            self.add_module(f"dbn{i}", GroupNorm4(ch, **kw))
        self.final = KaimingConv(c[0], num_classes, 1, **kw)

    def forward(self, x: torch.Tensor) -> ModelOutput:
        up = lambda t: upsample2x_bilinear(t, align_corners=True)  # noqa: E731
        out = t1 = _gelu(self.Down1(self.ebn1(self.encoder1(x))))          # H/2
        out = t2 = _gelu(self.Down2(self.ebn2(self.encoder2(out))))        # H/4
        out = t3 = _gelu(self.Down3(self.ebn3(self.encoder3(out))))        # H/8
        out = t4 = _gelu(max_pool2d(self.ebn4(self.encoder4(out))))        # H/16
        out = t5 = _gelu(max_pool2d(self.ebn5(self.encoder5(out))))        # H/32
        out = _gelu(self.encoder6(out))

        dtype = self.final.bias.dtype  # the compute type; an int8 head keeps its bias in it
        gt_pres = []
        stages = ((self.decoder1, self.dbn1, self.pred1, t5, 0.1, False),
                  (self.decoder2, self.dbn2, self.pred2, t4, 0.2, True),
                  (self.decoder3, self.dbn3, self.pred3, t3, 0.3, True),
                  (self.decoder4, self.dbn4, self.pred4, t2, 0.4, True),
                  (self.decoder5, self.dbn5, self.pred5, t1, 0.5, True))
        for dec, norm, pred, skip, w, upsample in stages:
            out = norm(dec(out if isinstance(dec[0], GHPA) else out.to(dtype)))
            out = _gelu(up(out) if upsample else out)
            out, gt_pre = pred(out)
            # in float32, as the JAX model merges with its float32 gt_pre
            out = merge(out, skip, gt_pre.float(), w)
            gt_pres.append(gt_pre)

        out = up(self.final(out.to(dtype))).float()
        seg = torch.sigmoid(out) if self.num_classes == 1 else torch.softmax(out, dim=1)
        if not self.gt_ds:
            return ModelOutput(seg=seg)
        h, w = x.shape[2], x.shape[3]
        aux = tuple(torch.sigmoid(resize_bilinear(g.float(), h, w, align_corners=True))
                    for g in gt_pres)
        return ModelOutput(seg=seg, aux=aux)
