"""MALUNet (counterpart of ``eelunet_tpu/models/malunet.py``; reference
models/malunet.py:198-324). 0.178M params.

A six-stage tiny U-Net (``c_list`` 8, 16, 24, 32, 48, 64) with external
attention (``EAblock``) and dilated gated attention (``DilatedGatedAttention``)
in the deep stages and a spatial-then-channel attention bridge
(``SCAttBridge``) across the five skips; additive skips; bilinear
(``align_corners=True``) upsampling; sigmoid output.

Module names are the upstream's (``encoder4.0.linear_0``,
``encoder4.1.gau.w1.0.conv1``, ``scab.satt.shared_conv2d.0``, ...). The
external attention's two 1x1 Conv1d keep the upstream's shapes, (4C, C, 1)
and (C, 4C, 1).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from eelunet_tpu_torch.models.egeunet import KaimingConv, _gelu
from eelunet_tpu_torch.nn.layers import GroupNorm4, max_pool2d
from eelunet_tpu_torch.nn.resize import upsample2x_bilinear
from eelunet_tpu_torch.registry import ModelOutput

SPLIT_ATTS = ("fc", "conv")


class DepthWiseConv2d(nn.Module):
    """Depthwise conv -> GroupNorm(4) -> 1x1 conv (malunet.py:9-19)."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int = 3, padding: int = 1,
                 dilation: int = 1, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv1 = KaimingConv(dim_in, dim_in, kernel_size, padding=padding,
                                 dilation=dilation, groups=dim_in, **kw)
        self.norm_layer = GroupNorm4(dim_in, **kw)
        self.conv2 = KaimingConv(dim_in, dim_out, 1, **kw)

    def forward(self, x):
        return self.conv2(self.norm_layer(self.conv1(x)))


class GatedAttentionUnit(nn.Module):
    """sigmoid(DW k) * GELU(DW k+2) -> DW to out, GELU, + a 1x1 residual
    (malunet.py:22-44)."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int = 3, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        k = kernel_size
        self.w1 = nn.Sequential(DepthWiseConv2d(dim_in, dim_in, k, padding=k // 2, **kw),
                                nn.Sigmoid())
        self.w2 = nn.Sequential(DepthWiseConv2d(dim_in, dim_in, k + 2, padding=(k + 2) // 2,
                                                **kw), nn.GELU())
        self.wo = nn.Sequential(DepthWiseConv2d(dim_in, dim_out, k, **kw), nn.GELU())
        self.cw = KaimingConv(dim_in, dim_out, 1, **kw)

    def forward(self, x):
        return self.wo(self.w1(x) * self.w2(x)) + self.cw(x)


class DilatedGatedAttention(nn.Module):
    """Four channel chunks through depthwise convs dilated 7, 5, 2, 1 ->
    GroupNorm(4) -> 1x1 conv, GELU -> GatedAttentionUnit (malunet.py:47-76)."""

    def __init__(self, dim_in: int, dim_out: int, k_size: int = 3,
                 dilated_ratio: Tuple[int, int, int, int] = (7, 5, 2, 1), device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        cq = dim_in // 4
        for i, d in enumerate(dilated_ratio):
            pad = (k_size + (k_size - 1) * (d - 1)) // 2
            self.add_module(f"mda{i}", KaimingConv(cq, cq, k_size, padding=pad, dilation=d,
                                                   groups=cq, **kw))
        self.norm_layer = GroupNorm4(dim_in, **kw)
        self.conv = KaimingConv(dim_in, dim_in, 1, **kw)
        self.gau = GatedAttentionUnit(dim_in, dim_out, 3, **kw)

    def forward(self, x):
        chunks = torch.chunk(x, 4, dim=1)
        x = torch.cat([getattr(self, f"mda{i}")(c) for i, c in enumerate(chunks)], dim=1)
        x = _gelu(self.conv(self.norm_layer(x)))
        return self.gau(x)


class EAblock(nn.Module):
    """External attention (malunet.py:79-111): a 1x1 Conv1d C -> 4C over the
    flattened positions, softmax over the positions, L1 over the 4C keys,
    Conv1d 4C -> C back. ``linear_1`` starts as ``linear_0`` transposed and
    then trains on its own (malunet.py:89): init-only coupling.

    In the JAX package the two are raw (C, 4C) and (4C, C) matmul
    parameters, not conv kernels: pruning leaves them out and int8
    quantization counts them as dots (``MATMULS``)."""

    MATMULS = ("linear_0", "linear_1")

    def __init__(self, c: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        k = 4 * c
        self.conv1 = KaimingConv(c, c, 1, **kw)
        self.linear_0 = nn.Conv1d(c, k, 1, bias=False, **kw)
        self.linear_1 = nn.Conv1d(k, c, 1, bias=False, **kw)
        self.linear_1.weight.data.copy_(self.linear_0.weight.data.permute(1, 0, 2))
        self.conv2 = KaimingConv(c, c, 1, bias=False, **kw)
        self.norm_layer = GroupNorm4(c, **kw)

    def init_(self, generator: torch.Generator) -> None:
        # linear_0 took PyTorch's default (the JAX package's torch_linear_init
        # over fan_in = C); linear_1 is its transpose.
        self.linear_1.weight.data.copy_(self.linear_0.weight.data.permute(1, 0, 2))

    def forward(self, x):
        idn = x
        x = self.conv1(x)
        b, c, h, w = x.shape
        attn = F.softmax(self.linear_0(x.reshape(b, c, h * w)), dim=-1)  # over the positions
        attn = attn / (1e-9 + attn.sum(dim=1, keepdim=True))             # L1 over the keys
        x = self.linear_1(attn).reshape(b, c, h, w)
        x = self.norm_layer(self.conv2(x))
        return _gelu(x + idn)


class ChannelAttBridge(nn.Module):
    """Channel attention shared by the five skips (malunet.py:114-155): the
    pooled channels of all skips as one sequence, a k3 Conv1d over it, and
    per skip a dense layer and a sigmoid. Upstream's two ``split_att``
    branches (Linear, and Conv1d k1) are the same biased dense map; as in
    the JAX package, both are a Linear here."""

    def __init__(self, c_list: Sequence[int], split_att: str = "fc", device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        c_sum = sum(c_list)
        self.split_att = split_att
        self.get_all_att = nn.Conv1d(1, 1, 3, padding=1, bias=False, **kw)
        for i, c in enumerate(c_list, 1):
            self.add_module(f"att{i}", nn.Linear(c_sum, c, **kw))

    def forward(self, ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        att = torch.cat([t.mean(dim=(2, 3)) for t in ts], dim=1)     # (B, Csum)
        att = self.get_all_att(att.unsqueeze(1)).squeeze(1)
        return [torch.sigmoid(getattr(self, f"att{i}")(att))[:, :, None, None]
                for i in range(1, len(ts) + 1)]


class SpatialAttBridge(nn.Module):
    """One conv (2 -> 1, k7, dilation 3) on each skip's [mean, max] over the
    channels, then a sigmoid (malunet.py:158-173)."""

    def __init__(self, device=None, dtype=None):
        super().__init__()
        self.shared_conv2d = nn.Sequential(
            KaimingConv(2, 1, 7, padding=9, dilation=3, device=device, dtype=dtype), nn.Sigmoid())

    def forward(self, ts):
        return [self.shared_conv2d(torch.cat([t.mean(dim=1, keepdim=True),
                                              t.amax(dim=1, keepdim=True)], dim=1))
                for t in ts]


class SCAttBridge(nn.Module):
    """Spatial, then channel attention, with the reference's residuals
    (malunet.py:176-195)."""

    def __init__(self, c_list: Sequence[int], split_att: str = "fc", device=None, dtype=None):
        super().__init__()
        self.satt = SpatialAttBridge(device=device, dtype=dtype)
        self.catt = ChannelAttBridge(c_list, split_att, device=device, dtype=dtype)

    def forward(self, ts):
        r = ts
        ts = [s * t for s, t in zip(self.satt(ts), ts)]
        r_ = ts
        ts = [t + ri for t, ri in zip(ts, r)]
        ts = [c * t for c, t in zip(self.catt(ts), ts)]
        return [t + ri for t, ri in zip(ts, r_)]


class MALUNet(nn.Module):
    def __init__(self, in_channels: int = 3, num_classes: int = 1,
                 c_list: Tuple[int, ...] = (8, 16, 24, 32, 48, 64), split_att: str = "fc",
                 bridge: bool = True, device=None, dtype=None):
        super().__init__()
        if split_att not in SPLIT_ATTS:
            raise ValueError(f"unknown split_att {split_att!r} (choices: {SPLIT_ATTS})")
        kw = dict(device=device, dtype=dtype)
        c = self.c_list = tuple(c_list)
        self.num_classes, self.bridge = num_classes, bridge
        conv = lambda cin, cout: nn.Sequential(KaimingConv(cin, cout, 3, padding=1, **kw))  # noqa: E731
        self.encoder1 = conv(in_channels, c[0])
        self.encoder2 = conv(c[0], c[1])
        self.encoder3 = conv(c[1], c[2])
        for i in (4, 5, 6):
            self.add_module(f"encoder{i}", nn.Sequential(
                EAblock(c[i - 2], **kw), DilatedGatedAttention(c[i - 2], c[i - 1], **kw)))
        if bridge:
            self.scab = SCAttBridge(c[:5], split_att, **kw)
        for i, (cin, cout) in enumerate(((c[5], c[4]), (c[4], c[3]), (c[3], c[2])), 1):
            self.add_module(f"decoder{i}", nn.Sequential(
                DilatedGatedAttention(cin, cout, **kw), EAblock(cout, **kw)))
        self.decoder4 = conv(c[2], c[1])
        self.decoder5 = conv(c[1], c[0])
        for i in range(1, 6):
            self.add_module(f"ebn{i}", GroupNorm4(c[i - 1], **kw))
        for i, ch in enumerate((c[4], c[3], c[2], c[1], c[0]), 1):
            self.add_module(f"dbn{i}", GroupNorm4(ch, **kw))
        self.final = KaimingConv(c[0], num_classes, 1, **kw)

    def forward(self, x: torch.Tensor) -> ModelOutput:
        up = lambda t: upsample2x_bilinear(t, align_corners=True)  # noqa: E731
        out = t1 = _gelu(max_pool2d(self.ebn1(self.encoder1(x))))
        out = t2 = _gelu(max_pool2d(self.ebn2(self.encoder2(out))))
        out = t3 = _gelu(max_pool2d(self.ebn3(self.encoder3(out))))
        out = t4 = _gelu(max_pool2d(self.ebn4(self.encoder4(out))))
        out = t5 = _gelu(max_pool2d(self.ebn5(self.encoder5(out))))
        if self.bridge:
            t1, t2, t3, t4, t5 = self.scab([t1, t2, t3, t4, t5])
        out = _gelu(self.encoder6(out))

        out = _gelu(self.dbn1(self.decoder1(out))) + t5
        out = _gelu(up(self.dbn2(self.decoder2(out)))) + t4
        out = _gelu(up(self.dbn3(self.decoder3(out)))) + t3
        out = _gelu(up(self.dbn4(self.decoder4(out)))) + t2
        out = _gelu(up(self.dbn5(self.decoder5(out)))) + t1
        out = up(self.final(out)).float()
        seg = torch.sigmoid(out) if self.num_classes == 1 else torch.softmax(out, dim=1)
        return ModelOutput(seg=seg)
