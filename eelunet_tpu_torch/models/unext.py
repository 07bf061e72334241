"""UNeXt and UNeXt-S (counterpart of ``eelunet_tpu/models/unext.py``;
reference models/unext.py:191-325, 328-462).

Three conv stages (BN, 2x max-pool), then two tokenized-MLP stages; the
shift-MLP pads, rolls five channel chunks by -2..+2 pixels along H (before
fc1) and W (before fc2) and crops back; the decoder upsamples bilinearly
with ``align_corners=False`` (torch's default, unlike the other families)
and adds the skips. Returns logits. UNext 1.47M params, UNext_S 0.25M.

Module names are the upstream's (``encoder1``, ``ebn1``,
``patch_embed3.proj``, ``block1.0.mlp.fc1``, ``dnorm3``, ...); the token MLP
is a Linear over the channels of the NHWC view of a channels_last tensor.
``bn_folded=True``: the seven conv-adjacent BNs (``ebn1-3``, ``dbn1-4``)
were folded into their convs (``bnfold.py``); eval-only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from eelunet_tpu_torch.nn import init as tinit
from eelunet_tpu_torch.nn.layers import (
    BatchNorm2d,
    ChannelLayerNorm,
    DropPath,
    conv1x1,
    conv3x3,
    max_pool2d,
    nchw,
    nhwc,
)
from eelunet_tpu_torch.nn.resize import upsample2x_bilinear
from eelunet_tpu_torch.registry import ModelOutput


def shift_chunks(x: torch.Tensor, dim: int, shift_size: int = 5) -> torch.Tensor:
    """The shift-MLP's spatial shift (unext.py:70-76), the upstream way: pad
    H and W by ``shift_size // 2`` with zeros, ``torch.chunk`` the channels
    into ``shift_size`` pieces (fewer when the channels are few, the last
    one short), roll piece i by i - pad along ``dim`` (2 = H, 3 = W of an
    NCHW tensor), concatenate and crop the padding off."""
    pad = shift_size // 2
    h, w = x.shape[2], x.shape[3]
    xs = torch.chunk(F.pad(x, (pad, pad, pad, pad)), shift_size, 1)
    out = torch.cat([torch.roll(c, s, dim) for c, s in zip(xs, range(-pad, pad + 1))], 1)
    return out[:, :, pad:pad + h, pad:pad + w]


class KaimingNormalConv(nn.Conv2d):
    """Conv2d with the reference's ``_init_weights`` (unext.py:50-57):
    kaiming-normal over fan_out / groups, zero bias."""

    def init_(self, generator: torch.Generator) -> None:
        tinit.kaiming_normal_fan_out_(self.weight, self.groups, generator)
        if self.bias is not None:
            self.bias.data.zero_()


class TruncNormalLinear(nn.Linear):
    """Linear with trunc_normal(0.02) weights and a zero bias (unext.py:44-48)."""

    def init_(self, generator: torch.Generator) -> None:
        tinit.trunc_normal_(self.weight, 0.02, generator)
        self.bias.data.zero_()


class DWConv(nn.Module):
    """Depthwise 3x3 over the token grid (unext.py:134-145)."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.dwconv = KaimingNormalConv(dim, dim, 3, padding=1, groups=dim,
                                        device=device, dtype=dtype)

    def forward(self, x):
        return self.dwconv(x)


class ShiftMLP(nn.Module):
    """shift H -> fc1 -> DWConv -> GELU -> shift W -> fc2 (unext.py:27-99);
    dropout 0, as every configuration of the JAX package."""

    def __init__(self, dim: int, hidden: int, out: int, shift_size: int = 5,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.shift_size = shift_size
        self.fc1 = TruncNormalLinear(dim, hidden, **kw)
        self.dwconv = DWConv(hidden, **kw)
        self.fc2 = TruncNormalLinear(hidden, out, **kw)

    def forward(self, x):
        x = shift_chunks(x, 2, self.shift_size)
        x = F.gelu(self.dwconv(nchw(self.fc1(nhwc(x)))))
        x = shift_chunks(x, 3, self.shift_size)
        return nchw(self.fc2(nhwc(x)))


class ShiftedBlock(nn.Module):
    """x + DropPath(shiftmlp(LN(x))), mlp_ratio 1 (unext.py:102-131)."""

    def __init__(self, dim: int, drop_path: float = 0.0,
                 generator: Optional[torch.Generator] = None, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm2 = ChannelLayerNorm(dim, eps=1e-5, **kw)
        self.mlp = ShiftMLP(dim, dim, dim, **kw)
        self.drop_path = DropPath(drop_path, generator)

    def forward(self, x):
        return x + self.drop_path(self.mlp(self.norm2(x)))


class OverlapPatchEmbed(nn.Module):
    """Conv k3 s2 p1 + LayerNorm over the channels (unext.py:148-188)."""

    def __init__(self, cin: int, dim: int, device=None, dtype=None):
        super().__init__()
        self.proj = KaimingNormalConv(cin, dim, 3, stride=2, padding=1,
                                      device=device, dtype=dtype)
        self.norm = ChannelLayerNorm(dim, eps=1e-5, device=device, dtype=dtype)

    def forward(self, x):
        return self.norm(self.proj(x))


class UNext(nn.Module):
    """``dims`` = (conv1, conv2, embed0, embed1, embed2): UNext (16, 32, 128,
    160, 256), UNext_S (8, 16, 32, 64, 128)."""

    DIMS: Tuple[int, int, int, int, int] = (16, 32, 128, 160, 256)

    def __init__(self, in_channels: int = 3, num_classes: int = 1,
                 dims: Optional[Tuple[int, int, int, int, int]] = None,
                 bn_folded: bool = False, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        c1, c2, e0, e1, e2 = self.dims = tuple(dims or self.DIMS)
        self.bn_folded = bn_folded
        self.encoder1 = conv3x3(in_channels, c1, **kw)
        self.encoder2 = conv3x3(c1, c2, **kw)
        self.encoder3 = conv3x3(c2, e0, **kw)
        self.patch_embed3 = OverlapPatchEmbed(e0, e1, **kw)
        self.patch_embed4 = OverlapPatchEmbed(e1, e2, **kw)
        self.block1 = nn.ModuleList([ShiftedBlock(e1, **kw)])
        self.block2 = nn.ModuleList([ShiftedBlock(e2, **kw)])
        self.dblock1 = nn.ModuleList([ShiftedBlock(e1, **kw)])
        self.dblock2 = nn.ModuleList([ShiftedBlock(e0, **kw)])
        self.norm3 = ChannelLayerNorm(e1, eps=1e-5, **kw)
        self.norm4 = ChannelLayerNorm(e2, eps=1e-5, **kw)
        self.dnorm3 = ChannelLayerNorm(e1, eps=1e-5, **kw)
        self.dnorm4 = ChannelLayerNorm(e0, eps=1e-5, **kw)
        self.decoder1 = conv3x3(e2, e1, **kw)
        self.decoder2 = conv3x3(e1, e0, **kw)
        self.decoder3 = conv3x3(e0, c2, **kw)
        self.decoder4 = conv3x3(c2, c1, **kw)
        self.decoder5 = conv3x3(c1, c1, **kw)
        if not bn_folded:
            for name, c in (("ebn1", c1), ("ebn2", c2), ("ebn3", e0), ("dbn1", e1),
                            ("dbn2", e0), ("dbn3", c2), ("dbn4", c1)):
                self.add_module(name, BatchNorm2d(c, **kw))
        self.final = conv1x1(c1, num_classes, **kw)

    def _bn(self, name: str, x):
        return x if self.bn_folded else getattr(self, name)(x)

    def forward(self, x: torch.Tensor) -> ModelOutput:
        assert not (self.bn_folded and self.training), "bn_folded models are eval-only"
        up = upsample2x_bilinear
        out = t1 = F.relu(max_pool2d(self._bn("ebn1", self.encoder1(x))))
        out = t2 = F.relu(max_pool2d(self._bn("ebn2", self.encoder2(out))))
        out = t3 = F.relu(max_pool2d(self._bn("ebn3", self.encoder3(out))))

        out = self.norm3(self.block1[0](self.patch_embed3(out)))
        t4 = out
        out = self.norm4(self.block2[0](self.patch_embed4(out)))

        out = F.relu(up(self._bn("dbn1", self.decoder1(out)))) + t4
        out = self.dnorm3(self.dblock1[0](out))
        out = F.relu(up(self._bn("dbn2", self.decoder2(out)))) + t3
        out = self.dnorm4(self.dblock2[0](out))
        out = F.relu(up(self._bn("dbn3", self.decoder3(out)))) + t2
        out = F.relu(up(self._bn("dbn4", self.decoder4(out)))) + t1
        out = F.relu(up(self.decoder5(out)))
        return ModelOutput(seg=self.final(out).float())


class UNextS(UNext):
    DIMS = (8, 16, 32, 64, 128)
