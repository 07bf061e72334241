"""EELUnet — the flagship edge-enhanced U-Net in PyTorch
(counterpart of ``eelunet_tpu/models/eelunet.py``; reference
models/EELUnet.py:228-471).

4-level U-Net (64->1024 ch) where enc3/enc4/bottleneck/dec3/dec4 use
tokenized-MLP conv blocks; an auxiliary edge decoder runs from the bottleneck
in parallel with the main decoder and is added into each main decoder stage;
five PredictionGuidedRefinement heads emit sigmoid maps for deep
supervision; final LayerNorm + 1x1 conv + sigmoid. 26.26M params.

Layout: NCHW modules on ``channels_last`` tensors. The skip bridges
concatenate ``[dec | enc]`` as the JAX package does; upstream checkpoints,
which interleave the two, are permuted on load (``models/convert.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from eelunet_tpu_torch.nn.layers import (
    BatchNorm2d,
    ChannelLayerNorm,
    ConvBlock,
    center_crop,
    conv1x1,
    conv3x3,
    max_pool2d,
    nchw,
    nhwc,
)
from eelunet_tpu_torch.registry import ModelOutput

HIGHPASS_IMPLS = ("auto", "pallas", "lowrank")


class ChannelAttention(nn.Module):
    """SE-style squeeze-excite (EELUnet.py:8-80)."""

    def __init__(self, c: int, reduction: int = 16, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv0 = conv1x1(c, c // reduction, **kw)
        self.conv1 = conv1x1(c // reduction, c, **kw)

    def forward(self, x):
        w = x.mean(dim=(2, 3), keepdim=True)
        w = self.conv1(F.relu(self.conv0(w)))
        return x * torch.sigmoid(w)


def shifted_channel(x: torch.Tensor, shift_ratio: float = 0.25) -> torch.Tensor:
    """Roll three channel quarters by +1 on H, -1 on H and +1 on W
    (EELUnet.py:83-97), with s = int(0.25 C). NCHW in, NCHW out; the rolls
    run on the NHWC view so a channels_last input stays channels_last."""
    v = nhwc(x)
    s = int(v.shape[-1] * shift_ratio)
    out = torch.cat(
        [
            torch.roll(v[..., :s], 1, dims=1),
            torch.roll(v[..., s : 2 * s], -1, dims=1),
            torch.roll(v[..., 2 * s : 3 * s], 1, dims=2),
            v[..., 3 * s :],
        ],
        dim=-1,
    )
    return nchw(out)


class ChannelAwarePatchedMLP(nn.Module):
    """shift -> 1x1 conv to token_dim -> channel attention -> per-pixel MLP
    (token_dim -> 4 token_dim -> features, exact GELU) -> 1x1 conv
    (EELUnet.py:101-123). The MLP is a Linear over the channels of the NHWC
    view."""

    def __init__(self, cin: int, features: int, token_dim: int = 64,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv0 = conv1x1(cin, token_dim, **kw)
        self.attn = ChannelAttention(token_dim, **kw)
        self.fc0 = nn.Linear(token_dim, 4 * token_dim, **kw)
        self.fc1 = nn.Linear(4 * token_dim, features, **kw)
        self.conv1 = conv1x1(features, features, **kw)

    def forward(self, x):
        x = self.attn(self.conv0(shifted_channel(x)))
        x = nchw(self.fc1(F.gelu(self.fc0(nhwc(x)))))
        return self.conv1(x)


def high_pass_fft_reference(x: torch.Tensor, mask_range: int = 20) -> torch.Tensor:
    """FFT high-pass filter (HighFourierTransform, EELUnet.py:144-191) in its
    literal torch.fft form, NHWC: fft2 -> fftshift -> zero a centred
    (2m x 2m) box -> ifft -> |.|. The golden path for tests."""
    h, w = x.shape[1], x.shape[2]
    crow, ccol = h // 2, w // 2
    m = min(mask_range, crow, ccol)
    mask = torch.ones((h, w), dtype=torch.float32, device=x.device)
    mask[crow - m : crow + m, ccol - m : ccol + m] = 0.0
    mask = mask[None, :, :, None]
    dft = torch.fft.fftshift(torch.fft.fft2(x.float(), dim=(1, 2)), dim=(1, 2))
    dft = torch.fft.ifftshift(dft * mask, dim=(1, 2))
    return torch.abs(torch.fft.ifft2(dft, dim=(1, 2))).to(x.dtype)


def high_pass_fft(x: torch.Tensor, mask_range: int = 20, impl: str = "auto") -> torch.Tensor:
    """The high-pass filter on an NHWC tensor.

    ``impl`` "auto" or "pallas": the kernel pair of ``ops/fft_cuda.py``,
    which launches the CUDA kernels on a CUDA tensor and runs their plain
    twins on a CPU tensor. "lowrank": the plain low-rank formula
    (``ops/fft.py``) on any device, kept as the reference the kernels are
    compared with. Both run their matmuls in float32 inside an autocast
    region too; under autograd "auto" goes through ``HighPassFunction``
    (the backward kernels) and "lowrank" through autograd of its ops."""
    if impl in ("auto", "pallas"):
        from eelunet_tpu_torch.ops.fft_cuda import high_pass_fft_cuda

        return high_pass_fft_cuda(x.contiguous(), mask_range)
    if impl == "lowrank":
        from eelunet_tpu_torch.ops.fft import high_pass_fft_lowrank

        with torch.autocast(x.device.type, enabled=False):
            return high_pass_fft_lowrank(x, mask_range)
    raise ValueError(f"unknown highpass_impl {impl!r} (choices: {HIGHPASS_IMPLS})")


class PredictionGuidedRefinement(nn.Module):
    """1x1 head -> gate features with sigmoid(gt_pre) (EELUnet.py:194-203).
    The sigmoid runs in float32; its f32 map is the aux output."""

    def __init__(self, c: int, device=None, dtype=None):
        super().__init__()
        self.conv0 = conv1x1(c, 1, device=device, dtype=dtype)

    def forward(self, x):
        g32 = torch.sigmoid(self.conv0(x).float())
        return x + x * g32.to(x.dtype), g32


class MlpConvBlock(nn.Module):
    """conv3x3 -> BN -> ReLU -> CAPMLP -> BN -> ReLU (EELUnet.py:347-359)."""

    def __init__(self, cin: int, features: int, features_mid: Optional[int] = None,
                 bn_folded: bool = False, device=None, dtype=None):
        super().__init__()
        mid = features_mid or features
        kw = dict(device=device, dtype=dtype)
        self.conv0 = conv3x3(cin, mid, **kw)
        self.capmlp = ChannelAwarePatchedMLP(mid, features, **kw)
        self.bn = not bn_folded
        if self.bn:
            self.bn0 = BatchNorm2d(mid, **kw)
            self.bn1 = BatchNorm2d(features, **kw)

    def forward(self, x):
        x = self.conv0(x)
        if self.bn:
            x = self.bn0(x)
        x = self.capmlp(F.relu(x))
        if self.bn:
            x = self.bn1(x)
        return F.relu(x)


def _convt(cin: int, cout: int, device=None, dtype=None) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(cin, cout, 2, stride=2, device=device, dtype=dtype)


class UpConvBN(nn.Module):
    """ConvTranspose(k2,s2) -> BN (EELUnet.py:361-366)."""

    def __init__(self, cin: int, features: int, bn_folded: bool = False,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.convt = _convt(cin, features, **kw)
        self.bn = not bn_folded
        if self.bn:
            self.bn0 = BatchNorm2d(features, **kw)

    def forward(self, x):
        x = self.convt(x)
        return self.bn0(x) if self.bn else x


class MlpUpConvBlock(nn.Module):
    """ConvTranspose(k2,s2) -> CAPMLP -> BN (EELUnet.py:368-374)."""

    def __init__(self, cin: int, features: int, features_mid: Optional[int] = None,
                 bn_folded: bool = False, device=None, dtype=None):
        super().__init__()
        mid = features_mid or features
        kw = dict(device=device, dtype=dtype)
        self.convt = _convt(cin, mid, **kw)
        self.capmlp = ChannelAwarePatchedMLP(mid, features, **kw)
        self.bn = not bn_folded
        if self.bn:
            self.bn0 = BatchNorm2d(features, **kw)

    def forward(self, x):
        x = self.capmlp(self.convt(x))
        return self.bn0(x) if self.bn else x


class EELUnet(nn.Module):
    """``widths``: per-group channel widths as (name, size) pairs, the JAX
    model's ``widths`` (physically pruned or narrow test models); None =
    reference widths. ``bn_folded=True``: eval-only model whose conv-adjacent
    BNs were folded into the convs (``bnfold.py``); ``bottleneck_bn`` stays."""

    def __init__(self, in_channels: int = 3, out_channels: int = 1, mask_range: int = 20,
                 widths: Optional[Tuple[Tuple[str, int], ...]] = None,
                 bn_folded: bool = False, highpass_impl: str = "auto",
                 device=None, dtype=None):
        super().__init__()
        if highpass_impl not in HIGHPASS_IMPLS:
            raise ValueError(f"unknown highpass_impl {highpass_impl!r} "
                             f"(choices: {HIGHPASS_IMPLS})")
        self.out_channels = out_channels
        self.mask_range = mask_range
        self.highpass_impl = highpass_impl
        self.bn_folded = bn_folded
        wd = dict(widths or ())
        w = lambda name, default: wd.get(name, default)
        kw = dict(bn_folded=bn_folded, device=device, dtype=dtype)
        dk = dict(device=device, dtype=dtype)

        e1, e2, e3, e4 = w("e1", 64), w("e2", 128), w("e3", 256), w("e4", 512)
        bot = w("bot", 1024)
        d4sum, d3sum, d2sum, d1sum = w("d4sum", 512), w("d3sum", 256), w("d2sum", 128), w("d1sum", 64)
        d4, d3, d2 = w("d4", 512), w("d3", 256), w("d2", 128)

        self.enc1 = ConvBlock(in_channels, e1, w("e1a", 64), **kw)
        self.enc2 = ConvBlock(e1, e2, w("e2a", 128), **kw)
        self.enc3 = MlpConvBlock(e2, e3, w("e3a", 256), **kw)
        self.enc4 = MlpConvBlock(e3, e4, w("e4a", 512), **kw)

        self.bottleneck_bn = BatchNorm2d(e4, **dk)
        self.bottleneck_conv = conv3x3(e4, w("bna", 1024), **dk)
        self.bottleneck_mlp = ChannelAwarePatchedMLP(w("bna", 1024), bot, **dk)
        self.pred5 = PredictionGuidedRefinement(bot, **dk)

        self.edge_up4 = MlpUpConvBlock(bot, w("eu4", 512), w("eu4ct", 512), **kw)
        self.edge_conv4 = MlpConvBlock(w("eu4", 512), d4sum, w("ec4a", 512), **kw)
        self.edge_up3 = MlpUpConvBlock(d4sum, w("eu3", 256), w("eu3ct", 256), **kw)
        self.edge_conv3 = MlpConvBlock(w("eu3", 256), d3sum, w("ec3a", 256), **kw)
        self.edge_up2 = UpConvBN(d3sum, w("eu2", 128), **kw)
        self.edge_conv2 = ConvBlock(w("eu2", 128), d2sum, w("ec2a", 128), **kw)
        self.edge_up1 = UpConvBN(d2sum, w("eu1", 64), **kw)
        self.edge_conv1 = ConvBlock(w("eu1", 64), d1sum, w("ec1a", 64), **kw)

        self.upconv4 = MlpUpConvBlock(bot, d4sum, w("u4ct", 512), **kw)
        self.dec4 = MlpConvBlock(d4sum + e4, d4, w("d4a", 512), **kw)
        self.pred4 = PredictionGuidedRefinement(d4, **dk)
        self.upconv3 = MlpUpConvBlock(d4, d3sum, w("u3ct", 256), **kw)
        self.dec3 = MlpConvBlock(d3sum + e3, d3, w("d3a", 256), **kw)
        self.pred3 = PredictionGuidedRefinement(d3, **dk)
        self.upconv2 = UpConvBN(d3, d2sum, **kw)
        self.dec2 = ConvBlock(d2sum + e2, d2, w("d2a", 128), **kw)
        self.pred2 = PredictionGuidedRefinement(d2, **dk)
        self.upconv1 = UpConvBN(d2, d1sum, **kw)
        # dec1 stays 64 wide in pruned models: final_ln normalises over it.
        self.dec1 = ConvBlock(d1sum + e1, 64, w("d1a", 64), **kw)
        self.pred1 = PredictionGuidedRefinement(64, **dk)

        self.final_ln = ChannelLayerNorm(64, **dk)
        self.final_conv = conv1x1(64, out_channels, **dk)

    def _high_pass(self, x):
        return nchw(high_pass_fft(nhwc(x), self.mask_range, self.highpass_impl))

    @staticmethod
    def _bridge(dec, enc):
        return torch.cat([dec, center_crop(enc, dec.shape[2], dec.shape[3])], dim=1)

    def forward(self, x: torch.Tensor) -> ModelOutput:
        """x: (B,3,H,W), preferably channels_last. Returns seg (B,C,H,W) f32
        and the five aux maps (f32), low to high resolution."""
        assert not (self.bn_folded and self.training), "bn_folded models are eval-only"
        enc1 = self.enc1(x)
        enc2 = self.enc2(max_pool2d(enc1))
        enc3 = self.enc3(max_pool2d(enc2))
        enc4 = self.enc4(max_pool2d(enc3))

        b = self.bottleneck_conv(self.bottleneck_bn(max_pool2d(enc4)))
        bottleneck = F.relu(self.bottleneck_mlp(F.relu(b)))
        bottleneck, edge_5 = self.pred5(bottleneck)

        edge_dec4 = self.edge_conv4(self.edge_up4(bottleneck))
        edge_dec3 = self.edge_conv3(self.edge_up3(edge_dec4))
        edge_dec2 = self.edge_conv2(self._high_pass(self.edge_up2(edge_dec3)))
        edge_dec1 = self.edge_conv1(self._high_pass(self.edge_up1(edge_dec2)))

        dec4 = self.upconv4(bottleneck) + edge_dec4
        dec4 = self.dec4(self._bridge(dec4, enc4))
        dec3, edge_4 = self.pred4(dec4)
        dec3 = self.upconv3(dec3) + edge_dec3
        dec3 = self.dec3(self._bridge(dec3, enc3))
        dec2, edge_3 = self.pred3(dec3)
        dec2 = self.upconv2(dec2) + edge_dec2
        dec2 = self.dec2(self._bridge(dec2, enc2))
        dec1, edge_2 = self.pred2(dec2)
        dec1 = self.upconv1(dec1) + edge_dec1
        dec1 = self.dec1(self._bridge(dec1, enc1))
        seg, edge_1 = self.pred1(dec1)

        seg = self.final_conv(self.final_ln(seg)).float()
        seg = torch.sigmoid(seg) if self.out_channels == 1 else torch.softmax(seg, dim=1)
        return ModelOutput(seg=seg, aux=(edge_5, edge_4, edge_3, edge_2, edge_1))
