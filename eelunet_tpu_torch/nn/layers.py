"""NCHW layer library (counterpart of ``eelunet_tpu/nn/layers.py``).

Modules take NCHW tensors in ``torch.channels_last`` memory format, so the
NHWC view ``x.permute(0, 2, 3, 1)`` is contiguous and free: the channel-axis
ops (LayerNorm, the token MLP) run on that view.

Submodule names follow the flax module names with a fixed rewrite
(``TorchConv_i`` -> ``conv{i}``, ``BatchNorm_i`` -> ``bn{i}``; see
``models/convert.py``), which keeps the weight mapping mechanical.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from eelunet_tpu_torch.nn import init as tinit


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NHWC view (contiguous when ``x`` is channels_last)."""
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels_last strides when ``x`` is contiguous)."""
    return x.permute(0, 3, 1, 2)


class Float32Params:
    """Mixin for modules whose own parameters and buffers stay float32 when
    the module is cast to bf16 or fp16: flax keeps a bf16 model's norm
    parameters (``param_dtype``) in float32, and normalises with them in
    float32."""

    def _apply(self, fn, recurse=True):
        kept = {n: t.data for n, t in (*self.named_parameters(recurse=False),
                                       *self.named_buffers(recurse=False))
                if t.dtype == torch.float32}
        super()._apply(fn, recurse)
        for n, old in kept.items():
            t = getattr(self, n)
            if t.dtype in (torch.bfloat16, torch.float16):
                t.data = old.to(t.device)
        return self


def _per_channel(t: torch.Tensor) -> torch.Tensor:
    return t.view(1, -1, 1, 1)


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch norm over the rows of every rank of ``group``, in
    float32, returning y in x's dtype and the batch's mean, biased variance
    and count.

    Forward: one all-reduce of the per-channel sum, sum of squares and
    count. They are taken about ``shift`` (the running mean, alike on every
    rank), so E[x^2] - E[x]^2 does not cancel once it tracks the batch
    mean. Backward: one all-reduce of the per-channel sums of dy and
    dy * x_hat, and dx = (dy - mean(dy) - x_hat mean(dy x_hat)) w / sigma
    over the global batch: the gradient of the ranks' summed losses, as
    autograd through the whole batch gives it. The affine gradients are
    this rank's sums (DDP averages them with the other parameters'). Only
    x is kept for the backward, as a batch norm keeps it."""

    @staticmethod
    def forward(ctx, x, weight, bias, shift, eps: float, group):
        import torch.distributed as dist

        c = x.shape[1]
        xc = x.float() - _per_channel(shift)
        count = torch.full((1,), x.numel() // c, dtype=torch.float32, device=x.device)
        sums = torch.cat([xc.sum(dim=(0, 2, 3)), (xc * xc).sum(dim=(0, 2, 3)), count])
        dist.all_reduce(sums, group=group)
        n = sums[2 * c]
        mean_c = sums[:c] / n
        var = torch.clamp(sums[c:2 * c] / n - mean_c * mean_c, min=0.0)
        invstd = torch.rsqrt(var + eps)
        y = (xc - _per_channel(mean_c)) * _per_channel(invstd * weight.float()) \
            + _per_channel(bias.float())
        mean = mean_c + shift
        ctx.save_for_backward(x, mean, invstd, weight)
        ctx.group, ctx.n = group, n
        ctx.mark_non_differentiable(mean, var, n)
        return y.to(x.dtype), mean, var, n

    @staticmethod
    def backward(ctx, dy, *_):
        import torch.distributed as dist

        x, mean, invstd, weight = ctx.saved_tensors
        c = x.shape[1]
        x_hat = (x.float() - _per_channel(mean)) * _per_channel(invstd)
        dyf = dy.float()
        local = torch.cat([dyf.sum(dim=(0, 2, 3)), (dyf * x_hat).sum(dim=(0, 2, 3))])
        total = local.clone()
        dist.all_reduce(total, group=ctx.group)
        dx = (dyf - _per_channel(total[:c] / ctx.n) - x_hat * _per_channel(total[c:] / ctx.n)) \
            * _per_channel(invstd * weight.float())
        return (dx.to(x.dtype), local[c:].to(weight.dtype), local[:c].to(weight.dtype),
                None, None, None)


class BatchNorm2d(Float32Params, nn.BatchNorm2d):
    """``nn.BatchNorm2d(eps=1e-5)`` whose eval-mode affine runs in float32.

    flax's BatchNorm in a bf16 model normalises with f32 statistics and casts
    the result to bf16 (``eelunet_tpu/nn/layers.py:208-226``); this does the
    same whatever dtype the parameters were cast to.

    Train mode is ``nn.BatchNorm2d``'s own, which is what the JAX package's
    ``_TorchExactBatchNorm`` (``nn/layers.py:98-206``) emulates: batch
    statistics with the biased variance, running statistics with momentum
    0.1 (flax's 0.9) and the Bessel-corrected variance. Under bf16 autocast
    it takes a bf16 input with f32 affine and statistics and returns bf16.
    Cast to bf16, it keeps its parameters and statistics in float32.

    Under data parallelism (``sync_group``, set by ``sync_batch_norms``) the
    train-mode statistics are those of the global batch, as in the JAX
    package, where the data-parallel batch is one array and XLA reduces its
    statistics over the mesh; plain DDP would normalise each rank by its
    own rows. ``nn.SyncBatchNorm`` refuses CPU tensors, so this path is
    written out: ``_global_batch_norm``."""

    def __init__(self, num_features: int, device=None, dtype=None):
        super().__init__(num_features, eps=1e-5, device=device, dtype=dtype)
        self.sync_group = None

    def __getstate__(self):
        # A process group does not copy or pickle: a copy normalises alone.
        return {**super().__getstate__(), "sync_group": None}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.sync_group is not None:
            return self._global_batch_norm(x)
        if self.training:
            return super().forward(x)
        y = F.batch_norm(
            x.float(), self.running_mean.float(), self.running_var.float(),
            self.weight.float(), self.bias.float(), False, 0.0, self.eps,
        )
        return y.to(x.dtype)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the batch of every rank of ``sync_group``
        (``_GlobalBatchNorm``): ``nn.BatchNorm2d`` on the concatenated
        batch, biased variance to normalise, the unbiased one over the
        global count in the running variance, momentum 0.1."""
        y, mean, var, n = _GlobalBatchNorm.apply(
            x, self.weight, self.bias, self.running_mean.detach().float().clone(), self.eps,
            self.sync_group)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean.to(self.running_mean.dtype))
            self.running_var.mul_(1 - m).add_(m * (var * n / (n - 1)).to(self.running_var.dtype))
            self.num_batches_tracked.add_(1)
        return y


def sync_batch_norms(model: nn.Module, group) -> nn.Module:
    """Give every ``BatchNorm2d`` of ``model`` the global-batch statistics of
    the ranks of ``group`` in train mode (None: each rank's own batch, the
    single-process behaviour). Eval mode is unchanged. Returns ``model``."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.sync_group = group
    return model


class GroupNorm4(Float32Params, nn.GroupNorm):
    """``nn.GroupNorm(4, c, eps=1e-5)`` computed in float32 whatever the
    dtype of its input and parameters, cast back to the input's dtype
    (``eelunet_tpu/nn/layers.py:229-236``: flax normalises in f32 with f32
    parameters)."""

    def __init__(self, num_channels: int, device=None, dtype=None):
        super().__init__(4, num_channels, eps=1e-5, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class ChannelLayerNorm(Float32Params, nn.Module):
    """LayerNorm over the channel axis, statistics in float32; eps 1e-6
    (``eelunet_tpu/nn/layers.py:239-253``), 1e-5 for UNeXt's token norms."""

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


def conv_transpose2x2(cin: int, cout: int, device=None, dtype=None) -> nn.ConvTranspose2d:
    """``TorchConvTranspose`` (``nn/layers.py:68-92``): exact 2x upsampling,
    weight (cin, cout, 2, 2). The JAX kernel's flipped HWIO layout is the
    converter's business (``models/convert.py``)."""
    return nn.ConvTranspose2d(cin, cout, 2, stride=2, device=device, dtype=dtype)


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


class ConvReLUBlock(nn.Sequential):
    """conv3x3 ReLU conv3x3 ReLU: ``ConvBlock(use_bn=False)``
    (``nn/layers.py:309-338``) under the upstream U-Net's names, a
    Sequential whose convs sit at 0 and 2 (Unet.py:33-40)."""

    def __init__(self, cin: int, features: int, features_mid: Optional[int] = None,
                 device=None, dtype=None):
        mid = features_mid or features
        super().__init__(conv3x3(cin, mid, device, dtype), nn.ReLU(),
                         conv3x3(mid, features, device, dtype), nn.ReLU())


class DropPath(nn.Module):
    """Stochastic depth (``nn/layers.py:356-369``, timm's DropPath): the
    identity at rate 0 or in eval mode; otherwise each sample is kept with
    probability 1 - rate, drawn from ``generator``, and scaled by
    1 / (1 - rate)."""

    def __init__(self, rate: float = 0.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        dev = x.device if self.generator is None else self.generator.device
        mask = torch.rand(shape, generator=self.generator, device=dev).to(x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise ``module``'s weights from ``generator``.

    Conv (1-d and 2-d), transposed conv and Linear layers get PyTorch's
    default distributions (``reset_parameters``: kaiming-uniform weights
    with a=sqrt(5), bias uniform in +-1/sqrt(fan_in)), which are the JAX
    package's ``torch_conv_init`` and ``torch_bias_init``; norms keep their
    identity init. Then every module with an ``init_(generator)`` method,
    innermost first, draws its own: the families' schemes of
    ``nn/init.py`` (kaiming-normal over fan_out, truncated normal, ...).
    Returns ``module``."""
    for m in module.modules():
        if not hasattr(m, "init_") and isinstance(
                m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            tinit.torch_conv_init_(m.weight, generator)
            if m.bias is not None:
                tinit.torch_bias_init_(m.bias, m.weight[0].numel(), generator)
    for m in reversed(list(module.modules())):
        if hasattr(m, "init_"):
            m.init_(generator)
    return module
