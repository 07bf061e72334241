"""Parameter initialisers (counterpart of ``eelunet_tpu/nn/init.py``): the
PyTorch defaults and the schemes of the reference's ``_init_weights``
(egeunet.py:308-321, malunet.py:266-279, unext.py:44-57), on tensors in
torch layout, each drawn from an explicit ``torch.Generator``.

Torch layouts: Conv2d (O, I/groups, kh, kw), Conv1d (O, I/groups, k),
Linear (O, I). The JAX package's fan computations on flax layouts
((kh, kw, I/groups, O) and (I, O)) give the same numbers here.
"""

from __future__ import annotations

import math

import torch


@torch.no_grad()
def torch_conv_init_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """PyTorch's Conv/Linear default: U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    fan_in = the elements of one output's filter."""
    bound = 1.0 / math.sqrt(w[0].numel())
    return w.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def torch_bias_init_(b: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """PyTorch's bias default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return b.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def kaiming_normal_fan_out_(w: torch.Tensor, groups: int, generator: torch.Generator
                            ) -> torch.Tensor:
    """N(0, sqrt(2 / fan_out)), fan_out = receptive field x out_channels /
    groups, as the reference's ``_init_weights`` draws its Conv2d weights."""
    fan_out = w[0, 0].numel() * w.shape[0] // groups
    return w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


@torch.no_grad()
def trunc_normal_(w: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """N(0, std) truncated to +-2 std (the JAX package's ``trunc_normal``)."""
    return torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)


@torch.no_grad()
def conv1d_normal_init_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """The reference's Conv1d init: N(0, sqrt(2 / (k x out_channels)))
    (egeunet.py:313-315), with no division by the groups."""
    n = w.shape[-1] * w.shape[0]
    return w.normal_(0.0, math.sqrt(2.0 / n), generator=generator)
