"""Analytic FLOP counting and MFU accounting (counterpart of
``eelunet_tpu/utils/flops.py``).

``count_matmul_flops`` counts the conv and matmul FLOPs (2 x MACs) of one
call of any function with ``torch.utils.flop_counter.FlopCounterMode``:
the numerator of MFU (model-FLOPs utilization). Elementwise work and norms
are left out on purpose, as in the JAX package, whose counter walks the
jaxpr. The JAX package's counting rules are kept, so the two packages
give the same number for the same model:

- a conv counts 2 x (output elements) x (kernel taps) x (input channels
  per group). A transposed conv is XLA's conv with a dilated input, so its
  output elements are counted, not its input's (4x the multiplies that do
  work for the stride-2, 2x2 upsampling convs);
- a conv's backward counts its input gradient as that XLA conv does (2 x
  input elements x taps x output channels per group) and its weight
  gradient as 2 x weight elements x (gradient's spatial size) x batch;
- the EELUnet's FFT high-pass counts the contractions of its low-rank
  formulation (``ops/fft.py``: fourteen real einsums, and as many in its
  backward), whatever route computes it. The CUDA kernels are bound with
  ctypes and invisible to ``FlopCounterMode``, and the plain twins that
  stand in for them on the CPU contract with other operands, so while
  counting, each call of ``ops/fft_cuda.highpass_fwd`` and ``highpass_bwd``
  has what the counter saw inside it replaced by the low-rank count. On
  the ``lowrank`` route the counter sees those einsums themselves. So the
  MFU numerator does not depend on the implementation.

Counting runs the function. Given tensors on the ``meta`` device it costs
no device time and little CPU: ``model_forward_flops`` builds the model
there, and the kernel wrappers take their plain twins on meta tensors.

``peak_flops_for`` holds the dense bf16 peak of NVIDIA cards, keyed on
``torch.cuda.get_device_name()``; no TPU rate is in the table.
"""

from __future__ import annotations

import contextlib
from math import prod
from typing import Dict, Optional

import torch

# Dense (no sparsity) bf16 tensor-core peak FLOP/s, from NVIDIA's H100 data
# sheet (its figures are with sparsity: half of them). Keyed on
# torch.cuda.get_device_name().
PEAK_BF16_FLOPS: Dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 989e12,  # H100 SXM5
    "NVIDIA H100 PCIe": 756e12,
}


def peak_flops_for(device_kind: str) -> Optional[float]:
    """The card's dense bf16 peak, or None for a card not in the table. The
    longest matching prefix wins, so a variant listed under a longer name
    never takes a shorter entry's rate."""
    for k in sorted(PEAK_BF16_FLOPS, key=len, reverse=True):
        if device_kind.lower().startswith(k.lower()):
            return PEAK_BF16_FLOPS[k]
    return None


def mfu_pct(images_per_sec: float, flops_per_image: float, device_kind: str) -> Optional[float]:
    """Model-FLOPs utilization in percent, or None for a card not in the table."""
    peak = peak_flops_for(device_kind)
    if not peak:
        return None
    return 100.0 * images_per_sec * flops_per_image / peak


def _conv_flops(x_shape, w_shape, _bias, _stride, _padding, _dilation, transposed, _out_pad,
                groups, *args, out_shape=None, **kwargs) -> int:
    cin_per_group = w_shape[0] // groups if transposed else w_shape[1]
    return 2 * prod(out_shape) * prod(w_shape[2:]) * cin_per_group


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation,
                         transposed, _out_pad, groups, output_mask, out_shape=None,
                         **kwargs) -> int:
    taps = prod(w_shape[2:])
    cout = w_shape[1] * groups if transposed else w_shape[0]
    flops = 0
    if output_mask[0]:
        flops += 2 * prod(x_shape) * taps * (cout // groups)
    if output_mask[1]:
        flops += 2 * prod(w_shape) * prod(grad_out_shape[2:]) * grad_out_shape[0]
    return flops


def _conv_mapping():
    aten = torch.ops.aten
    return {aten.convolution: _conv_flops, aten._convolution: _conv_flops,
            aten.convolution_backward: _conv_backward_flops}


def highpass_flops(shape, mask_range: int) -> int:
    """FLOPs of the low-rank high-pass's contractions on an NHWC tensor of
    ``shape`` (one pass: the forward, or the backward's transposes)."""
    b, h, w, c = shape
    k = 2 * min(mask_range, h // 2, w // 2)
    # kh,bhwc (x real: 2 einsums) + lw,bkwc (4) + wl,bklc (4) + hk,bkwc (4)
    return 2 * b * c * (2 * k * h * w + 4 * k * w * k + 4 * w * k * k + 4 * h * k * w)


@contextlib.contextmanager
def _highpass_as_lowrank(counter, extra: list):
    """While counting, replace what ``counter`` sees inside the kernel
    route's high-pass with the low-rank formulation's count (``extra``)."""
    from eelunet_tpu_torch.ops import fft_cuda

    fwd, bwd = fft_cuda.highpass_fwd, fft_cuda.highpass_bwd

    def counted(fn, shape_of):
        def call(*a):
            before = counter.get_total_flops()
            out = fn(*a)
            extra[0] += highpass_flops(*shape_of(*a)) - (counter.get_total_flops() - before)
            return out
        return call

    fft_cuda.highpass_fwd = counted(fwd, lambda x, m: (x.shape, m))
    fft_cuda.highpass_bwd = counted(bwd, lambda x, sr, si, g, m: (x.shape, m))
    try:
        yield
    finally:
        fft_cuda.highpass_fwd, fft_cuda.highpass_bwd = fwd, bwd



def count_matmul_flops(fn, *args, **kwargs) -> float:
    """Total conv + matmul FLOPs (2 x MACs) of one call of
    ``fn(*args, **kwargs)``, by the JAX package's rules (module docstring).
    Gradients that ``fn`` computes are counted too."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False, custom_mapping=_conv_mapping())
    extra = [0]
    with counter, _highpass_as_lowrank(counter, extra):
        fn(*args, **kwargs)
    return float(counter.get_total_flops() + extra[0])


def model_forward_flops(model_name: str, image: int, batch: int = 1,
                        dtype: str = "bfloat16") -> float:
    """Forward-pass FLOPs of one registry model at ``image`` x ``image``,
    counted on the meta device, in eval mode."""
    from eelunet_tpu_torch.config import ModelConfig
    from eelunet_tpu_torch.registry import create_model, model_dtype

    cfg = ModelConfig(name=model_name, dtype=dtype)
    dt = model_dtype(cfg)
    model, _ = create_model(cfg, device="meta", dtype=dt)
    x = torch.zeros((batch, cfg.in_channels, image, image), device="meta", dtype=dt)
    # no parameter needs a gradient: FlopCounterMode's module tracker hooks
    # the gradients of a module's inputs, and a parameter passed on as an
    # input under no_grad has none
    model.eval().requires_grad_(False)
    return count_matmul_flops(model, x)
