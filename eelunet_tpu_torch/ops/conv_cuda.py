"""SAME 3x3 convolution through the hand-written CUDA kernel
(counterpart of ``eelunet_tpu/ops/conv_pallas.py``; TPU kernel 6).

``csrc/conv3x3.cu`` convolves NHWC x (B,H,W,Cin) with HWIO weights
(3,3,Cin,Cout), accumulates in float32, applies a per-channel
``acc * scale + shift`` and an optional ReLU, and writes x's type. It is an
implicit GEMM on the tensor cores (``mma.sync``, f32 sums): bf16 operands
as they are, float32 ones split into three bf16 pieces each as the kernel
stages them, every product taken as bf16x6 (``csrc/tc_bf16.cuh``). Like the
JAX kernel, no model calls it: it is the convolution pattern held against
the library convolution (``chip_smoke.py`` times both on the card, in
turns).

``conv3x3`` launches the kernel on a CUDA tensor and counts the launch in
``LAUNCHES``; on a CPU tensor it runs the plain twin ``conv3x3_reference``
(``conv_pallas.py:135-148``). A CUDA tensor never takes the twin.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
import torch.nn.functional as F

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset (twin calls are not launches).
LAUNCHES: Dict[str, int] = {"conv3x3": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor] = None,
                      shift: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """The kernel's contract with a library convolution in float32: NHWC x,
    HWIO w, optional (Cout,) scale and shift, optional ReLU, x's dtype out."""
    cout = w.shape[3]
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1)
    if scale is not None:
        y = y * scale.float().view(1, 1, 1, cout)
    if shift is not None:
        y = y + shift.float().view(1, 1, 1, cout)
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
SOURCES = ("conv3x3",)  # the csrc/<name>.cu files this wrapper launches


def _lib():
    from eelunet_tpu_torch.ops._build import load

    lib = load("conv3x3")
    if not getattr(lib, "_eelunet_typed", False):
        lib.eelunet_conv3x3.argtypes = _SIGNATURE
        lib.eelunet_conv3x3.restype = _I
        lib._eelunet_typed = True
    return lib


def _affine(name: str, t: Optional[torch.Tensor], fill: float, cout: int,
            device: torch.device) -> torch.Tensor:
    if t is None:
        return torch.full((cout,), fill, dtype=torch.float32, device=device)
    if tuple(t.shape) != (cout,) or t.device != device:
        raise ValueError(f"conv3x3: {name} must be ({cout},) on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.to(torch.float32).contiguous()


def conv3x3(x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor] = None,
            shift: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """Kernel 6: SAME 3x3 stride-1 conv of contiguous NHWC ``x`` (float32 or
    bfloat16) with contiguous HWIO ``w`` of x's dtype, float32 accumulation,
    fused ``* scale + shift`` and ReLU; returns (B,H,W,Cout) in x's dtype. A
    CPU tensor runs ``conv3x3_reference``."""
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(f"conv3x3: x (B,H,W,Cin) and w (3,3,Cin,Cout) expected, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.device.type == "cpu":
        return conv3x3_reference(x, w, scale, shift, relu)
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype or w.device != x.device:
        raise ValueError(f"conv3x3: x must be float32 or bfloat16 and w of its dtype and "
                         f"device, got {x.dtype} and {w.dtype} on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3: x and w must be contiguous (NHWC and HWIO)")
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    sc = _affine("scale", scale, 1.0, cout, x.device)
    sh = _affine("shift", shift, 0.0, cout, x.device)
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):  # launch on the operand's card
        err = _lib().eelunet_conv3x3(
            _DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(), sc.data_ptr(), sh.data_ptr(),
            out.data_ptr(), b, h, wd, cin, cout, int(relu),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3: CUDA launch failed with cudaError_t {err}")
    LAUNCHES["conv3x3"] += 1
    return out
