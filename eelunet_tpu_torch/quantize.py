"""Post-training W8A8 int8 quantization of the inference forward
(counterpart of ``eelunet_tpu/quantize.py``).

The JAX package rewrites the traced forward's equations; PyTorch has no
analogue of that jaxpr pass, so this is a module-level pass:
``quantize_model`` replaces every eligible op module with one that runs

    x_q = round(x / s_x)         per-tensor activation scale, max|x|/127
    k_q = round(k / s_k)         per-output-channel weight scales
    y   = x_q . k_q              int8 x int8 -> int32
    out = (y * s_x * s_k)        dequantized in float32, cast to x's type

with the scales computed in float32 and floored at ``finfo(f32).tiny``,
``round`` half to even, then clipped to +-127. The bias, and everything
after the op, runs in the original dtype, as the JAX package's separate
equations do.

The eligible set is the JAX package's: a conv (``nn.Conv1d``,
``nn.Conv2d``, ``nn.ConvTranspose2d``; flax lowers transposed convs to the
same conv equation) with one group, and a dense-shaped matmul
(``nn.Linear``, and MALUNet's two external-attention ``Conv1d``, which are
plain matmuls there: ``EAblock.MATMULS``) that contracts over at least 8.
Depthwise and grouped convs, the low-rank high-pass matmuls (plain tensor
ops, not modules) and the high-pass CUDA kernels run as they are, as the JAX
package replays its precision-pinned dots and its ``pallas_call``.

The int product: ``int8_mm``, on the card ``torch._int_mm`` (cuBLASLt int8
tensor cores), on the CPU its plain twin, the same product in float64 on
integer-valued tensors, exact below 2**53. A Linear and a 2x2-stride-2
transposed conv are one GEMM each; a k x k conv is an im2col (gathered in
int8 on the NHWC activation, chunked over the batch so the 512^2 b16 sites
stay inside memory) and a GEMM. ``_int_mm`` needs more than 16 rows and
multiples of 8 for K and N: the operands are padded with zeros, which is
exact. JAX computes this product in XLA, outside Pallas: it is no TPU
kernel, and a library GEMM stands for it here.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

QINT_MAX = 127.0
_TINY = torch.finfo(torch.float32).tiny
# im2col bytes per chunk of the batch on the card
_CHUNK_BYTES = 1 << 30
# Calls of torch._int_mm since the last reset (the CPU's twin calls are not
# counted): a run reads it to show that its int8 path reached the card's GEMM.
LAUNCHES: Dict[str, int] = {"int8_mm": 0}


def reset_launches() -> None:
    LAUNCHES["int8_mm"] = 0


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    """max|.| / 127 floored at ``finfo(f32).tiny``, divided, not multiplied
    by a reciprocal: PyTorch's CUDA division by a Python number multiplies
    by 1/127, which is one ulp off the quotient the CPU and XLA compute."""
    return torch.clamp(absmax / torch.full_like(absmax, QINT_MAX), min=_TINY)


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 x_q, float32 scalar s_x): one dynamic scale for the tensor."""
    x32 = x.float()
    xs = _scale(x32.abs().amax())
    return torch.clamp(torch.round(x32 / xs), -QINT_MAX, QINT_MAX).to(torch.int8), xs


def quantize_weight(w: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 w_q, float32 scales of shape (w.shape[axis],)): one scale per
    output channel (``axis``)."""
    w32 = w.detach().float()
    dims = tuple(d for d in range(w.dim()) if d != axis)
    ws = _scale(w32.abs().amax(dim=dims, keepdim=True))
    wq = torch.clamp(torch.round(w32 / ws), -QINT_MAX, QINT_MAX).to(torch.int8)
    return wq, ws.reshape(-1)


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import is_fake

    return is_fake(t)


def int8_mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M,K) int8 . b (N,K) int8 -> (M,N) int32, in float64 (exact)."""
    return (a.double() @ b.double().t()).to(torch.int32)


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M,K) int8 . b (N,K) int8^T -> (M,N) int32. K and N must be
    multiples of 8 (the callers pad them). On a CUDA tensor
    ``torch._int_mm``, with rows padded past 16; on a CPU tensor the
    float64 twin."""
    if a.device.type == "cpu":
        return int8_mm_plain(a, b)
    m = a.shape[0]
    if m <= 16:
        a = F.pad(a, (0, 0, 0, 17 - m))
    y = torch._int_mm(a, b.t())
    if not _is_fake(a):
        LAUNCHES["int8_mm"] += 1
    return y[:m] if m <= 16 else y


def _pad_cols(t: torch.Tensor, k8: int) -> torch.Tensor:
    return t if t.shape[-1] == k8 else F.pad(t, (0, k8 - t.shape[-1]))


def conv_out_hw(h: int, w: int, kernel, stride, padding, dilation) -> Tuple[int, int]:
    return tuple((n + 2 * p - d * (k - 1) - 1) // st + 1
                 for n, k, st, p, d in zip((h, w), kernel, stride, padding, dilation))


def im2col_nhwc(xq: torch.Tensor, kernel: Tuple[int, int], stride: Tuple[int, int],
                padding: Tuple[int, int], dilation: Tuple[int, int], k8: int) -> torch.Tensor:
    """(B,H,W,C) -> (B,Ho,Wo,K8) patches, K ordered (kh, kw, C) and zero
    padded to ``k8`` columns: the conv's zero padding, then one strided
    slice per tap."""
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel, stride, padding, dilation
    b, h, w, c = xq.shape
    ho, wo = conv_out_hw(h, w, kernel, stride, padding, dilation)
    if kh == kw == 1 and sh == sw == 1 and ph == pw == 0:
        return _pad_cols(xq, k8)
    x = F.pad(xq, (0, 0, pw, pw, ph, ph)) if ph or pw else xq
    cols = [x[:, i * dh: i * dh + sh * (ho - 1) + 1: sh, j * dw: j * dw + sw * (wo - 1) + 1: sw]
            for i in range(kh) for j in range(kw)]
    if k8 > kh * kw * c:
        cols.append(xq.new_zeros((b, ho, wo, k8 - kh * kw * c)))
    return torch.cat(cols, dim=-1)


def int8_conv2d(xh: torch.Tensor, wq: torch.Tensor, n_out: int, kernel, stride, padding,
                dilation) -> torch.Tensor:
    """The int conv: (B,H,W,C) int8 x_q and the (N8, K8) int8 weight matrix
    (rows the output channels, K in (kh, kw, C) order, zero padded) ->
    (B,Ho,Wo,n_out) int32, im2col and ``int8_mm``. On the card the batch
    goes in chunks of at most 1 GiB of patches."""
    b, h, w, _ = xh.shape
    k8 = wq.shape[1]
    ho, wo = conv_out_hw(h, w, kernel, stride, padding, dilation)
    step = max(1, _CHUNK_BYTES // max(ho * wo * k8, 1)) if xh.device.type == "cuda" else b
    out = torch.empty((b, ho, wo, n_out), dtype=torch.int32, device=xh.device)
    for start in range(0, b, step):
        cols = im2col_nhwc(xh[start:start + step], kernel, stride, padding, dilation, k8)
        out[start:start + step] = int8_mm(cols.reshape(-1, k8), wq)[:, :n_out].view(
            -1, ho, wo, n_out)
    return out


def int8_conv2d_plain(xq: torch.Tensor, wq: torch.Tensor, stride, padding,
                      dilation) -> torch.Tensor:
    """The int conv in float64 on integer-valued tensors (exact): NCHW int8
    x_q, (O,I,kh,kw) int8 w_q -> NCHW int32. The twin the card's im2col and
    ``_int_mm`` route is held against."""
    return F.conv2d(xq.double(), wq.double(), None, stride, padding, dilation).to(torch.int32)


class _Quantized(nn.Module):
    """Shared state of a quantized op: the padded (N8, K8) int8 weight, the
    float32 per-output scales, the bias in the original type, and the stats
    dict it counts itself into (``counts_as``)."""

    def __init__(self, wmat: torch.Tensor, ws: torch.Tensor, bias: Optional[torch.Tensor],
                 n_out: int, counts_as: str, stats: Optional[dict]):
        super().__init__()
        n, k = wmat.shape
        self.n_out, self.k = n_out, k
        self.register_buffer("wq", F.pad(wmat, (0, _ceil8(k) - k, 0, _ceil8(n) - n)))
        self.register_buffer("ws", ws)
        self.register_buffer("bias", None if bias is None else bias.detach().clone())
        self.counts_as = counts_as
        self._stats = stats

    def _count(self):
        if self._stats is not None:
            self._stats[self.counts_as] = self._stats.get(self.counts_as, 0) + 1

    def _gemm(self, a: torch.Tensor) -> torch.Tensor:
        """(M, K8) int8 -> (M, n_out) int32."""
        return int8_mm(a, self.wq)[:, :self.n_out]

    def _dequant(self, y: torch.Tensor, xs: torch.Tensor, dtype) -> torch.Tensor:
        out = (y.float() * xs * self.ws).to(dtype)
        return out if self.bias is None else out + self.bias.to(dtype)


class QuantLinear(_Quantized):
    """W8A8 ``nn.Linear`` over the last axis (a dot)."""

    def __init__(self, m: nn.Linear, stats: Optional[dict] = None):
        wq, ws = quantize_weight(m.weight, 0)
        super().__init__(wq, ws, m.bias, m.out_features, "quantized_dots", stats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._count()
        xq, xs = quantize_activation(x)
        a = _pad_cols(xq.reshape(-1, x.shape[-1]), self.wq.shape[1])
        y = self._gemm(a)
        return self._dequant(y, xs, x.dtype).reshape(*x.shape[:-1], self.n_out)


class QuantConv2d(_Quantized):
    """W8A8 ``nn.Conv2d`` or ``nn.Conv1d`` (one group) through im2col on
    the NHWC activation; a 1-d conv runs as a (k, 1) 2-d conv.
    ``counts_as="quantized_dots"`` for the matmul ``Conv1d`` of
    ``EAblock.MATMULS``."""

    def __init__(self, m, stats: Optional[dict] = None, counts_as: str = "quantized_convs"):
        self.one_d = isinstance(m, nn.Conv1d)
        w = m.weight.unsqueeze(-1) if self.one_d else m.weight
        if isinstance(m.padding, str):
            raise NotImplementedError(f"int8 conv with padding={m.padding!r}")
        # a 1-d conv's second spatial axis: size 1, stride 1, no padding
        pair = (lambda v, e: (v[0], e)) if self.one_d else (lambda v, e: tuple(v))
        geometry = (pair(m.kernel_size, 1), pair(m.stride, 1), pair(m.padding, 0),
                    pair(m.dilation, 1))
        wq, ws = quantize_weight(w, 0)
        wmat = wq.permute(0, 2, 3, 1).reshape(wq.shape[0], -1)  # K in (kh, kw, C) order
        super().__init__(wmat, ws, m.bias, m.out_channels, counts_as, stats)
        self.kernel, self.stride, self.padding, self.dilation = geometry
        self.padding_mode = m.padding_mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._count()
        if self.one_d:
            x = x.unsqueeze(-1)
        padding = self.padding
        if self.padding_mode != "zeros":  # pad in float first: quantizing commutes with it
            ph, pw = padding
            x = F.pad(x, (pw, pw, ph, ph), mode=self.padding_mode)
            padding = (0, 0)
        xq, xs = quantize_activation(x)
        xh = xq.permute(0, 2, 3, 1).contiguous()  # free for a channels_last x
        y = int8_conv2d(xh, self.wq, self.n_out, self.kernel, self.stride, padding,
                        self.dilation)
        out = self._dequant(y, xs, x.dtype).permute(0, 3, 1, 2)  # NCHW, channels_last
        return out.squeeze(-1) if self.one_d else out


class QuantConvTranspose2d(_Quantized):
    """W8A8 ``nn.ConvTranspose2d`` with kernel == stride and no padding
    (every transposed conv of the seven families: 2x2, stride 2): one GEMM
    to (kh, kw, O) per input pixel, then the pixels interleaved."""

    def __init__(self, m: nn.ConvTranspose2d, stats: Optional[dict] = None):
        if (tuple(m.kernel_size) != tuple(m.stride) or any(m.padding) or any(m.output_padding)
                or any(d != 1 for d in m.dilation) or m.groups != 1):
            raise NotImplementedError(
                "int8 transposed conv needs kernel == stride, no padding, dilation 1, "
                f"one group: got {m}")
        wq, ws = quantize_weight(m.weight, 1)                 # (I, O, kh, kw), O on axis 1
        self.kernel = tuple(m.kernel_size)
        wmat = wq.permute(2, 3, 1, 0).reshape(-1, wq.shape[0])  # rows (kh, kw, O)
        super().__init__(wmat, ws.repeat(self.kernel[0] * self.kernel[1]), m.bias,
                         wmat.shape[0], "quantized_convs", stats)
        self.o = m.out_channels

    def _dequant(self, y, xs, dtype):  # the bias goes on after the interleave
        return (y.float() * xs * self.ws).to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._count()
        xq, xs = quantize_activation(x)
        xh = xq.permute(0, 2, 3, 1).contiguous()
        b, h, w, c = xh.shape
        kh, kw = self.kernel
        y = self._dequant(self._gemm(_pad_cols(xh.reshape(-1, c), self.wq.shape[1])), xs,
                          x.dtype)
        y = y.view(b, h, w, kh, kw, self.o).permute(0, 1, 3, 2, 4, 5).reshape(
            b, h * kh, w * kw, self.o)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y.permute(0, 3, 1, 2)


def _eligible(name: str, m: nn.Module, matmuls: set) -> Optional[str]:
    """The kind an op module counts as when it is quantized, else None."""
    if name in matmuls:
        return "quantized_dots" if m.in_channels >= 8 else None
    if isinstance(m, nn.Linear):
        return "quantized_dots" if m.in_features >= 8 else None
    if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d)):
        return "quantized_convs" if m.groups == 1 else None
    return None


def quantize_model(model: nn.Module, stats: Optional[dict] = None) -> nn.Module:
    """``model`` with every eligible op run W8A8 (module docstring). The
    weights are quantized once, here. ``stats`` (optional dict) holds
    ``quantized_convs`` and ``quantized_dots``, the quantized ops of the
    model's latest forward (a shared module counts once per call, as the
    JAX rewrite counts each traced equation). ``model`` itself is left as it
    is: the quantized model is a copy, as JAX's ``quantize_fn`` is pure."""
    from eelunet_tpu_torch.prune import matmul_convs

    model = copy.deepcopy(model)
    matmuls = matmul_convs(model)
    targets = []
    for name, m in model.named_modules():
        kind = _eligible(name, m, matmuls)
        if kind is not None and name:
            targets.append((name, m, kind))
    for name, m, kind in targets:
        if isinstance(m, nn.Linear):
            q = QuantLinear(m, stats)
        elif isinstance(m, nn.ConvTranspose2d):
            q = QuantConvTranspose2d(m, stats)
        else:
            q = QuantConv2d(m, stats, kind)
        parent, _, child = name.rpartition(".")
        setattr(model.get_submodule(parent) if parent else model, child, q)
    if stats is not None:
        model.register_forward_pre_hook(lambda _m, _a: stats.clear())
    return model
