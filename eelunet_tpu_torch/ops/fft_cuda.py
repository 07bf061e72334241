"""FFT high-pass through the hand-written CUDA kernels
(counterpart of ``eelunet_tpu/ops/fft_pallas.py``). In a bf16 model all four
run on the tensor cores (``mma.sync``, f32 sums); in float32 they keep exact
f32 arithmetic on CUDA cores. Times: NVIDIA H100 80GB HBM3 at 700 W,
``chip_smoke.py`` phases 3 and 3b.

Forward (``csrc/highpass.cu``):

  kernel 1, ``highpass_contract`` (TPU ``_contract_kernel``): T = V_H x per
      image, as (B, K, W*C) f32 real and imaginary parts — one read of x, a
      skinny write. bf16: ``contract_kernel_tc``, bf16 operands, x and the
      stacked [V_r^T | V_i^T] through a cp.async ring; bound by bytes,
      0.35 ms at (16,512,512,64).
  middle: contract and expand the W axis on the skinny T — four einsums in
      float32 per complex product (``fft_pallas.py:273-285``), K rows only.
  kernel 2, ``highpass_expand`` (TPU ``_expand_kernel``): out = |x - U_H S|,
      the low-pass rows rebuilt per column and fused with the residual and
      the clamped magnitude — one read of x and S, one write. bf16:
      ``expand_kernel_tc`` in bf16x3 (U_H and S split into two bf16 pieces,
      three products; one pass of TF32 misses the bound where the mask keeps
      the whole spectrum); 1.12 ms at (16,512,512,64) against a 0.38 ms
      bound from bytes.

Backward (``csrc/highpass_bwd.cu``), the analytic adjoint on the saved S
(``fft_pallas.py:324-386, 453-527``):

  kernel 3, ``highpass_bwd_contract`` (TPU ``_bwd_contract_kernel``):
      z = x - U_H S rebuilt per column, u = g z/|z| (0 under the clamp),
      Re u written in x's type and T = U_H^T conj(u) accumulated in f32. g
      has x's type, as autograd gives it. bf16: ``bwd_contract_kernel_tc``,
      z rebuilt in bf16x6 (three pieces, six products: a bf16x3 rebuild
      turns u enough to move T past its 1e-4 bound) and T in bf16x3, each
      k-step's products added into the totals rounded to nearest; 1.89 ms
      at (8,512,512,64) against a 0.30 ms bound from bytes and a 0.47 ms
      floor of its products.
  middle: the forward middle in reverse (``fft_pallas.py:496-509``):
      ``w_axis_middle`` with U_W^T and V_W^T in the places of V_W and U_W.
  kernel 4, ``highpass_bwd_expand`` (TPU ``_bwd_expand_kernel``):
      dx = Re u - Re(V_H^T R) in x's type. bf16: ``bwd_expand_kernel_tc``,
      dx = u - A R with A = [V_r^T | -V_i^T] and R rounded to TF32; bound by
      bytes, 0.34 ms at (8,512,512,64).

Kernels 1 and 4 read their stacked operands through the two (H, K) halves
the wrappers are given (16-byte aligned; fresh ``factor_tensors`` are).
Kernels 2 and 3 read U_H split and stacked, ``uh_stacked``: made with the
factors and cached per pair of U_H tensors; S's and u's pieces are made in
the kernels' registers.

``HighPassFunction`` ties the four together for autograd, saving (x, S_r,
S_i) as the JAX VJP does (``fft_pallas.py:664-671``).

Each wrapper launches its kernel on a CUDA tensor and counts the launch in
``LAUNCHES``; on a CPU tensor it runs its plain twin (``*_plain``) instead,
and on a meta tensor too (shapes only: FLOP counting and the model summary,
``utils/``). A CUDA tensor never takes the plain twin.
"""

from __future__ import annotations

import contextlib
import ctypes
from collections import OrderedDict
from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch

from eelunet_tpu_torch.ops.fft import _EPS, _axis_factors

SUPPORTED_K = (16, 32, 48, 64)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_PLAIN = ("cpu", "meta")  # the devices whose tensors take the plain twins
# Kernel launches per wrapper since the last reset (plain-twin calls are not
# launches). A run reads them to show that its path went through the kernels.
LAUNCHES: Dict[str, int] = {"highpass_contract": 0, "highpass_expand": 0,
                            "highpass_bwd_contract": 0, "highpass_bwd_expand": 0}


def autocast_off(device_type: str):
    """An autocast region switched off; nothing on the meta device, which
    has no autocast state."""
    if device_type == "meta":
        return contextlib.nullcontext()
    return torch.autocast(device_type, enabled=False)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def padded_k(h: int, w: int, mask_range: int) -> Tuple[int, int]:
    """(m, K): the jointly clamped mask half-width and the row count of the
    skinny spectrum, 2m rounded up to a multiple of 16 (at least 16)."""
    m = min(mask_range, h // 2, w // 2)
    return m, max(_round_up(2 * m, 16), 16)


@lru_cache(maxsize=32)
def _padded_factors(n: int, m: int, k: int):
    """Axis factors zero-padded from 2m to k columns of U / rows of V.
    The padded frequencies are zeros, so U @ V is the unpadded operator."""
    ur, ui, vr, vi = _axis_factors(n, m)
    pad = k - ur.shape[1]
    return (
        np.pad(ur, ((0, 0), (0, pad))),
        np.pad(ui, ((0, 0), (0, pad))),
        np.pad(vr, ((0, pad), (0, 0))),
        np.pad(vi, ((0, pad), (0, 0))),
    )


@lru_cache(maxsize=32)
def factor_tensors(h: int, w: int, mask_range: int, dtype: torch.dtype,
                   device: torch.device):
    """The factor operands on ``device``: V_H^T (H,K) real/imag in ``dtype``
    (the contract's input type, as ``fft_pallas.py:194``); U_H (H,K), U_W
    (W,K) and V_W (K,W) real/imag in float32."""
    m, k = padded_k(h, w, mask_range)
    uhr, uhi, vhr, vhi = _padded_factors(h, m, k)
    uwr, uwi, vwr, vwi = _padded_factors(w, m, k)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    out = (t(vhr.T, dtype), t(vhi.T, dtype), t(uhr), t(uhi),
           t(uwr), t(uwi), t(vwr), t(vwi))
    uh_stacked(out[2], out[3])  # kernels 2 and 3 read U_H split and stacked
    return out


def bf16_split(a: torch.Tensor, pieces: int = 2):
    """f32 -> ``pieces`` bf16 tensors, each rounded to nearest even from what
    the earlier ones left: p0 = bf16(a), p1 = bf16(a - p0), ...; a piece is
    0 where p0 is infinite or NaN (those pass through p0). Two pieces sum
    to within 2^-16 of a, three hold all of f32's bits
    (``csrc/tc_bf16.cuh``)."""
    rest = a.float()
    finite = None
    out = []
    for _ in range(pieces):
        p = rest.bfloat16()
        if finite is None:
            finite = torch.isfinite(p)
        else:
            p = torch.where(finite, p, torch.zeros((), dtype=p.dtype))
        out.append(p)
        rest = torch.where(finite, rest - p.float(), 0.0)
    return tuple(out)


def uh_split_stacked(ur: torch.Tensor, ui: torch.Tensor) -> torch.Tensor:
    """U_H (H,K) f32 -> Ue (16 ceil(H/8), 6K) bf16, the operand kernels 2
    and 3 read on the tensor cores: per 8 rows of H, 8 rows of
    A_re = [U_r | -U_i] then 8 rows of A_im = [U_i | U_r], each row its three
    bf16 pieces side by side (columns 2K p : 2K (p + 1) hold piece p); rows
    past H are 0."""
    h, k = ur.shape
    groups = -(-h // 8)
    pad = (0, 0, 0, 8 * groups - h)
    a_re = torch.nn.functional.pad(torch.cat([ur, -ui], 1), pad).view(groups, 8, 2 * k)
    a_im = torch.nn.functional.pad(torch.cat([ui, ur], 1), pad).view(groups, 8, 2 * k)
    rows = torch.cat([a_re, a_im], 1).view(16 * groups, 2 * k)
    return torch.cat(bf16_split(rows, 3), 1).contiguous()


# Ue per U_H pair, made once: keyed by the tensors' ids and versions, and
# holding the tensors themselves, so an id is never reused while cached.
_STACKED: "OrderedDict[tuple, tuple]" = OrderedDict()


def _version(t: torch.Tensor) -> int:
    # Tensors made under inference_mode keep no version counter.
    return -1 if t.is_inference() else t._version


def uh_stacked(ur: torch.Tensor, ui: torch.Tensor) -> torch.Tensor:
    """``uh_split_stacked(ur, ui)``, cached for this pair of tensors."""
    key = (id(ur), id(ui), _version(ur), _version(ui))
    hit = _STACKED.get(key)
    if hit is None:
        hit = _STACKED[key] = (ur, ui, uh_split_stacked(ur, ui))
        while len(_STACKED) > 64:
            _STACKED.popitem(last=False)
    return hit[2]


# ------------------------------------------------------------- plain twins

def highpass_contract_plain(x3, vr_t, vi_t):
    """(T_r, T_i) = V_H x: x3 (B,H,WC), V_H^T (H,K) -> (B,K,WC) float32."""
    x32 = x3.float()
    return (torch.einsum("hk,bhj->bkj", vr_t.float(), x32),
            torch.einsum("hk,bhj->bkj", vi_t.float(), x32))


def highpass_expand_plain(x3, ur, ui, sr, si):
    """sqrt(max((x - Re U_H S)^2 + (Im U_H S)^2, 1e-24)) in x3's dtype."""
    lr = torch.einsum("hk,bkj->bhj", ur, sr) - torch.einsum("hk,bkj->bhj", ui, si)
    li = torch.einsum("hk,bkj->bhj", ur, si) + torch.einsum("hk,bkj->bhj", ui, sr)
    zr = x3.float() - lr
    return torch.sqrt(torch.clamp(zr * zr + li * li, min=_EPS)).to(x3.dtype)


def highpass_bwd_contract_plain(x3, g3, ur, ui, sr, si):
    """Kernel 3's math (``fft_pallas.py:390-423``): with z = x - U_H S and
    u = g z/|z| (0 where |z|^2 < 1e-24), returns (Re u in x3's dtype,
    T_r, T_i) where T = U_H^T conj(u) is summed from the unrounded f32 u.
    x3, g3 (B,H,WC); ur, ui (H,K) f32; sr, si (B,K,WC) f32."""
    ein = torch.einsum
    lr = ein("hk,bkj->bhj", ur, sr) - ein("hk,bkj->bhj", ui, si)
    li = ein("hk,bkj->bhj", ur, si) + ein("hk,bkj->bhj", ui, sr)
    zr = x3.float() - lr
    zi = -li
    sq = zr * zr + zi * zi
    coef = torch.where(sq >= _EPS, g3.float() / torch.sqrt(torch.clamp(sq, min=_EPS)), 0.0)
    u_r = coef * zr
    u_i = coef * zi
    t_r = ein("hk,bhj->bkj", ur, u_r) + ein("hk,bhj->bkj", ui, u_i)
    t_i = ein("hk,bhj->bkj", ui, u_r) - ein("hk,bhj->bkj", ur, u_i)
    return u_r.to(x3.dtype), t_r, t_i


def highpass_bwd_expand_plain(u_re, vr_t, vi_t, rr, ri):
    """Kernel 4's math (``fft_pallas.py:427-431``): f32(u_re) - Re(V_H^T R),
    rounded to u_re's dtype (g's). vr_t, vi_t (H,K) f32; rr, ri (B,K,WC)."""
    adj = torch.einsum("hk,bkj->bhj", vr_t, rr) - torch.einsum("hk,bkj->bhj", vi_t, ri)
    return (u_re.float() - adj).to(u_re.dtype)


# ----------------------------------------------------------------- wrappers

def _check(name: str, x3: torch.Tensor, k: int) -> int:
    if x3.dim() != 3 or not x3.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (B,H,W*C) tensor, "
                         f"got shape {tuple(x3.shape)} strides {x3.stride()}")
    if x3.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: x must be float32 or bfloat16, got {x3.dtype}")
    if k not in SUPPORTED_K:
        raise ValueError(f"{name}: K={k} not in {SUPPORTED_K} (mask_range <= 32)")
    if x3.numel() >= 2**31:
        raise ValueError(f"{name}: {x3.numel()} elements exceed the kernel's int32 extents")
    return _DTYPE_CODE[x3.dtype]


def _operand(name: str, t: torch.Tensor, shape, dtype, device, align: int = 1) -> int:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device \
            or not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name}: operand {tuple(t.shape)} {t.dtype} {t.device} "
                         f"does not match {tuple(shape)} {dtype} {device} contiguous, "
                         f"{align}-byte aligned")
    return t.data_ptr()


# ctypes signatures of each library's entry points: p = pointer or stream,
# i = int (a pointer passed as a plain int would be cut to 32 bits).
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "highpass": {
        "eelunet_highpass_contract": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        "eelunet_highpass_expand": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    },
    "highpass_bwd": {
        "eelunet_highpass_bwd_contract":
            [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        "eelunet_highpass_bwd_expand": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    },
}
SOURCES = tuple(_SIGNATURES)  # the csrc/<name>.cu files these wrappers launch


def _lib(name: str):
    from eelunet_tpu_torch.ops._build import load

    lib = load(name)
    if not getattr(lib, "_eelunet_typed", False):
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
        lib._eelunet_typed = True
    return lib


def _stacked_ptr(name: str, ur: torch.Tensor, ui: torch.Tensor, h: int, k: int) -> int:
    """Ue of (ur, ui), which the bf16 kernels copy in 16-byte pieces."""
    return _operand(name, uh_stacked(ur, ui), (16 * (-(-h // 8)), 6 * k), torch.bfloat16,
                    ur.device, align=16)


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def highpass_contract(x3: torch.Tensor, vr_t: torch.Tensor, vi_t: torch.Tensor):
    """T = V_H x. x3 (B,H,WC) f32/bf16; vr_t, vi_t (H,K) in x3's dtype.
    Returns (T_r, T_i), each (B,K,WC) float32."""
    if x3.device.type in _PLAIN:
        return highpass_contract_plain(x3, vr_t, vi_t)
    b, h, wc = x3.shape
    k = vr_t.shape[1]
    code = _check("highpass_contract", x3, k)
    # The tensor-core kernels copy factor rows in 16-byte pieces.
    ptrs = [_operand("highpass_contract", t, (h, k), x3.dtype, x3.device, align=16)
            for t in (vr_t, vi_t)]
    tr = torch.empty((b, k, wc), dtype=torch.float32, device=x3.device)
    ti = torch.empty_like(tr)
    with torch.cuda.device(x3.device):  # launch on the operand's card
        err = _lib("highpass").eelunet_highpass_contract(
            code, k, x3.data_ptr(), *ptrs, tr.data_ptr(), ti.data_ptr(), b, h, wc,
            torch.cuda.current_stream(x3.device).cuda_stream)
    _raise_on("highpass_contract", err)
    LAUNCHES["highpass_contract"] += 1
    return tr, ti


def highpass_expand(x3: torch.Tensor, ur: torch.Tensor, ui: torch.Tensor,
                    sr: torch.Tensor, si: torch.Tensor) -> torch.Tensor:
    """|x - U_H S| with the 1e-24 floor. x3 (B,H,WC) f32/bf16; ur, ui (H,K)
    f32; sr, si (B,K,WC) f32. Returns (B,H,WC) in x3's dtype."""
    if x3.device.type in _PLAIN:
        return highpass_expand_plain(x3, ur, ui, sr, si)
    b, h, wc = x3.shape
    k = ur.shape[1]
    code = _check("highpass_expand", x3, k)
    f32 = torch.float32
    ptrs = [_operand("highpass_expand", t, (h, k), f32, x3.device) for t in (ur, ui)]
    ptrs.append(_stacked_ptr("highpass_expand", ur, ui, h, k))
    ptrs += [_operand("highpass_expand", t, (b, k, wc), f32, x3.device) for t in (sr, si)]
    out = torch.empty_like(x3)
    with torch.cuda.device(x3.device):  # launch on the operand's card
        err = _lib("highpass").eelunet_highpass_expand(
            code, k, x3.data_ptr(), *ptrs, out.data_ptr(), b, h, wc,
            torch.cuda.current_stream(x3.device).cuda_stream)
    _raise_on("highpass_expand", err)
    LAUNCHES["highpass_expand"] += 1
    return out


def highpass_bwd_contract(x3: torch.Tensor, g3: torch.Tensor, ur: torch.Tensor,
                          ui: torch.Tensor, sr: torch.Tensor, si: torch.Tensor):
    """Kernel 3. x3, g3 (B,H,WC) f32/bf16, of one dtype; ur, ui (H,K) f32;
    sr, si (B,K,WC) f32. Returns (u_re in x3's dtype, T_r, T_i (B,K,WC) f32)."""
    name = "highpass_bwd_contract"
    if g3.shape != x3.shape or g3.dtype != x3.dtype or g3.device != x3.device:
        raise ValueError(f"{name}: g {tuple(g3.shape)} {g3.dtype} on {g3.device} does not "
                         f"match x {tuple(x3.shape)} {x3.dtype} on {x3.device}")
    if x3.device.type in _PLAIN:
        return highpass_bwd_contract_plain(x3, g3, ur, ui, sr, si)
    b, h, wc = x3.shape
    k = ur.shape[1]
    code = _check(name, x3, k)
    _check(name, g3, k)
    f32 = torch.float32
    ptrs = [_operand(name, t, (h, k), f32, x3.device) for t in (ur, ui)]
    ptrs.append(_stacked_ptr(name, ur, ui, h, k))
    ptrs += [_operand(name, t, (b, k, wc), f32, x3.device) for t in (sr, si)]
    u_re = torch.empty_like(x3)
    tr = torch.empty((b, k, wc), dtype=f32, device=x3.device)
    ti = torch.empty_like(tr)
    with torch.cuda.device(x3.device):  # launch on the operand's card
        err = _lib("highpass_bwd").eelunet_highpass_bwd_contract(
            code, k, x3.data_ptr(), g3.data_ptr(), *ptrs, u_re.data_ptr(),
            tr.data_ptr(), ti.data_ptr(), b, h, wc,
            torch.cuda.current_stream(x3.device).cuda_stream)
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return u_re, tr, ti


def highpass_bwd_expand(u_re: torch.Tensor, vr_t: torch.Tensor, vi_t: torch.Tensor,
                        rr: torch.Tensor, ri: torch.Tensor) -> torch.Tensor:
    """Kernel 4. u_re (B,H,WC) f32/bf16 (x's dtype); vr_t, vi_t (H,K) f32;
    rr, ri (B,K,WC) f32. Returns dx (B,H,WC) in u_re's dtype."""
    if u_re.device.type in _PLAIN:
        return highpass_bwd_expand_plain(u_re, vr_t, vi_t, rr, ri)
    name = "highpass_bwd_expand"
    b, h, wc = u_re.shape
    k = vr_t.shape[1]
    code = _check(name, u_re, k)
    f32 = torch.float32
    ptrs = [_operand(name, t, (h, k), f32, u_re.device, align=16) for t in (vr_t, vi_t)]
    ptrs += [_operand(name, t, (b, k, wc), f32, u_re.device) for t in (rr, ri)]
    dx = torch.empty_like(u_re)
    with torch.cuda.device(u_re.device):  # launch on the operand's card
        err = _lib("highpass_bwd").eelunet_highpass_bwd_expand(
            code, k, *ptrs, u_re.data_ptr(), dx.data_ptr(), b, h, wc,
            torch.cuda.current_stream(u_re.device).cuda_stream)
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return dx


def w_axis_middle(tr, ti, uwr, uwi, vwr, vwi, w: int, c: int):
    """S = T V_W^T U_W^T on the skinny (B,K,W*C) spectrum: contract the W
    axis to K and expand it back, four float32 einsums per complex product
    (``fft_pallas.py:273-285``). Returns contiguous (S_r, S_i), (B,K,W*C)."""
    b, k, _ = tr.shape
    tr4 = tr.view(b, k, w, c)
    ti4 = ti.view(b, k, w, c)
    ein = torch.einsum
    core_r = ein("lw,bkwc->bklc", vwr, tr4) - ein("lw,bkwc->bklc", vwi, ti4)
    core_i = ein("lw,bkwc->bklc", vwr, ti4) + ein("lw,bkwc->bklc", vwi, tr4)
    s_r = ein("wl,bklc->bkwc", uwr, core_r) - ein("wl,bklc->bkwc", uwi, core_i)
    s_i = ein("wl,bklc->bkwc", uwr, core_i) + ein("wl,bklc->bkwc", uwi, core_r)
    return s_r.reshape(b, k, w * c).contiguous(), s_i.reshape(b, k, w * c).contiguous()


def highpass_fwd(x: torch.Tensor, mask_range: int):
    """Kernels 1 and 2 with the middle between: (out, S_r, S_i) for NHWC x,
    out in x's dtype, S the skinny spectrum the backward reuses."""
    b, h, w, c = x.shape
    vr_t, vi_t, uhr, uhi, uwr, uwi, vwr, vwi = factor_tensors(
        h, w, mask_range, x.dtype, x.device)
    x3 = x.reshape(b, h, w * c)
    tr, ti = highpass_contract(x3, vr_t, vi_t)
    s_r, s_i = w_axis_middle(tr, ti, uwr, uwi, vwr, vwi, w, c)
    return highpass_expand(x3, uhr, uhi, s_r, s_i).view(b, h, w, c), s_r, s_i


def highpass_bwd(x: torch.Tensor, s_r: torch.Tensor, s_i: torch.Tensor, g: torch.Tensor,
                 mask_range: int) -> torch.Tensor:
    """Kernels 3 and 4 with the adjoint middle between: dx for NHWC x and
    its contiguous cotangent g of x's dtype, in that dtype. Every factor is float32
    (``_bwd_factor_args``, ``fft_pallas.py:434-450``)."""
    b, h, w, c = x.shape
    vr_t, vi_t, uhr, uhi, uwr, uwi, vwr, vwi = factor_tensors(
        h, w, mask_range, torch.float32, x.device)
    u_re, tr, ti = highpass_bwd_contract(
        x.reshape(b, h, w * c), g.reshape(b, h, w * c), uhr, uhi, s_r, s_i)
    r_r, r_i = w_axis_middle(tr, ti, vwr.T, vwi.T, uwr.T, uwi.T, w, c)
    return highpass_bwd_expand(u_re, vr_t, vi_t, r_r, r_i).view(b, h, w, c)


class HighPassFunction(torch.autograd.Function):
    """The high-pass with its analytic backward. Saves (x, S_r, S_i), so the
    backward never recomputes the contraction of x. Autocast is off inside
    both passes: the W-axis middle and every factor stay float32, whatever
    the caller's autocast region."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mask_range: int) -> torch.Tensor:
        with autocast_off(x.device.type):
            out, s_r, s_i = highpass_fwd(x, mask_range)
        ctx.mask_range = mask_range
        ctx.save_for_backward(x, s_r, s_i)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, s_r, s_i = ctx.saved_tensors
        with autocast_off(x.device.type):
            return highpass_bwd(x, s_r, s_i, g.contiguous(), ctx.mask_range), None


def high_pass_fft_cuda(x: torch.Tensor, mask_range: int = 20) -> torch.Tensor:
    """abs(x - lowpass(x)) for NHWC input through the kernels (the plain
    twins on a CPU tensor). The output has x's shape and dtype. With grad
    enabled and x requiring it, the call goes through ``HighPassFunction``."""
    if torch.is_grad_enabled() and x.requires_grad:
        return HighPassFunction.apply(x, mask_range)
    with autocast_off(x.device.type):
        return highpass_fwd(x, mask_range)[0]
