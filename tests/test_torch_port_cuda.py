"""The hand-written CUDA high-pass kernels against their plain PyTorch twins,
on the card. Every test here needs a CUDA device and skips without one; on
the H100 run ``python -m pytest -q tests/test_torch_port_cuda.py`` (this file
imports no JAX, so it runs where only the port is installed).
"""

from __future__ import annotations

import pytest
import torch

from eelunet_tpu_torch.models.eelunet import high_pass_fft_reference
from eelunet_tpu_torch.ops import fft_cuda
from eelunet_tpu_torch.ops.fft import high_pass_fft_lowrank

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _x(shape, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


# (B,H,W,C), mask_range: every K the kernels take (16, 32, 48, 64), ragged
# W*C (not a multiple of the 128-thread block) and H not a multiple of 32.
CASES = [((2, 32, 32, 16), 6), ((2, 64, 48, 5), 12), ((1, 100, 64, 3), 20),
         ((2, 128, 128, 8), 32)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,mask_range", CASES)
def test_kernels_match_plain_twins(cuda, shape, mask_range, dtype, tol):
    b, h, w, c = shape
    x = _x(shape, dtype, cuda)
    x3 = x.view(b, h, w * c)
    vr_t, vi_t, uhr, uhi, uwr, uwi, vwr, vwi = fft_cuda.factor_tensors(h, w, mask_range, dtype, cuda)
    fft_cuda.reset_launches()
    with torch.inference_mode():
        tk = fft_cuda.highpass_contract(x3, vr_t, vi_t)
        tp = fft_cuda.highpass_contract_plain(x3, vr_t, vi_t)
        s = fft_cuda.w_axis_middle(*tp, uwr, uwi, vwr, vwi, w, c)
        ok_ = fft_cuda.highpass_expand(x3, uhr, uhi, *s)
        op_ = fft_cuda.highpass_expand_plain(x3, uhr, uhi, *s)
    torch.cuda.synchronize()
    assert fft_cuda.LAUNCHES == {"highpass_contract": 1, "highpass_expand": 1,
                                 "highpass_bwd_contract": 0, "highpass_bwd_expand": 0}
    assert ok_.dtype == dtype and ok_.shape == x3.shape
    assert _rel(tk[0], tp[0]) <= 1e-5 and _rel(tk[1], tp[1]) <= 1e-5
    assert _rel(ok_, op_) <= tol


def test_whole_op_matches_fft_reference(cuda):
    x = _x((2, 64, 64, 32), torch.float32, cuda, seed=1)
    with torch.inference_mode():
        got = fft_cuda.high_pass_fft_cuda(x, 20)
    assert _rel(got, high_pass_fft_reference(x, 20)) <= 1e-4
    assert _rel(got, high_pass_fft_lowrank(x, 20)) <= 1e-5


def _rel_l2(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape,mask_range", CASES)
def test_bwd_kernels_match_plain_twins(cuda, shape, mask_range, dtype, tol):
    """Kernels 3 and 4 against their twins on the same saved spectrum and
    cotangent. T sums from the unrounded f32 u in both, so it agrees to f32
    summation order even in bf16. u_re and dx are held in relative L2: u =
    g z/|z| turns with summation order where |z| is near 0, and bf16 adds one
    rounding (chip_smoke.py BWD_TOL)."""
    b, h, w, c = shape
    x = _x(shape, dtype, cuda)
    g = _x(shape, dtype, cuda, seed=1)
    x3, g3 = x.view(b, h, w * c), g.view(b, h, w * c)
    vr_t, vi_t, uhr, uhi, uwr, uwi, vwr, vwi = fft_cuda.factor_tensors(
        h, w, mask_range, torch.float32, cuda)
    with torch.inference_mode():
        _, s_r, s_i = fft_cuda.highpass_fwd(x, mask_range)
        fft_cuda.reset_launches()
        uk, trk, tik = fft_cuda.highpass_bwd_contract(x3, g3, uhr, uhi, s_r, s_i)
        up, trp, tip = fft_cuda.highpass_bwd_contract_plain(x3, g3, uhr, uhi, s_r, s_i)
        r = fft_cuda.w_axis_middle(trp, tip, vwr.T, vwi.T, uwr.T, uwi.T, w, c)
        dk = fft_cuda.highpass_bwd_expand(up, vr_t, vi_t, *r)
        dp = fft_cuda.highpass_bwd_expand_plain(up, vr_t, vi_t, *r)
    torch.cuda.synchronize()
    assert fft_cuda.LAUNCHES["highpass_bwd_contract"] == fft_cuda.LAUNCHES["highpass_bwd_expand"] == 1
    assert uk.dtype == dtype and dk.dtype == dtype and trk.dtype == torch.float32
    assert _rel(trk, trp) <= 1e-4 and _rel(tik, tip) <= 1e-4
    assert _rel_l2(uk, up) <= tol and _rel_l2(dk, dp) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_function_grad_matches_lowrank_autograd(cuda, dtype, tol):
    """The whole Function's gradient (four kernel launches) against autograd
    through the plain low-rank op, with a non-uniform cotangent, in relative
    L2 (chip_smoke.py GRAD_TOL): in bfloat16 the kernel path contracts with
    a bf16 V_H (as the JAX kernels do) and the low-rank op with an f32 one,
    which turns u = g z/|z| at the pixels where |z| is that small."""
    x = _x((2, 64, 64, 16), dtype, cuda, seed=2).requires_grad_(True)
    g = _x((2, 64, 64, 16), dtype, cuda, seed=3)
    fft_cuda.reset_launches()
    (got,) = torch.autograd.grad(fft_cuda.high_pass_fft_cuda(x, 20), x, g)
    torch.cuda.synchronize()
    assert set(fft_cuda.LAUNCHES.values()) == {1}
    (want,) = torch.autograd.grad(high_pass_fft_lowrank(x, 20), x, g)
    assert got.dtype == dtype and _rel_l2(got, want) <= tol
