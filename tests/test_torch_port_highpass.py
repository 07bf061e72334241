"""The port's FFT high-pass (plain PyTorch) against the JAX package's Pallas
kernels in interpret mode, its XLA low-rank path and its jnp.fft golden path,
plus the kernel pair's plain twins against numpy.

The shapes are those of tests/test_fft_pallas.py. On the CPU the port's
kernel wrappers take their plain twins (a CPU tensor never launches).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eelunet_tpu.models.eelunet import high_pass_fft_reference as jax_reference
from eelunet_tpu.ops.fft import high_pass_fft_lowrank as jax_lowrank
from eelunet_tpu.ops.fft_pallas import high_pass_fft_pallas, pallas_supported
from eelunet_tpu_torch.models.eelunet import high_pass_fft, high_pass_fft_reference
from eelunet_tpu_torch.ops import fft_cuda
from eelunet_tpu_torch.ops.fft import _axis_factors, high_pass_fft_lowrank

SHAPES = [
    ((2, 32, 32, 16), 20),   # m clamps to 16, 2m == H
    ((1, 64, 64, 8), 20),    # m = 20 < H/2
    ((2, 16, 32, 8), 4),     # non-square, small mask
    ((1, 32, 48, 4), 6),     # W*C = 192, not a multiple of 128
]
PORT_IMPLS = {
    "lowrank": high_pass_fft_lowrank,
    "kernel_pair_plain": fft_cuda.high_pass_fft_cuda,
}


def _rand(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("impl", sorted(PORT_IMPLS))
@pytest.mark.parametrize("shape,mask_range", SHAPES)
def test_port_matches_jax_f32(shape, mask_range, impl):
    x = _rand(shape)
    got = PORT_IMPLS[impl](torch.from_numpy(x), mask_range)
    assert got.shape == shape and got.dtype == torch.float32
    want = [np.asarray(jax_lowrank(jnp.asarray(x), mask_range))]
    if pallas_supported(shape):
        want.append(np.asarray(high_pass_fft_pallas(jnp.asarray(x), mask_range, True)))
    for w in want:  # tests/test_fft_pallas.py's bound, Pallas vs low-rank
        np.testing.assert_allclose(got.numpy(), w, atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("shape,mask_range", [((2, 32, 32, 8), 10), ((1, 16, 32, 4), 4)])
def test_reference_matches_jax_reference(shape, mask_range):
    x = _rand(shape, seed=3)
    got = high_pass_fft_reference(torch.from_numpy(x), mask_range).numpy()
    want = np.asarray(jax_reference(jnp.asarray(x), mask_range))
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-3)
    # and the kernel pair's structure against the golden FFT path
    pair = fft_cuda.high_pass_fft_cuda(torch.from_numpy(x), mask_range).numpy()
    np.testing.assert_allclose(pair, want, atol=5e-5, rtol=1e-3)


def test_kernel_pair_bf16_matches_pallas_bf16():
    x = _rand((1, 64, 64, 16), seed=5)
    got = fft_cuda.high_pass_fft_cuda(torch.from_numpy(x).bfloat16(), 20)
    assert got.dtype == torch.bfloat16
    want = np.asarray(high_pass_fft_pallas(jnp.asarray(x, jnp.bfloat16), 20, True), np.float32)
    # Same operand types (bf16 x and V_H, f32 accumulation, f32 expand): the
    # two differ by summation order plus one bf16 rounding of the output.
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("b,h,wc,m", [(2, 16, 24, 4), (1, 32, 40, 10)])
def test_plain_twins_match_numpy(b, h, wc, m):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, h, wc)).astype(np.float32)
    _, k = fft_cuda.padded_k(h, h, m)
    ur, ui, vr, vi = fft_cuda._padded_factors(h, m, k)
    tr, ti = fft_cuda.highpass_contract_plain(
        torch.from_numpy(x), torch.from_numpy(vr.T.copy()), torch.from_numpy(vi.T.copy()))
    t = np.einsum("kh,bhj->bkj", vr.astype(np.float64) + 1j * vi, x)
    np.testing.assert_allclose(tr.numpy(), t.real, atol=1e-5)
    np.testing.assert_allclose(ti.numpy(), t.imag, atol=1e-5)

    s = rng.standard_normal((b, k, wc)) + 1j * rng.standard_normal((b, k, wc))
    s[:, 2 * m:] = 0.0  # padded frequencies carry nothing
    out = fft_cuda.highpass_expand_plain(
        torch.from_numpy(x), torch.from_numpy(ur), torch.from_numpy(ui),
        torch.from_numpy(s.real.astype(np.float32)), torch.from_numpy(s.imag.astype(np.float32)))
    want = np.abs(x - np.einsum("hk,bkj->bhj", ur.astype(np.float64) + 1j * ui, s))
    np.testing.assert_allclose(out.numpy(), np.maximum(want, 1e-12), atol=1e-5)


def test_padding_keeps_the_operator():
    ur, ui, vr, vi = _axis_factors(32, 6)
    pr, pi, qr, qi = fft_cuda._padded_factors(32, 6, 16)
    assert pr.shape == (32, 16) and qr.shape == (16, 32)
    a = (ur + 1j * ui) @ (vr + 1j * vi)
    b = (pr + 1j * pi) @ (qr + 1j * qi)
    np.testing.assert_allclose(b, a, atol=1e-6)
    assert fft_cuda.padded_k(512, 512, 20) == (20, 48)
    assert fft_cuda.padded_k(32, 32, 20) == (16, 32)


def test_cpu_tensor_takes_the_plain_twin():
    fft_cuda.reset_launches()
    x = torch.from_numpy(_rand((1, 32, 32, 4)))
    out = high_pass_fft(x, 6, "auto")
    np.testing.assert_allclose(out.numpy(), high_pass_fft_lowrank(x, 6).numpy(), atol=2e-5)
    assert fft_cuda.LAUNCHES == {"highpass_contract": 0, "highpass_expand": 0,
                                 "highpass_bwd_contract": 0, "highpass_bwd_expand": 0}
    with pytest.raises(ValueError, match="unknown highpass_impl"):
        high_pass_fft(x, 6, "fft")


def test_wrapper_checks_before_launch():
    ok = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="contiguous"):
        fft_cuda._check("k", ok.transpose(1, 2), 16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fft_cuda._check("k", ok.half(), 16)
    with pytest.raises(ValueError, match="K=40"):
        fft_cuda._check("k", ok, 40)
    assert fft_cuda._check("k", ok.bfloat16(), 48) == 1
