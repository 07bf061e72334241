"""The port's high-pass backward against the JAX package's, on the CPU.

- The backward kernels' plain twins (``ops/fft_cuda``) against the JAX
  package's Pallas backward kernels in interpret mode, on the same saved
  spectrum and cotangent.
- ``torch.autograd.grad`` through the port's ``HighPassFunction`` (which
  runs the twins on a CPU tensor) against ``jax.vjp`` of
  ``high_pass_fft_pallas`` and against autograd of the port's low-rank op.

The shapes are those of tests/test_fft_pallas.py's gradient tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from eelunet_tpu.ops import fft_pallas as fp
from eelunet_tpu_torch.models.eelunet import high_pass_fft
from eelunet_tpu_torch.ops import fft_cuda
from eelunet_tpu_torch.ops.fft import high_pass_fft_lowrank

SHAPES = [
    ((1, 32, 32, 8), 8),
    ((2, 16, 32, 8), 4),    # non-square
    ((1, 32, 32, 4), 20),   # joint clamp: 2m == H
]
# tests/test_fft_pallas.py's bound for the backward kernels against the XLA
# adjoint: the same f32 math summed in another order.
ATOL, RTOL = 2e-5, 2e-4


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _jax_bwd_contract(x, s_r, s_i, g, m):
    """The JAX package's kernel 3 body (``_bwd_contract_kernel``) in
    interpret mode, one whole image per grid step: (u_re, T_r, T_i)."""
    b, h, w, c = x.shape
    wc = w * c
    uhr, uhi = fp._bwd_factor_args(x, m)[:2]
    k = uhr.shape[1]
    vmem = pltpu.VMEM
    rows = pl.BlockSpec((h, k), lambda bi, wi, hi: (0, 0), memory_space=vmem)
    skinny = pl.BlockSpec((1, k, wc), lambda bi, wi, hi: (bi, 0, 0), memory_space=vmem)
    image = pl.BlockSpec((1, h, wc), lambda bi, wi, hi: (bi, 0, 0), memory_space=vmem)
    return pl.pallas_call(
        fp._bwd_contract_kernel,
        grid=(b, 1, 1),
        in_specs=[rows, rows, skinny, skinny, image, image],
        out_specs=(image, skinny, skinny),
        out_shape=(jax.ShapeDtypeStruct((b, h, wc), x.dtype),
                   jax.ShapeDtypeStruct((b, k, wc), jnp.float32),
                   jax.ShapeDtypeStruct((b, k, wc), jnp.float32)),
        interpret=True,
    )(uhr, uhi, s_r, s_i, x.reshape(b, h, wc), g.reshape(b, h, wc))


@pytest.mark.parametrize("shape,m", SHAPES)
def test_bwd_twins_match_jax_kernels(shape, m):
    x = jnp.asarray(_rand(shape, 11))
    g = jnp.asarray(_rand(shape, 12))
    _, (s_r, s_i) = fp._highpass_fwd(x, m, True)
    b, h, w, c = shape
    vr_t, vi_t, uhr, uhi, *_ = fft_cuda.factor_tensors(h, w, m, torch.float32,
                                                      torch.device("cpu"))
    # kernel 3: u_re and the skinny T
    want_u, want_tr, want_ti = _jax_bwd_contract(x, s_r, s_i, g, m)
    got_u, got_tr, got_ti = fft_cuda.highpass_bwd_contract(
        _t(x).view(b, h, w * c), _t(g).view(b, h, w * c), uhr, uhi, _t(s_r), _t(s_i))
    for got, want in ((got_u, want_u), (got_tr, want_tr), (got_ti, want_ti)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    # kernels 3 and 4 with the adjoint middle: dx
    want_dx = fp._bwd_core(x, s_r, s_i, g, *fp._bwd_factor_args(x, m), m, True)
    got_dx = fft_cuda.highpass_bwd(_t(x), _t(s_r), _t(s_i), _t(g), m)
    assert got_dx.shape == shape and got_dx.dtype == torch.float32
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx), atol=ATOL, rtol=RTOL)


def _port_grad(x_np, g_np, m, impl):
    x = torch.from_numpy(x_np).requires_grad_(True)
    if impl == "lowrank":
        out = high_pass_fft_lowrank(x, m)
    else:
        out = high_pass_fft(x, m, impl)
    (dx,) = torch.autograd.grad(out, x, torch.from_numpy(g_np))
    return dx.numpy()


@pytest.mark.parametrize("shape,m", SHAPES)
def test_function_grad_matches_jax_vjp(shape, m):
    x, g = _rand(shape, 7), _rand(shape, 8)
    fft_cuda.reset_launches()
    got = _port_grad(x, g, m, "auto")
    assert set(fft_cuda.LAUNCHES.values()) == {0}  # a CPU tensor takes the twins
    _, vjp = jax.vjp(lambda v: fp.high_pass_fft_pallas(v, m, True), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape,m", SHAPES)
def test_function_grad_matches_lowrank_autograd(shape, m):
    x, g = _rand(shape, 9), _rand(shape, 10)
    got = _port_grad(x, g, m, "auto")
    want = _port_grad(x, g, m, "lowrank")
    # tests/test_fft_pallas.py's bound for the kernels' VJP against autodiff
    # of the low-rank op: the same adjoint, factored differently.
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("value", [0.0, 1e-14])
def test_constant_input_gives_zero_grads(value):
    """A constant input whose residual |z|^2 falls under the 1e-24 floor:
    u is 0 there, so the gradient is finite and zero, as in JAX."""
    shape, m = (1, 32, 32, 4), 8
    x = np.full(shape, value, np.float32)
    g = _rand(shape, 13)
    got = _port_grad(x, g, m, "auto")
    assert np.isfinite(got).all() and not got.any()
    _, vjp = jax.vjp(lambda v: fp.high_pass_fft_pallas(v, m, True), jnp.asarray(x))
    np.testing.assert_array_equal(got, np.asarray(vjp(jnp.asarray(g))[0]))
