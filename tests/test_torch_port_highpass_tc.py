"""The precision of the tensor-core high-pass kernels, on the CPU.

Kernel 1 (``contract_kernel_tc``) multiplies the stacked V_H^T = [V_r^T |
V_i^T] by x in bf16 with f32 sums; kernel 4 (``bwd_expand_kernel_tc``)
rounds A = [V_r^T | -V_i^T] and R = [R_r; R_i] to TF32 before its products.
The kernels run only on the card; here their operands are held to the JAX
package's factors, and their arithmetic, emulated in plain PyTorch
(``tests/torch_port_helpers.py``), to the JAX package's kernels (Pallas in
interpret mode) within the bounds ``chip_smoke.py`` holds the card to.

The shapes are those of tests/test_torch_port_highpass.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eelunet_tpu.ops import fft_pallas as fp
from eelunet_tpu.ops.fft import high_pass_fft_lowrank as jax_lowrank
from eelunet_tpu_torch.ops import fft_cuda
from torch_port_helpers import (bwd_expand_tf32_emulated, contract_tc_emulated, round_tf32,
                                stacked_factors)

SHAPES = [
    ((2, 32, 32, 16), 20),   # m clamps to 16, 2m == H
    ((1, 64, 64, 8), 20),    # m = 20 < H/2
    ((2, 16, 32, 8), 4),     # non-square, small mask
    ((1, 32, 48, 4), 6),     # W*C = 192, not a multiple of 128
]
# chip_smoke.py's bounds for the card: the forward in bf16 relative to
# max|reference| (TOL), the backward's dx in bf16 in relative L2 (BWD_TOL),
# and T (a sum over H) relative to max|T|.
FWD_BF16, BWD_BF16, T_REL = 2e-2, 1e-2, 1e-4


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).bfloat16()


def _rel_max(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,m", SHAPES)
def test_stacked_operands_are_the_jax_factors(shape, m, dtype):
    """The stacked operands equal JAX ``_padded_factors`` rearranged,
    exactly, and twins computed from them give today's twins."""
    b, h, w, c = shape
    vr_t, vi_t, *_ = fft_cuda.factor_tensors(h, w, m, dtype, torch.device("cpu"))
    v_stack, a = stacked_factors(vr_t, vi_t)
    mm = min(m, h // 2, w // 2)
    k = max(fp._round_up(2 * mm, 16), 16)
    _, _, vhr, vhi = fp._padded_factors(h, mm, k)
    want_v = torch.from_numpy(np.concatenate([vhr.T, vhi.T], axis=1)).to(dtype)
    want_a = torch.from_numpy(np.concatenate([vhr.T, -vhi.T], axis=1)).to(dtype)
    assert v_stack.shape == (h, 2 * k) and torch.equal(v_stack, want_v)
    assert torch.equal(a, want_a)

    x3 = torch.from_numpy(_rand(shape, 1)).to(dtype).view(b, h, w * c)
    got = contract_tc_emulated(x3, vr_t, vi_t)
    want = fft_cuda.highpass_contract_plain(x3, vr_t, vi_t)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=0, atol=1e-6 * w_.abs().max().item())
    u = torch.from_numpy(_rand(shape, 2)).to(dtype).view(b, h, w * c)
    rr, ri = (torch.from_numpy(_rand((b, k, w * c), s)) for s in (3, 4))
    vr32, vi32 = vr_t.float(), vi_t.float()
    exact = torch.einsum("hk,bkj->bhj", a.double(), torch.cat([rr, ri], 1).double())
    np.testing.assert_allclose(
        (u.double() - exact).numpy(),
        fft_cuda.highpass_bwd_expand_plain(u.float(), vr32, vi32, rr, ri).double().numpy(),
        rtol=0, atol=1e-5 * exact.abs().max().item())


def test_round_tf32_is_round_to_nearest_even():
    one = 1.0
    ulp = 2.0 ** -10  # TF32's spacing at 1
    x = torch.tensor([one + ulp / 2, one + 1.5 * ulp, one + 0.49 * ulp, -(one + 1.5 * ulp),
                      float("inf"), -float("inf"), 3e38, 0.0, -0.0], dtype=torch.float32)
    got = round_tf32(x)
    assert got[0].item() == one                      # tie -> even (down)
    assert got[1].item() == one + 2 * ulp            # tie -> even (up)
    assert got[2].item() == one
    assert got[3].item() == -(one + 2 * ulp)
    assert torch.isinf(got[4]) and got[4] > 0 and torch.isinf(got[5]) and got[5] < 0
    assert torch.isnan(round_tf32(torch.tensor([float("nan")])))[0]
    assert torch.equal(got[7:], x[7:])
    # Against numpy's round-half-to-even on the scaled mantissa, random values.
    v = torch.from_numpy(_rand((4096,), 5) * 10.0 ** np.random.default_rng(6).uniform(-8, 8, 4096)
                         .astype(np.float32))
    bits = round_tf32(v).view(torch.int32).numpy()
    assert not (bits & 0x1FFF).any()
    vd = v.double().numpy()
    e = np.floor(np.log2(np.abs(vd)))
    want = np.round(vd * 2.0 ** (10 - e)) * 2.0 ** (e - 10)
    np.testing.assert_array_equal(round_tf32(v).double().numpy(), want)


@pytest.mark.parametrize("shape,m", SHAPES)
def test_kernel1_arithmetic_matches_jax(shape, m):
    """Kernel 1's arithmetic (bf16 operands, f32 sums), through the W-axis
    middle and kernel 2's twin, against JAX ``_fwd_core`` in interpret mode
    on the same bf16 x (the XLA low-rank op where Pallas cannot tile)."""
    b, h, w, c = shape
    x_np = _rand(shape, 7)
    x = _bf16(x_np)
    vr_t, vi_t, uhr, uhi, uwr, uwi, vwr, vwi = fft_cuda.factor_tensors(
        h, w, m, torch.bfloat16, torch.device("cpu"))
    x3 = x.view(b, h, w * c)
    tr, ti = contract_tc_emulated(x3, vr_t, vi_t)
    s_r, s_i = fft_cuda.w_axis_middle(tr, ti, uwr, uwi, vwr, vwi, w, c)
    out = fft_cuda.highpass_expand_plain(x3, uhr, uhi, s_r, s_i).view(shape)
    xj = jnp.asarray(x_np, jnp.bfloat16)
    if fp.pallas_supported(shape):
        want, ws_r, ws_i = fp._fwd_core(xj, *fp._fwd_factor_args(xj, m), m, True)
        e_s = max(_rel_max(s_r.numpy(), ws_r), _rel_max(s_i.numpy(), ws_i))
        assert e_s <= T_REL, e_s
    else:
        want, e_s = jax_lowrank(xj, m), None
    e_out = _rel_max(out.float().numpy(), np.asarray(want, np.float32))
    print(f"kernel 1 emulated vs JAX {shape}: S rel {e_s}, out rel {e_out:.3e}")
    assert e_out <= FWD_BF16


@pytest.mark.parametrize("shape,m", SHAPES)
def test_kernel4_tf32_matches_jax(shape, m):
    """Kernel 4's TF32 arithmetic, behind kernel 3's twin and the adjoint
    middle, against the JAX package's backward (``_bwd_core`` in interpret
    mode, ``_highpass_bwd_impl`` where Pallas cannot tile) on the same bf16
    x and g and the same saved spectrum; and TF32's own share, against
    kernel 4's f32 twin. In relative L2 within the card's bf16 bound, of dx,
    except where the mask keeps the whole spectrum (2m >= H and W, the first
    shape): there the exact high-pass and its gradient are 0, and JAX's dx
    is set by the f32 summation order of z's rebuild. Reversing that order
    moves dx by more than 100% in relative L2
    (``test_whole_spectrum_dx_is_set_by_the_rebuild_order``), so no kernel
    reproduces JAX's dx there, and the error is held relative to |Re u|
    (TF32 rounds A and R to 2^-11: a few 1e-4 of |Re u| at every shape, printed).
    Where Pallas cannot tile, ``_highpass_bwd_impl`` rounds U_H to bf16,
    which the kernels do not, so the error against JAX is larger there."""
    b, h, w, c = shape
    x_np, g_np = _rand(shape, 8), _rand(shape, 9)
    x, g = _bf16(x_np), _bf16(g_np)
    _, s_r, s_i = fft_cuda.highpass_fwd(x, m)
    vr_t, vi_t, uhr, uhi, uwr, uwi, vwr, vwi = fft_cuda.factor_tensors(
        h, w, m, torch.float32, torch.device("cpu"))
    u_re, tr, ti = fft_cuda.highpass_bwd_contract(
        x.view(b, h, w * c), g.view(b, h, w * c), uhr, uhi, s_r, s_i)
    r_r, r_i = fft_cuda.w_axis_middle(tr, ti, vwr.T, vwi.T, uwr.T, uwi.T, w, c)
    got = bwd_expand_tf32_emulated(u_re, vr_t, vi_t, r_r, r_i)
    twin = fft_cuda.highpass_bwd_expand(u_re, vr_t, vi_t, r_r, r_i)
    assert got.dtype == torch.bfloat16
    xj, gj = jnp.asarray(x_np, jnp.bfloat16), jnp.asarray(g_np, jnp.bfloat16)
    want = fp._highpass_bwd_pallas(xj, jnp.asarray(s_r.numpy()), jnp.asarray(s_i.numpy()), gj,
                                   m, True)
    want = np.asarray(want, np.float32).reshape(b, h, w * c)
    got, twin, u = got.float().numpy(), twin.float().numpy(), u_re.float().numpy()
    e_jax, e_tf32 = _rel_l2(got, want), _rel_l2(got, twin)
    e_u = float(np.linalg.norm(got - want) / np.linalg.norm(u))
    print(f"kernel 4 TF32 emulated {shape}: vs JAX rel-l2 {e_jax:.3e} ({e_u:.3e} of |Re u|), "
          f"vs f32 twin {e_tf32:.3e}; |dx| / |Re u| {np.linalg.norm(want) / np.linalg.norm(u):.3e}")
    assert e_u <= BWD_BF16
    mm = min(m, h // 2, w // 2)
    if 2 * mm < h or 2 * mm < w:
        assert e_jax <= BWD_BF16 and e_tf32 <= BWD_BF16


@pytest.mark.parametrize("shape,m,low,high", [((2, 32, 32, 16), 20, 0.5, None),
                                              ((1, 64, 64, 8), 20, None, 1e-3)])
def test_whole_spectrum_dx_is_set_by_the_rebuild_order(shape, m, low, high):
    """The f32 twin chain (kernel 3's twin, the adjoint middle, kernel 4's
    twin) against itself with the f32 sum over K of z's rebuild taken in
    reverse order. Where the mask keeps the whole spectrum (2m >= H and W)
    z = x - U_H S is f32 rounding noise, u = g z/|z| its direction, and dx
    moves by more than 0.5 in relative L2; where 2m < H it moves by less
    than 1e-3. So at a whole-spectrum site dx is the summation order's, not
    the arithmetic's, and kernel 4 is held there relative to |Re u|."""
    b, h, w, c = shape
    x = torch.from_numpy(_rand(shape, 8)).bfloat16()
    g = torch.from_numpy(_rand(shape, 9)).bfloat16()
    _, s_r, s_i = fft_cuda.highpass_fwd(x, m)
    vr_t, vi_t, uhr, uhi, uwr, uwi, vwr, vwi = fft_cuda.factor_tensors(
        h, w, m, torch.float32, torch.device("cpu"))
    x3, g3 = x.view(b, h, w * c), g.view(b, h, w * c)

    def chain(flip: bool):
        f = (lambda t: t.flip(1)) if flip else (lambda t: t)
        u_re, tr, ti = fft_cuda.highpass_bwd_contract_plain(x3, g3, f(uhr), f(uhi), f(s_r),
                                                            f(s_i))
        r_r, r_i = fft_cuda.w_axis_middle(f(tr), f(ti), vwr.T, vwi.T, uwr.T, uwi.T, w, c)
        return fft_cuda.highpass_bwd_expand_plain(u_re, vr_t, vi_t, r_r, r_i).float().numpy()

    e = _rel_l2(chain(True), chain(False))
    print(f"rebuild order reversed {shape}: dx moves by {e:.3e} in relative L2")
    assert (low is None or e > low) and (high is None or e < high)
