"""The bf16x3 arithmetic of the tensor-core kernels 2 and 3, on the CPU.

Kernel 2 (``expand_kernel_tc``) and kernel 3 (``bwd_contract_kernel_tc``)
multiply f32 factors by f32 spectra on the bf16 tensor cores: each operand
is split into bf16 pieces and a product is taken as the larger piece
products with f32 sums (``csrc/tc_bf16.cuh``): bf16x3 (two pieces, hi hi +
hi lo + lo hi) in kernel 2 and in kernel 3's sum T, bf16x6 (three pieces,
six products) in kernel 3's rebuild of z, where bf16x3 misses the bound on
T. The kernels run only on the card; here the split and the stacked U_H
they read are checked, and their
arithmetic, emulated in plain PyTorch (``tests/torch_port_helpers.py``), is
held to the JAX package's kernels (Pallas in interpret mode, the XLA op
where Pallas cannot tile) and to the port's f32 twins, within the bounds
``chip_smoke.py`` holds the card to. One pass of TF32, the cheaper
arithmetic the kernels do not take, is printed beside kernel 2's error.

The shapes are those of tests/test_torch_port_highpass_tc.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eelunet_tpu.ops import fft_pallas as fp
from eelunet_tpu.ops.fft import high_pass_fft_lowrank as jax_lowrank
from eelunet_tpu_torch.ops import fft_cuda
from torch_port_helpers import (BF16X3, BF16X6, bwd_contract_split_emulated,
                                bwd_expand_tf32_emulated,
                                contract_tc_emulated, expand_bf16x3_emulated,
                                expand_tf32_emulated, ue_pieces)

SHAPES = [
    ((2, 32, 32, 16), 20),   # m clamps to 16, 2m == H: the mask keeps the whole spectrum
    ((1, 64, 64, 8), 20),    # m = 20 < H/2
    ((2, 16, 32, 8), 4),     # non-square, small mask
    ((1, 32, 48, 4), 6),     # W*C = 192, not a multiple of 128
]
# chip_smoke.py's bounds for the card: the forward in bf16 relative to
# max|reference| (TOL), the backward's u and dx in bf16 in relative L2
# (BWD_TOL), and T (a sum over H) relative to max|T|.
FWD_BF16, BWD_BF16, T_REL = 2e-2, 1e-2, 1e-4
CPU = torch.device("cpu")


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _rel_max(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_bf16_split():
    """p0 is bf16 rounded to nearest even; p0 + p1 is within 2^-16 of the
    f32 value and p0 + p1 + p2 equal to it (outside the subnormals);
    infinities and NaNs pass through p0; zero stays zero."""
    rng = np.random.default_rng(0)
    v = torch.from_numpy((rng.standard_normal(8192)
                          * 10.0 ** rng.uniform(-20, 20, 8192)).astype(np.float32))
    hi, lo = fft_cuda.bf16_split(v)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, v.bfloat16())
    # bf16 round to nearest even, from the bits: add 0x7fff plus the kept
    # LSB, drop the low 16.
    bits = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    rne = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) & 0xFFFF
    assert torch.equal(hi.view(torch.int16).to(torch.int64) & 0xFFFF, rne)
    err = (hi.double() + lo.double() - v.double()).abs() / v.double().abs()
    assert err.max().item() <= 2.0 ** -16
    p = fft_cuda.bf16_split(v, 3)
    assert torch.equal(p[0], hi) and torch.equal(p[1], lo)
    assert torch.equal(sum(t.double() for t in p), v.double())
    one = 1.0 + 2.0 ** -8  # a tie for bf16: p0 rounds to even (1.0), p1 keeps the rest
    h, l_ = fft_cuda.bf16_split(torch.tensor([one]))
    assert h.item() == 1.0 and l_.item() == 2.0 ** -8
    special = torch.tensor([float("inf"), -float("inf"), float("nan"), 0.0, -0.0])
    p = fft_cuda.bf16_split(special, 3)
    assert torch.isinf(p[0][0]) and p[0][0] > 0 and torch.isinf(p[0][1]) and p[0][1] < 0
    assert torch.isnan(p[0][2]) and torch.isnan(sum(t.float() for t in p)[2])
    assert torch.equal(sum(t.float() for t in p)[:2], special[:2])
    assert torch.equal(p[0][3:].float(), special[3:])
    assert not p[1][3:].float().any() and not p[2][3:].float().any()


@pytest.mark.parametrize("shape,m", SHAPES)
def test_stacked_uh_is_the_jax_factor_split(shape, m):
    """Ue, the operand kernels 2 and 3 read, holds the three bf16 pieces of
    A_re = [U_r | -U_i] and A_im = [U_i | U_r] built from JAX
    ``_padded_factors``, interleaved by 8 rows of H, zero past H; and it is
    made once per factor pair."""
    b, h, w, c = shape
    _, _, ur, ui, *_ = fft_cuda.factor_tensors(h, w, m, torch.float32, CPU)
    ue = fft_cuda.uh_stacked(ur, ui)
    assert fft_cuda.uh_stacked(ur, ui) is ue
    mm = min(m, h // 2, w // 2)
    k = max(fp._round_up(2 * mm, 16), 16)
    uhr, uhi, _, _ = fp._padded_factors(h, mm, k)
    assert ue.shape == (16 * -(-h // 8), 6 * k) and ue.dtype == torch.bfloat16
    for pieces, want in zip(ue_pieces(ue, h), (np.concatenate([uhr, -uhi], 1),
                                               np.concatenate([uhi, uhr], 1))):
        want = torch.from_numpy(want.astype(np.float32))
        rest = want
        for piece in pieces:
            assert torch.equal(piece, rest.bfloat16().float())
            rest = rest - piece
        assert torch.equal(sum(p_.double() for p_ in pieces), want.double())
    grp = ue.float().view(-1, 2, 8, 6 * k)
    tail = grp.permute(1, 0, 2, 3).reshape(2, -1, 6 * k)[:, h:]
    assert not tail.any()
    # A tensor changed in place gets a new Ue.
    ur2 = ur.clone()
    first = fft_cuda.uh_stacked(ur2, ui)
    ur2.mul_(2.0)
    assert not torch.equal(fft_cuda.uh_stacked(ur2, ui), first)
    # Factors made under inference_mode (no version counter) are cached too.
    with torch.inference_mode():
        ur3, ui3 = ur.clone(), ui.clone()
        assert fft_cuda.uh_stacked(ur3, ui3) is fft_cuda.uh_stacked(ur3, ui3)
    assert torch.equal(fft_cuda.uh_stacked(ur3, ui3), ue)


@pytest.mark.parametrize("shape,m", SHAPES)
def test_kernel2_bf16x3_matches_jax(shape, m):
    """Kernel 2's bf16x3 arithmetic, behind kernel 1's (``contract_tc_emulated``)
    and the W-axis middle, against JAX ``_fwd_core`` in interpret mode on
    the same bf16 x (the XLA low-rank op where Pallas cannot tile): within
    FWD_BF16 of max|reference| at every shape, the whole-spectrum one
    included. One pass of TF32 misses there (|z| is a small difference of
    large terms): its error is printed."""
    b, h, w, c = shape
    x_np = _rand(shape, 7)
    x = torch.from_numpy(x_np).bfloat16()
    vr_t, vi_t, uhr, uhi, uwr, uwi, vwr, vwi = fft_cuda.factor_tensors(
        h, w, m, torch.bfloat16, CPU)
    x3 = x.view(b, h, w * c)
    tr, ti = contract_tc_emulated(x3, vr_t, vi_t)
    s_r, s_i = fft_cuda.w_axis_middle(tr, ti, uwr, uwi, vwr, vwi, w, c)
    got = expand_bf16x3_emulated(x3, uhr, uhi, s_r, s_i)
    tf32 = expand_tf32_emulated(x3, uhr, uhi, s_r, s_i)
    twin = fft_cuda.highpass_expand_plain(x3, uhr, uhi, s_r, s_i)
    assert got.dtype == torch.bfloat16 and got.shape == x3.shape
    xj = jnp.asarray(x_np, jnp.bfloat16)
    if fp.pallas_supported(shape):
        want = fp._fwd_core(xj, *fp._fwd_factor_args(xj, m), m, True)[0]
    else:
        want = jax_lowrank(xj, m)
    want = np.asarray(want, np.float32).reshape(b, h, w * c)
    e_x3 = _rel_max(got.float().numpy(), want)
    e_tf32 = _rel_max(tf32.float().numpy(), want)
    e_twin = _rel_max(got.float().numpy(), twin.float().numpy())
    print(f"kernel 2 {shape}: bf16x3 vs JAX rel-max {e_x3:.3e}, vs the f32 twin {e_twin:.3e}; "
          f"one-pass TF32 vs JAX {e_tf32:.3e}")
    assert e_x3 <= FWD_BF16 and e_twin <= FWD_BF16


@pytest.mark.parametrize("shape,m", SHAPES)
def test_kernel3_split_matches_twin_and_jax(shape, m):
    """Kernel 3's arithmetic (rebuild in bf16x6, T in bf16x3) against its f32
    twin on the same bf16 x and g and the same saved spectrum: T within
    T_REL of max|T|, Re u within BWD_BF16 in relative L2. The T error of a
    bf16x3 rebuild is printed: near pixels where |z| is small, u = g z/|z|
    turns with z's error, and that rebuild's 2^-16 moves T by up to 2e-4 of
    max|T| at (2,256,256,8), over the bound. Then the whole backward chain
    (kernel 3 emulated, the adjoint middle, kernel 4's TF32 emulated)
    against JAX ``_highpass_bwd_pallas``: dx within BWD_BF16 in relative L2.
    Where the mask keeps the whole spectrum (2m >= H and W, the first
    shape) the exact z is 0 and z, u, T and dx are f32 rounding noise,
    which the f32 twin's own summation order moves by more than 50%
    (tests/test_torch_port_highpass_tc.py): there u's magnitude is held
    (|Re u| <= |g|) and dx relative to |Re u|, as for kernel 4."""
    b, h, w, c = shape
    x_np, g_np = _rand(shape, 8), _rand(shape, 9)
    x, g = torch.from_numpy(x_np).bfloat16(), torch.from_numpy(g_np).bfloat16()
    _, s_r, s_i = fft_cuda.highpass_fwd(x, m)
    vr_t, vi_t, uhr, uhi, uwr, uwi, vwr, vwi = fft_cuda.factor_tensors(
        h, w, m, torch.float32, CPU)
    x3, g3 = x.view(b, h, w * c), g.view(b, h, w * c)
    u_e, tr_e, ti_e = bwd_contract_split_emulated(x3, g3, uhr, uhi, s_r, s_i)
    _, tr_3, ti_3 = bwd_contract_split_emulated(x3, g3, uhr, uhi, s_r, s_i, BF16X3)
    u_p, tr_p, ti_p = fft_cuda.highpass_bwd_contract_plain(x3, g3, uhr, uhi, s_r, s_i)
    assert u_e.dtype == torch.bfloat16 and tr_e.shape == tr_p.shape

    def t_err(tr, ti):
        return max(_rel_max(tr.numpy(), tr_p.numpy()), _rel_max(ti.numpy(), ti_p.numpy()))

    e_t, e_t3 = t_err(tr_e, ti_e), t_err(tr_3, ti_3)
    e_u = _rel_l2(u_e.float().numpy(), u_p.float().numpy())

    r_r, r_i = fft_cuda.w_axis_middle(tr_e, ti_e, vwr.T, vwi.T, uwr.T, uwi.T, w, c)
    dx = bwd_expand_tf32_emulated(u_e, vr_t, vi_t, r_r, r_i).float().numpy()
    xj, gj = jnp.asarray(x_np, jnp.bfloat16), jnp.asarray(g_np, jnp.bfloat16)
    want = fp._highpass_bwd_pallas(xj, jnp.asarray(s_r.numpy()), jnp.asarray(s_i.numpy()), gj,
                                   m, True)
    want = np.asarray(want, np.float32).reshape(b, h, w * c)
    e_dx = _rel_l2(dx, want)
    e_dx_u = float(np.linalg.norm(dx - want) / np.linalg.norm(u_p.float().numpy()))
    print(f"kernel 3 {shape}: T rel-max {e_t:.3e} (with a bf16x3 rebuild {e_t3:.3e}), Re u "
          f"rel-l2 {e_u:.3e}; chain dx vs JAX rel-l2 {e_dx:.3e} ({e_dx_u:.3e} of |Re u|)")
    assert e_dx_u <= BWD_BF16
    mm = min(m, h // 2, w // 2)
    if 2 * mm < h or 2 * mm < w:
        assert e_t <= T_REL and e_u <= BWD_BF16 and e_dx <= BWD_BF16
    else:
        # |Re u| <= |u| = |g|, up to Re u's rounding to bf16.
        assert (u_e.float().abs() <= g3.float().abs() * (1 + 2.0 ** -8)).all()


def test_kernel3_needs_the_bf16x6_rebuild():
    """Why kernel 3 rebuilds z in bf16x6: at (2,256,256,8), m = 20, a bf16x3
    rebuild (2^-16) turns u = g z/|z| near small |z| enough to move T by
    more than T_REL of max|T| against the f32 twin; the bf16x6 rebuild holds
    it, more than 10x inside."""
    shape, m = (2, 256, 256, 8), 20
    b, h, w, c = shape
    x = torch.from_numpy(_rand(shape, 8)).bfloat16()
    g = torch.from_numpy(_rand(shape, 9)).bfloat16()
    _, s_r, s_i = fft_cuda.highpass_fwd(x, m)
    _, _, uhr, uhi, *_ = fft_cuda.factor_tensors(h, w, m, torch.float32, CPU)
    x3, g3 = x.view(b, h, w * c), g.view(b, h, w * c)
    _, tr_p, ti_p = fft_cuda.highpass_bwd_contract_plain(x3, g3, uhr, uhi, s_r, s_i)
    err = {}
    for name, terms in (("bf16x3", BF16X3), ("bf16x6", BF16X6)):
        _, tr, ti = bwd_contract_split_emulated(x3, g3, uhr, uhi, s_r, s_i, terms)
        err[name] = max(_rel_max(tr.numpy(), tr_p.numpy()), _rel_max(ti.numpy(), ti_p.numpy()))
    print(f"kernel 3 T against the f32 twin at {shape} by the rebuild's arithmetic: {err}")
    assert err["bf16x3"] > T_REL and 10 * err["bf16x6"] <= T_REL
