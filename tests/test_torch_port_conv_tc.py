"""Kernel 6's float32 arithmetic on the tensor cores, on the CPU.

``conv3x3_kernel_tc`` (``csrc/conv3x3.cu``) takes a float32 convolution on
the bf16 tensor cores by splitting x and w into three bf16 pieces as it
stages them and taking each product as bf16x6, the six piece products
(``csrc/tc_bf16.cuh``). The kernel runs only on the card; here its
arithmetic, emulated in plain PyTorch (``tests/torch_port_helpers.py``), is
held to JAX ``conv3x3_pallas`` in interpret mode at the shapes of
``test_torch_port_edge.test_kernel6_twin_matches_jax_conv3x3_pallas``.

The card holds kernel 6 to ``CONV_TOL["float32"]`` = 1e-5 in relative L2
(``chip_smoke.py``). The emulation has to sit 10x inside that: on the card
the tensor cores truncate as they add into f32, and kernel 3's T read up to
5x its emulated error there (``PERF.md``). bf16x6 does; bf16x3, the next
cheaper split, does not.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eelunet_tpu.ops.conv_pallas import conv3x3_pallas
from torch_port_helpers import BF16X3, BF16X6, conv3x3_split_emulated

CONV_TOL = 1e-5   # chip_smoke.py CONV_TOL["float32"]
MARGIN = 10.0     # how far inside it the emulation must sit
CASES = [(3, 32, True, False), (64, 64, True, True), (128, 64, False, True),
         (64, 16, False, False)]


def _case(cin, cout, affine):
    rng = np.random.default_rng(cin + cout)
    x = rng.standard_normal((2, 16, 24, cin), dtype=np.float32)
    w = rng.standard_normal((3, 3, cin, cout), dtype=np.float32) * 0.1
    scale = rng.standard_normal(cout, dtype=np.float32) if affine else None
    shift = rng.standard_normal(cout, dtype=np.float32) if affine else None
    return x, w, scale, shift


def _jax(x, w, scale, shift, relu):
    return np.asarray(conv3x3_pallas(
        jnp.asarray(x), jnp.asarray(w), None if scale is None else jnp.asarray(scale),
        None if shift is None else jnp.asarray(shift), relu=relu, tile_h=8, interpret=True),
        np.float64)


def _emulated(x, w, scale, shift, relu, terms):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    return conv3x3_split_emulated(t(x), t(w), t(scale), t(shift), relu, terms).double().numpy()


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("cin,cout,affine,relu", CASES)
def test_kernel6_bf16x6_matches_jax_conv3x3_pallas(cin, cout, affine, relu):
    x, w, scale, shift = _case(cin, cout, affine)
    want = _jax(x, w, scale, shift, relu)
    got = _emulated(x, w, scale, shift, relu, BF16X6)
    assert got.shape == want.shape == (2, 16, 24, cout)
    err = _rel_l2(got, want)
    print(f"kernel 6 bf16x6 emulated against JAX ({cin}->{cout}): rel-l2 {err:.2e}")
    assert err * MARGIN <= CONV_TOL


def test_kernel6_needs_bf16x6():
    """bf16x3 (two pieces, three products: 2^-16) sits within CONV_TOL but
    not 10x inside it, at every shape; bf16x6 (three pieces, six products,
    down to 2^-18) is over 10x better."""
    for cin, cout, affine, relu in CASES:
        x, w, scale, shift = _case(cin, cout, affine)
        want = _jax(x, w, scale, shift, relu)
        err3 = _rel_l2(_emulated(x, w, scale, shift, relu, BF16X3), want)
        err6 = _rel_l2(_emulated(x, w, scale, shift, relu, BF16X6), want)
        print(f"kernel 6 ({cin}->{cout}) rel-l2 against JAX: bf16x3 {err3:.2e}, "
              f"bf16x6 {err6:.2e}")
        assert err3 * MARGIN > CONV_TOL and err6 * 10 < err3
