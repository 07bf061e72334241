"""The port's W8A8 int8 quantization (``eelunet_tpu_torch/quantize.py``)
against the JAX package's jaxpr rewrite (``eelunet_tpu/quantize.py``): exact
int8 convs and dots on the int8 grid, the same eligible set (per-family op
counts), each family's quantized forward on the same weights, the int
product against its float64 twin, and the Predictor's wiring."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from eelunet_tpu.models.eelunet import EELUnet as JaxEELUnet
from eelunet_tpu.quantize import quantize_fn
from eelunet_tpu.registry import MODEL_REGISTRY as JAX_MODEL_REGISTRY
from eelunet_tpu.registry import seg_probabilities as jax_seg_probabilities
from eelunet_tpu_torch.config import ModelConfig
from eelunet_tpu_torch.inference import Predictor, random_state_dict
from eelunet_tpu_torch.models.convert import from_flax_variables
from eelunet_tpu_torch.nn.layers import nchw, nhwc
from eelunet_tpu_torch.ops.fft import high_pass_fft_lowrank
from eelunet_tpu_torch.prune_physical import save_slim
from eelunet_tpu_torch.quantize import (
    im2col_nhwc,
    int8_conv2d_plain,
    int8_mm_plain,
    quantize_activation,
    quantize_model,
    quantize_weight,
)
from eelunet_tpu_torch.registry import MODEL_REGISTRY, create_model, seg_probabilities
from torch_port_families import FAMILIES, family_input, family_variables, jax_model, port_model
from torch_port_helpers import CFG, MASK_RANGE, NARROW, narrow_flax_variables


def _grid(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.float32)


def test_quantized_conv_exact_on_grid():
    """Inputs on the int8 grid (s_x = s_k = 1) round-trip losslessly: the
    int8 conv equals JAX's ``quantize_fn`` conv and the float conv bit for
    bit (tests/test_quantize.py:26-44)."""
    rng = np.random.default_rng(0)
    x = _grid(rng, (1, 8, 8, 4))
    x.flat[0] = 127.0
    k = _grid(rng, (3, 3, 4, 6))
    k[0, 0, 0, :] = 127.0

    def conv(xx, kk):
        return jax.lax.conv_general_dilated(xx, kk, (1, 1), "SAME",
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    want = np.asarray(quantize_fn(conv)(jnp.asarray(x), jnp.asarray(k)))
    m = nn.Conv2d(4, 6, 3, padding=1, bias=False)
    m.weight.data = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    stats = {}
    q = quantize_model(nn.Sequential(m), stats=stats)
    with torch.no_grad():
        got = nhwc(q(nchw(torch.from_numpy(x)).contiguous(memory_format=torch.channels_last)))
    assert stats == {"quantized_convs": 1}
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.asarray(conv(jnp.asarray(x), jnp.asarray(k))))


def test_quantized_dot_exact_on_grid():
    """A Linear (JAX's dense-shaped ``dot_general``) on the grid, with array
    equality (tests/test_quantize.py:46-57)."""
    rng = np.random.default_rng(7)
    a = _grid(rng, (5, 16))
    a.flat[0] = 127.0
    b = _grid(rng, (16, 7))
    b[0, :] = 127.0
    want = np.asarray(quantize_fn(lambda x, w: x @ w)(jnp.asarray(a), jnp.asarray(b)))
    m = nn.Linear(16, 7, bias=False)
    m.weight.data = torch.from_numpy(np.ascontiguousarray(b.T))
    stats = {}
    with torch.no_grad():
        got = quantize_model(nn.Sequential(m), stats=stats)(torch.from_numpy(a))
    assert stats == {"quantized_dots": 1}
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, a @ b)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_conv_transpose_dot_equal_jax(seed):
    """Off the grid, with biases, strides, dilation and a 2x2 stride-2
    transposed conv: the int8 ops equal JAX's rewrite of the same flax
    modules to the bit (the scales, rounding and dequantization are one
    computation in both)."""
    import flax.linen as fnn

    rng = np.random.default_rng(seed)
    cases = [
        (fnn.Conv(6, (3, 3), strides=(2, 2), padding=[(2, 2), (2, 2)], kernel_dilation=(2, 2)),
         nn.Conv2d(5, 6, 3, stride=2, padding=2, dilation=2), "conv"),
        (fnn.ConvTranspose(6, (2, 2), strides=(2, 2), padding="VALID"),
         nn.ConvTranspose2d(5, 6, 2, stride=2), "convt"),
        (fnn.Dense(6), nn.Linear(9, 6), "dense"),  # contracts over 9 >= 8
    ]
    for fm, tm, kind in cases:
        x = rng.standard_normal((2, 8, 8, 9 if kind == "dense" else 5)).astype(np.float32)
        v = fm.init(jax.random.PRNGKey(seed), x)
        k = np.asarray(v["params"]["kernel"])
        bias = np.asarray(v["params"]["bias"])
        v = {"params": {"kernel": jnp.asarray(k), "bias": jnp.asarray(bias + 0.1)}}
        stats = {}
        want = np.asarray(quantize_fn(lambda xx: fm.apply(v, xx), stats=stats)(jnp.asarray(x)))
        if kind == "conv":
            tm.weight.data = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        elif kind == "convt":  # flipped HWIO -> (I, O, kh, kw), as models/convert.py
            tm.weight.data = torch.from_numpy(np.ascontiguousarray(
                k[::-1, ::-1].transpose(2, 3, 0, 1)))
        else:
            tm.weight.data = torch.from_numpy(np.ascontiguousarray(k.T))
        tm.bias.data = torch.from_numpy(bias + 0.1)
        ours = {}
        q = quantize_model(nn.Sequential(tm), stats=ours)
        with torch.no_grad():
            if kind == "dense":
                got = q(torch.from_numpy(x)).numpy()
            else:
                xt = nchw(torch.from_numpy(x)).contiguous(memory_format=torch.channels_last)
                got = nhwc(q(xt)).numpy()
        assert ours == stats and sum(stats.values()) == 1, (kind, ours, stats)
        np.testing.assert_array_equal(got, want, err_msg=kind)


def test_ineligible_ops_not_rewritten():
    """Depthwise and grouped convs, dots that contract over fewer than 8,
    batched contractions and the low-rank high-pass (JAX pins its matmuls
    to HIGHEST) run as they are: no op counted, the output unchanged."""
    torch.manual_seed(0)

    class Plain(nn.Module):
        def forward(self, x):  # batched matmul and the high-pass: tensor ops
            y = torch.einsum("bij,bjk->bik", x[:, 0], x[:, 1].transpose(1, 2))
            return y, high_pass_fft_lowrank(nhwc(x), MASK_RANGE)

    model = nn.Sequential(nn.Conv2d(4, 4, 3, padding=1, groups=4),
                          nn.Conv2d(4, 8, 3, padding=1, groups=2))
    dense = nn.Linear(7, 5)
    x = torch.randn(2, 4, 16, 16)
    stats = {}
    for m, inp in ((model, x), (dense, torch.randn(3, 7)), (Plain(), x)):
        q = quantize_model(m, stats=stats)
        with torch.no_grad():
            got, want = q(inp), m(inp)
        assert stats == {}, (m, stats)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w)


def test_int_mm_and_im2col_equal_float64_twins():
    """The int product: ``torch._int_mm`` (the card's route; it runs on the
    CPU too) against the float64 twin, and the im2col GEMM against the
    float64 conv twin, with ``torch.equal``, at the padded shapes the card
    sees (K = 27 of the first 3x3 conv on RGB, N = 1 of a head)."""
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (40, 32), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (16, 32), generator=g, dtype=torch.int8)
    assert torch.equal(torch._int_mm(a, b.t()), int8_mm_plain(a, b))
    for cin, cout, k, stride, pad, dil in ((3, 1, 3, 1, 1, 1), (5, 9, 3, 2, 2, 2),
                                           (6, 4, 7, 1, 9, 3), (8, 8, 1, 1, 0, 1)):
        xq = torch.randint(-127, 128, (2, cin, 13, 11), generator=g, dtype=torch.int8)
        wq = torch.randint(-127, 128, (cout, cin, k, k), generator=g, dtype=torch.int8)
        k8 = -(-(cin * k * k) // 8) * 8
        cols = im2col_nhwc(nhwc(xq).contiguous(), (k, k), (stride, stride), (pad, pad),
                           (dil, dil), k8)
        wmat = F.pad(wq.permute(0, 2, 3, 1).reshape(cout, -1), (0, k8 - cin * k * k))
        got = (cols.reshape(-1, k8).double() @ wmat.double().t()).to(torch.int32)
        want = int8_conv2d_plain(xq, wq, stride, pad, dil)
        assert torch.equal(got.view(*cols.shape[:3], cout), nhwc(want)), (cin, k, stride)
        assert torch.equal(torch._int_mm(cols.reshape(-1, k8), wmat.t()).view(
            *cols.shape[:3], cout), nhwc(want))


def test_scales_match_jax():
    """Activation and per-output-channel weight scales, and the rounding
    half to even, as JAX computes them."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 9)).astype(np.float32) * 3
    x[0, 0] = 0.5 * 3 * np.abs(x).max() / 127 * 127  # a value on a half step
    xq, xs = quantize_activation(torch.from_numpy(x))
    jxs = jnp.maximum(jnp.max(jnp.abs(x)) / 127.0, jnp.finfo(jnp.float32).tiny)
    assert float(xs) == float(jxs)
    np.testing.assert_array_equal(
        xq.numpy(), np.asarray(jnp.clip(jnp.round(x / jxs), -127, 127).astype(jnp.int8)))
    w = rng.standard_normal((6, 4, 3, 3)).astype(np.float32)
    w[2] = 0.0  # an all-zero channel takes the tiny floor
    wq, ws = quantize_weight(torch.from_numpy(w), 0)
    jws = np.maximum(np.abs(w).max(axis=(1, 2, 3)) / np.float32(127), np.finfo(np.float32).tiny)
    np.testing.assert_array_equal(ws.numpy(), jws.astype(np.float32))


def _jax_quantized(name):
    """(JAX model, variables, input, meta) of a test family; the narrow
    EELUnet on the low-rank high-pass."""
    if name == "eelunet":
        return (JaxEELUnet(mask_range=MASK_RANGE, widths=NARROW, highpass_impl="lowrank"),
                narrow_flax_variables(), family_input(batch=1), JAX_MODEL_REGISTRY[name])
    return jax_model(name), family_variables(name), family_input(batch=1), JAX_MODEL_REGISTRY[name]


def _port_model(name, variables):
    if name == "eelunet":
        model, _ = create_model(ModelConfig(name="eelunet", fft_mask_range=MASK_RANGE,
                                            highpass_impl="lowrank"), widths=NARROW)
        model = model.to(memory_format=torch.channels_last)
    else:
        model = port_model(name)
    model.load_state_dict(from_flax_variables(variables, name), strict=True)
    return model.eval()


# Each family's W8A8 forward against JAX's, probabilities. Both packages
# compute the same scales, roundings and int products (the tests above), so
# they differ only where the float ops around the int8 ones leave an
# activation a few ulps apart and one value rounds to the other side of a
# half step of its grid: that moves it by a whole step of s_x, and the ops
# after it carry the change. Measured on the CPU: U-Net++, UNeXt and
# MALUNet agree to 1e-7, U-Net to 1.4e-4, UNeXt-S to 4.3e-4, the narrow
# EELUnet to 2.2e-3 (one flip; mean 4e-6). EGE-UNet's float forwards are
# already 1.9e-5 apart (its bound in test_torch_port_families_forward.py is
# 5e-4), and its 2x2 deep stages of 6-12 channels compound the flips: the
# activation maxima of its 46 int8 ops agree to 2e-5 at the first ones and
# drift to 5% by the head, and its probabilities read 9.2e-2 apart (mean
# 9e-3), against 0.25 between its int8 and dense forwards in either package.
# It is held to the JAX package's own bound for a W8A8 family forward
# (tests/test_quantize.py:157), and its mean to 1.4e-2, between the 9.3e-3
# it reads and the 1.9e-2 mean between its int8 and dense forwards. Neither
# bound would see a slip confined to a few of its ops, so each of its int8
# ops is also held to JAX's at its own site, bit for bit
# (test_egeunet_int8_ops_at_their_sites_equal_jax).
QUANT_FORWARD_TOL = {"egeunet": 0.15}
QUANT_FORWARD_TOL_DEFAULT = 1e-2
QUANT_FORWARD_MEAN_TOL = {"egeunet": 1.4e-2}


@pytest.mark.parametrize("name", ("eelunet",) + FAMILIES)
def test_family_counts_and_forward_match_jax(name):
    jm, variables, x, jmeta = _jax_quantized(name)

    def fwd(xx):
        return jax_seg_probabilities(jm.apply(variables, xx, train=False), jmeta)

    jstats = {}
    jax.make_jaxpr(quantize_fn(fwd, stats=jstats))(jnp.asarray(x))
    want = np.asarray(jax.jit(quantize_fn(fwd))(jnp.asarray(x)))
    dense = np.asarray(jax.jit(fwd)(jnp.asarray(x)))

    model = _port_model(name, variables)
    stats = {}
    q = quantize_model(model, stats=stats)
    with torch.no_grad():
        xt = nchw(torch.from_numpy(x)).contiguous(memory_format=torch.channels_last)
        got = nhwc(seg_probabilities(q(xt), MODEL_REGISTRY[name])).numpy()
    assert stats == jstats and jstats.get("quantized_convs", 0) > 0, (stats, jstats)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= QUANT_FORWARD_TOL.get(name, QUANT_FORWARD_TOL_DEFAULT), err
    mean = float(np.abs(got - want).mean())
    assert mean <= QUANT_FORWARD_MEAN_TOL.get(name, QUANT_FORWARD_TOL_DEFAULT), mean
    # the rewrite changed the computation in both
    assert not np.array_equal(want, dense) and not np.array_equal(got, dense)


def test_egeunet_int8_ops_at_their_sites_equal_jax():
    """Every int8 op of the quantized EGE-UNet forward, on the activation it
    meets there (its deep 2x2 stages included), equals JAX's ``quantize_fn``
    of the same conv with the same float weights and bias, bit for bit: the
    family forward above can only bound the flips that compound between
    the ops."""
    from eelunet_tpu_torch.quantize import QuantConv2d

    _, variables, x, _ = _jax_quantized("egeunet")
    model = _port_model("egeunet", variables)
    q = quantize_model(model)
    seen = []
    for name, m in q.named_modules():
        if isinstance(m, QuantConv2d):
            m.register_forward_hook(lambda mod, a, out, name=name: seen.append(
                (name, a[0].numpy().copy(), out.numpy().copy())))
    with torch.no_grad():
        q(nchw(torch.from_numpy(x)).contiguous(memory_format=torch.channels_last))
    assert len(seen) == 46
    for name, xin, got in seen:
        m = model.get_submodule(name)
        assert m.groups == 1 and m.padding_mode == "zeros"
        w, b = jnp.asarray(m.weight.detach().numpy()), jnp.asarray(m.bias.detach().numpy())
        spatial = "HW"[:w.ndim - 2]
        dn = ("NC" + spatial, "OI" + spatial, "NC" + spatial)

        def conv(xx, m=m, w=w, b=b, dn=dn):
            y = jax.lax.conv_general_dilated(xx, w, m.stride, [(p, p) for p in m.padding],
                                             rhs_dilation=m.dilation, dimension_numbers=dn)
            return y + b.reshape((1, -1) + (1,) * (w.ndim - 2))

        stats = {}
        want = np.asarray(quantize_fn(conv, stats=stats)(jnp.asarray(xin)))
        assert stats == {"quantized_convs": 1}, (name, stats)
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_predictor_quantize_wiring(tmp_path):
    """``Predictor(quantize="int8")`` quantizes the served (folded) model:
    within JAX's 0.1 of the dense Predictor, not equal to it, its stats
    filled; an unknown mode raises (tests/test_quantize.py:160-177)."""
    with pytest.raises(ValueError, match="quantize"):
        Predictor(ModelConfig(name="unext_s"), quantize="int4", device="cpu")
    ckpt = save_slim(str(tmp_path / "slim"), random_state_dict(CFG, seed=0, widths=NARROW),
                     dict(NARROW), "eelunet")
    dense = Predictor(CFG, checkpoint=ckpt, bucket_batches=False, device="cpu")
    quant = Predictor(CFG, checkpoint=ckpt, bucket_batches=False, quantize="int8", device="cpu")
    u8 = np.random.default_rng(2).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    qp, dp = quant.predict_proba(u8), dense.predict_proba(u8)
    assert qp.shape == dp.shape == (2, 64, 64, 1)
    assert float(np.abs(qp - dp).max()) < 0.1
    assert not np.array_equal(qp, dp)
    assert quant.quant_stats["quantized_convs"] > 0 and quant.quant_stats["quantized_dots"] > 0
    folded = Predictor(ModelConfig(name="unext_s"), quantize="int8", device="cpu")
    assert not hasattr(folded.model, "ebn1")  # the folded model is the quantized one
