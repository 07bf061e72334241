"""The port's U-Net, U-Net++, UNeXt, UNeXt-S, EGE-UNet and MALUNet against
the JAX package's, on the same weights and inputs (tests/torch_port_families.py):
float32 on the CPU, 64x64, batch 2. Logit families are compared after the
sigmoid, and every aux map is compared too, within the EELUnet's bound of
tests/test_torch_port_eelunet.py."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from eelunet_tpu.registry import MODEL_REGISTRY as JAX_MODEL_REGISTRY
from eelunet_tpu.registry import seg_probabilities as jax_seg_probabilities
from eelunet_tpu_torch.models.convert import from_flax_variables
from eelunet_tpu_torch.nn.layers import nchw, nhwc
from eelunet_tpu_torch.registry import MODEL_REGISTRY, seg_probabilities
from torch_port_families import (
    FAMILIES,
    family_input,
    family_variables,
    jax_model,
    port_forward,
    port_model,
)


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_jax(name):
    variables = family_variables(name)
    x = family_input()
    jm = jax_model(name)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)
    model = port_model(name)
    model.load_state_dict(from_flax_variables(variables, name), strict=True)
    got = port_forward(model, x)
    meta = MODEL_REGISTRY[name]
    assert meta == JAX_MODEL_REGISTRY[name]
    p_got = nhwc(seg_probabilities(got, meta)).numpy()
    p_want = np.asarray(jax_seg_probabilities(want, JAX_MODEL_REGISTRY[name]))
    assert got.seg.dtype == torch.float32 and p_got.shape == p_want.shape == (2, 64, 64, 1)
    np.testing.assert_allclose(p_got, p_want, atol=5e-4, rtol=0)
    # not a constant map: the comparison means something
    assert p_want.std() > 1e-4
    if meta.seg_is_logits:  # the logits too, which the sigmoid flattens
        np.testing.assert_allclose(nhwc(got.seg).numpy(), np.asarray(want.seg),
                                   atol=5e-4, rtol=0)
    assert len(got.aux) == len(want.aux) == (5 if name == "egeunet" else 0)
    for g, w in zip(got.aux, want.aux):
        assert g.dtype == torch.float32 and tuple(g.shape) == (2, 1, 64, 64)
        np.testing.assert_allclose(nhwc(g).numpy(), np.asarray(w), atol=5e-4, rtol=0)



def test_bf16_norms_compute_in_float32():
    """A bf16 input to the port's norms is normalised in float32 with
    float32 statistics and parameters and rounded once, as flax's norms do
    with ``param_dtype=float32`` (``eelunet_tpu/nn/layers.py:208-253``)."""
    from eelunet_tpu_torch.nn.layers import BatchNorm2d, ChannelLayerNorm, GroupNorm4

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 5, 7, generator=g).bfloat16()
    for norm in (GroupNorm4(8), ChannelLayerNorm(8), ChannelLayerNorm(8, eps=1e-5),
                 BatchNorm2d(8)):
        for p in norm.parameters():
            p.data = torch.rand(p.shape, generator=g) + 0.5
        if isinstance(norm, BatchNorm2d):
            norm.running_var.uniform_(0.5, 1.5, generator=g)
            norm.running_mean.normal_(generator=g)
        norm.eval()
        want = norm(x.float()).bfloat16()
        got = norm.to(torch.bfloat16)(x)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, want), type(norm).__name__


def test_ghpa_maps_stay_float32_in_a_bf16_model():
    """EGE-UNet's GHPA maps keep float32 when the served model is cast to
    bf16, as flax keeps them (``param_dtype``), and its merged skips are
    float32, as the JAX model's float32 ``gt_pre`` makes them."""
    import dataclasses

    from eelunet_tpu_torch.config import ModelConfig
    from eelunet_tpu_torch.inference import build_serving_model
    from eelunet_tpu_torch.models.egeunet import GHPA

    sd = from_flax_variables(family_variables("egeunet"), "egeunet")
    cfg = ModelConfig(name="egeunet", dtype="bfloat16")
    model = build_serving_model(sd, cfg, "cpu")
    ghpas = [m for m in model.modules() if isinstance(m, GHPA)]
    assert len(ghpas) == 6
    for m in ghpas:
        assert {getattr(m, n).dtype for n in GHPA.MAPS} == {torch.float32}
        assert m.ldw[0].weight.dtype == torch.bfloat16
    assert torch.equal(model.encoder4[0].params_xy, sd["encoder4.0.params_xy"])
    merged = []
    model.decoder2.register_forward_hook(lambda mod, inp, out: merged.append(inp[0].dtype))
    with torch.inference_mode():
        out = model(nchw(torch.from_numpy(family_input())).to(torch.bfloat16))
    assert merged == [torch.float32] and out.seg.dtype == torch.float32
    f32 = build_serving_model(sd, dataclasses.replace(cfg, dtype="float32"), "cpu")
    assert f32.encoder4[0].params_xy.dtype == torch.float32
