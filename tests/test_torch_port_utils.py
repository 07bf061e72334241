"""The port's utilities against the JAX package's: ``utils/summary.py``
(parameter counts and the table; ``cli.train --summary``) and
``utils/flops.py`` (the forward FLOPs of every family, the FLOPs of train
steps, the peak table and MFU).

Parameter counts are compared at full width without weights: JAX's
variables through ``jax.eval_shape``, the port's model on the meta device.
FLOPs are counted by each package's own counter: JAX's walks the jaxpr, the
port's runs ``FlopCounterMode`` (on the meta device for the forwards)."""

from __future__ import annotations

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eelunet_tpu.config import LossConfig as JaxLossConfig
from eelunet_tpu.config import ModelConfig as JaxModelConfig
from eelunet_tpu.config import OptimizerConfig as JaxOptimizerConfig
from eelunet_tpu.models.eelunet import EELUnet as JaxEELUnet
from eelunet_tpu.registry import MODEL_REGISTRY as JAX_MODEL_REGISTRY
from eelunet_tpu.registry import create_model as jax_create_model
from eelunet_tpu.train import trainer as jax_trainer
from eelunet_tpu.train.state import TrainState as JaxTrainState
from eelunet_tpu.train.state import build_optimizer as jax_build_optimizer
from eelunet_tpu.utils import flops as JF
from eelunet_tpu.utils.summary import param_count as jax_param_count
from eelunet_tpu_torch import losses as L
from eelunet_tpu_torch.config import LossConfig, ModelConfig, OptimizerConfig
from eelunet_tpu_torch.models.convert import from_flax_variables
from eelunet_tpu_torch.ops import fft_cuda
from eelunet_tpu_torch.registry import MODEL_REGISTRY, create_model
from eelunet_tpu_torch.train.state import TrainState, build_optimizer
from eelunet_tpu_torch.train.trainer import make_loss_fn, make_train_step
from eelunet_tpu_torch.utils import flops as F
from eelunet_tpu_torch.utils.summary import model_summary, param_count
from eelunet_tpu_torch.nn.layers import nchw
from torch_port_families import family_variables, jax_model, port_model
from torch_port_helpers import CFG, MASK_RANGE, NARROW, narrow_flax_variables

FAMILIES = ("eelunet", "unet", "unet++", "unext", "unext_s", "egeunet", "malunet")
# Forward FLOPs: both packages count whole numbers of multiply-adds.
FLOPS_REL = 1e-9


# ------------------------------------------------------------------ summary

@pytest.mark.parametrize("name", FAMILIES)
def test_param_count_matches_jax_at_full_width(name):
    """``param_count`` of the full-width model (meta device) equals JAX's
    ``param_count`` of its ``eval_shape`` variables; ``model_summary``'s
    last line is that total."""
    jm, _ = jax_create_model(JaxModelConfig(name=name))
    variables = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, 64, 64, 3))),
                               jax.random.PRNGKey(0))
    model, _ = create_model(ModelConfig(name=name), device="meta")
    n = param_count(model)
    assert n == jax_param_count(variables)
    assert model_summary(model, (1, 3, 64, 64)).splitlines()[-1] == f"Total params: {n:,}"


def test_model_summary_table_runs_on_meta_and_leaves_the_model_alone():
    """The table of the narrow EELUnet: one row per call of each module to
    ``depth`` levels with its output shape and parameters, in call order; the
    model's own weights are not touched (the copy lives on the meta device)."""
    model, _ = create_model(CFG, widths=NARROW)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    table = model_summary(model, (1, 3, 32, 32), depth=1)
    rows = {line.split()[0]: line for line in table.splitlines()[2:-2]}
    assert "(1, 8, 32, 32)" in rows["enc1"] and "MlpConvBlock" in rows["enc3"]
    assert rows["enc1"].split()[-1] == f"{param_count(model.enc1):,}"
    assert list(rows)[1] == "enc1" and list(rows)[-1] == "(output)"
    assert not any("." in r for r in rows)  # depth 1: the children only
    deeper = model_summary(model, (1, 3, 32, 32), depth=2)
    assert any(line.startswith("enc1.") for line in deeper.splitlines())
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())
    assert next(model.parameters()).device.type == "cpu"


def test_cli_train_summary_prints_the_table_and_trains(tmp_path, monkeypatch):
    """``cli.train --summary --device cpu`` (the narrow EELUnet) prints the
    table after the Trainer is built, then trains; JAX's flag is the same."""
    import eelunet_tpu_torch.train.trainer as T
    from eelunet_tpu_torch.cli import train as train_cli
    from eelunet_tpu_torch.data.synthetic import write_synthetic_tree

    orig = T.create_model
    monkeypatch.setattr(T, "create_model", lambda cfg, **kw: orig(cfg, **{**kw, "widths": NARROW}))
    tree = write_synthetic_tree(str(tmp_path / "tree"), n_train=4, n_test=2, image_size=(32, 32))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_cli.main(["--device", "cpu", "--model_type", "eelunet", "--data_dir", tree,
                        "--image_size", "32", "--batch_size", "2", "--epochs", "1", "--seed",
                        "0", "--set", f"model.fft_mask_range={MASK_RANGE}", "--set",
                        "data.num_workers=1", "--save_dir", str(tmp_path / "ck"), "--log_dir",
                        str(tmp_path / "runs"), "--summary"])
    text = out.getvalue()
    n = param_count(create_model(CFG, widths=NARROW)[0])
    assert f"Total params: {n:,}" in text
    assert text.index("Total params") < text.index("Epoch [1/1]")
    assert "kernel launches: " in text


# -------------------------------------------------------------------- flops

@pytest.mark.parametrize("name", FAMILIES)
def test_forward_flops_match_jax(name):
    """``model_forward_flops`` of every family at 64^2 equals JAX's
    ``model_forward_flops`` (transposed convs counted as XLA's dilated-input
    convs, the EELUnet's high-pass as its low-rank contractions)."""
    want = JF.model_forward_flops(name, 64, batch=1)
    assert F.model_forward_flops(name, 64, batch=1) == pytest.approx(want, rel=FLOPS_REL)


def _invisible_kernels(monkeypatch):
    """Stand-ins for the four CUDA kernels: their plain twins, run with the
    dispatch modes off, so that ``FlopCounterMode`` sees none of their work,
    as it sees none of a ctypes-bound kernel's."""
    from torch.utils._python_dispatch import _disable_current_modes

    for name in ("highpass_contract", "highpass_expand", "highpass_bwd_contract",
                 "highpass_bwd_expand"):
        plain = getattr(fft_cuda, f"{name}_plain")

        def hidden(*args, plain=plain, name=name):
            with _disable_current_modes():
                out = plain(*args)
            fft_cuda.LAUNCHES[name] += 1
            return out

        monkeypatch.setattr(fft_cuda, name, hidden)


@pytest.mark.parametrize("route", ["kernels", "twins", "lowrank"])
def test_eelunet_highpass_is_counted_as_lowrank_on_every_route(route, monkeypatch):
    """The EELUnet's count does not depend on the high-pass route: on the
    kernel route (the kernels invisible to the counter), on the plain twins
    and on ``lowrank``, forward and train step, at 64^2."""
    impl = "lowrank" if route == "lowrank" else "auto"
    if route == "kernels":
        _invisible_kernels(monkeypatch)
    fft_cuda.reset_launches()
    model, _ = create_model(ModelConfig(name="eelunet", highpass_impl=impl), device="meta")
    model.eval().requires_grad_(False)
    fwd = F.count_matmul_flops(model, torch.zeros((1, 3, 64, 64), device="meta"))
    assert fwd == pytest.approx(JF.model_forward_flops("eelunet", 64), rel=FLOPS_REL)
    assert fft_cuda.LAUNCHES["highpass_contract"] == (2 if route == "kernels" else 0)

    narrow, _ = create_model(dataclasses.replace(CFG, highpass_impl=impl), widths=NARROW)
    x, y = _small_batch()
    step = F.count_matmul_flops(lambda: _port_step("eelunet", narrow, x, y))
    lowrank, _ = create_model(dataclasses.replace(CFG, highpass_impl="lowrank"), widths=NARROW)
    assert step == pytest.approx(F.count_matmul_flops(
        lambda: _port_step("eelunet", lowrank, x, y)), rel=FLOPS_REL)
    if route == "kernels":
        assert fft_cuda.LAUNCHES["highpass_bwd_expand"] == 2


def _small_batch():
    """NHWC images and binary labels of the train-step counts, 32^2 batch 2."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    y = (rng.uniform(size=(2, 32, 32, 1)) > 0.7).astype(np.float32)
    return x, y


def _port_step(name, model, x, y):
    """One port train step of ``model`` on NHWC numpy ``x`` and ``y``."""
    loss_name = L.resolve_loss_name("auto", name)
    opt, sched = build_optimizer(OptimizerConfig(lr=1e-4), model.parameters(), 1)
    state = TrainState(model.to(memory_format=torch.channels_last), opt, sched, seed=0)
    step = make_train_step(make_loss_fn(loss_name, LossConfig(), MODEL_REGISTRY[name]))
    loss, ok = step(state, torch.from_numpy(x), torch.from_numpy(y))
    assert ok and bool(torch.isfinite(loss))


def _jax_step_flops(name, jm, variables, x, y):
    loss_name = L.resolve_loss_name("auto", name)
    loss_fn = jax_trainer.make_loss_fn(loss_name, JaxLossConfig(), JAX_MODEL_REGISTRY[name])
    stats = variables.get("batch_stats", {})
    step = jax_trainer.make_train_step(jm, loss_fn, bool(stats), donate=False)
    tx = jax_build_optimizer(JaxOptimizerConfig(lr=1e-4), 1)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JaxTrainState(params=params, batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                          opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
                          rng=jax.random.PRNGKey(0), tx=tx)
    return JF.count_matmul_flops(step, state, jnp.asarray(x), jnp.asarray(y))


# A train step: the port's backward follows JAX's transposition rules
# (utils/flops.py), so the counts agree exactly; a relative 1e-6 leaves
# room for nothing but float rounding of the sums.
STEP_REL = 1e-6


@pytest.mark.parametrize("name", ["unext_s", "eelunet"])
def test_train_step_flops_match_jax(name):
    """``count_matmul_flops`` of one port train step (forward, backward,
    Adam) equals JAX's count of its own step from the same weights: UNeXt-S
    at published width and the narrow EELUnet, 32^2 batch 2."""
    x, y = _small_batch()
    if name == "eelunet":
        variables = narrow_flax_variables()
        jm = JaxEELUnet(widths=NARROW, mask_range=MASK_RANGE)
        model, _ = create_model(CFG, widths=NARROW)
    else:
        variables = family_variables(name)
        jm, model = jax_model(name), port_model(name)
    want = _jax_step_flops(name, jm, variables, x, y)
    model.load_state_dict(from_flax_variables(variables, name), strict=True)
    got = F.count_matmul_flops(lambda: _port_step(name, model, x, y))
    assert got == pytest.approx(want, rel=STEP_REL)
    # a step is a forward and about twice its work again
    with torch.no_grad():
        fwd = F.count_matmul_flops(model.eval(), nchw(torch.from_numpy(x)))
    assert 2.5 < got / fwd < 3.5


def test_flops_of_a_transposed_conv_follow_xla():
    """A stride-2 2x2 transposed conv counts its output elements (XLA's
    dilated-input conv), and its backward as JAX transposes it."""
    conv = torch.nn.ConvTranspose2d(8, 4, 2, stride=2)
    x = torch.zeros((2, 8, 5, 5), requires_grad=True)
    fwd = F.count_matmul_flops(lambda: conv(x))
    assert fwd == 2 * (2 * 4 * 10 * 10) * 4 * 8
    both = F.count_matmul_flops(lambda: conv(x).sum().backward())
    # input gradient: a strided conv onto x's elements; weight gradient: as the forward
    assert both == fwd + 2 * (2 * 8 * 5 * 5) * 4 * 4 + fwd


def test_peak_table_and_mfu(monkeypatch):
    """The H100 SXM's dense bf16 peak; the longest matching name wins; an
    unknown card has none; MFU is JAX's formula."""
    assert F.peak_flops_for("NVIDIA H100 80GB HBM3") == 989e12
    assert F.peak_flops_for("nvidia h100 80gb hbm3") == 989e12
    assert F.peak_flops_for("TPU v5e") is None and F.peak_flops_for("Quantum Abacus") is None
    monkeypatch.setitem(F.PEAK_BF16_FLOPS, "NVIDIA H100", 1.0)
    assert F.peak_flops_for("NVIDIA H100 80GB HBM3") == 989e12
    assert F.peak_flops_for("NVIDIA H100 NVL") == 1.0
    assert F.mfu_pct(100.0, 1e12, "NVIDIA H100 80GB HBM3") == pytest.approx(100 * 1e14 / 989e12)
    assert F.mfu_pct(100.0, 1e12, "???") is None
    kind = "NVIDIA H100 80GB HBM3"
    monkeypatch.setitem(JF.PEAK_BF16_FLOPS, kind, 989e12)  # JAX's formula on the same peak
    assert F.mfu_pct(271.7, 586.6e9, kind) == pytest.approx(JF.mfu_pct(271.7, 586.6e9, kind))
