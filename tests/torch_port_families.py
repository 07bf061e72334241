"""Shared fixtures of the tests/test_torch_port_families*.py files: the five
families other than the EELUnet, built in the JAX package and in the port
from the same weights, and paired train steps of the two packages.

U-Net and U-Net++ run narrow (their width tuples); UNeXt, UNeXt-S, EGE-UNet
and MALUNet at their published widths, which are already small. Weights
start from the port's seeded init with every constant tensor (norm affines,
BN statistics, zero biases, GHPA's maps of ones) replaced by seeded random
values, so that a mis-mapped or transposed tensor shows. They reach the JAX
model through the JAX package's own upstream importer
(``torch_port.port_state_dict``); U-Net++, which has no upstream layout,
starts from the flax init instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from eelunet_tpu.config import LossConfig as JaxLossConfig
from eelunet_tpu.config import ModelConfig as JaxModelConfig
from eelunet_tpu.config import OptimizerConfig as JaxOptimizerConfig
from eelunet_tpu.models.torch_port import port_state_dict
from eelunet_tpu.models.unet import Unet as JaxUnet
from eelunet_tpu.models.unetpp import UnetPlusPlus as JaxUnetPlusPlus
from eelunet_tpu.registry import MODEL_REGISTRY as JAX_MODEL_REGISTRY
from eelunet_tpu.registry import create_model as jax_create_model
from eelunet_tpu.train import trainer as jax_trainer
from eelunet_tpu.train.state import TrainState as JaxTrainState
from eelunet_tpu.train.state import build_optimizer as jax_build_optimizer
from eelunet_tpu_torch import losses as L
from eelunet_tpu_torch.config import LossConfig, ModelConfig, OptimizerConfig
from eelunet_tpu_torch.models.convert import from_flax_variables, to_upstream_state_dict
from eelunet_tpu_torch.models.unet import Unet
from eelunet_tpu_torch.models.unetpp import UnetPlusPlus
from eelunet_tpu_torch.nn.layers import init_weights, nchw
from eelunet_tpu_torch.registry import MODEL_REGISTRY, create_model
from eelunet_tpu_torch.train.state import TrainState, build_optimizer
from eelunet_tpu_torch.train.trainer import make_loss_fn, make_train_step

FAMILIES = ("unet", "unet++", "unext", "unext_s", "egeunet", "malunet")
UNET_NARROW = dict(enc_widths=((8, 8), (16, 16), (16, 16), (32, 32)),
                   bottleneck_widths=(32, 32), up_widths=(16, 16, 8, 8),
                   dec_widths=((16, 16), (16, 16), (8, 8), (8, 8)))
UNETPP_NARROW = dict(features=(8, 8, 16, 16, 32))
HW = 64  # EGE-UNet and MALUNet need a multiple of 32
LR = 1e-4


def jax_model(name: str, in_channels: int = 3):
    """The JAX module of a test family (flax infers the input channels)."""
    if name == "unet":
        return JaxUnet(**UNET_NARROW)
    if name == "unet++":
        return JaxUnetPlusPlus(**UNETPP_NARROW)
    return jax_create_model(JaxModelConfig(name=name))[0]


def port_model(name: str, in_channels: int = 3) -> torch.nn.Module:
    """The port module of a test family, float32, channels_last."""
    if name == "unet":
        model = Unet(in_channels, **UNET_NARROW)
    elif name == "unet++":
        model = UnetPlusPlus(in_channels, **UNETPP_NARROW)
    else:
        model = create_model(ModelConfig(name=name, in_channels=in_channels))[0]
    return model.to(memory_format=torch.channels_last)


def randomise_constants(sd, seed: int):
    """Replace every constant float tensor of a ``state_dict`` by seeded
    random values: scales, variances and GHPA maps in [0.5, 1.5], the rest
    N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        if v.is_floating_point() and bool((v == v.reshape(-1)[0]).all()):
            if k.endswith((".weight", ".running_var")) or ".params_" in k:
                a = rng.uniform(0.5, 1.5, v.shape)
            else:
                a = rng.standard_normal(v.shape) * 0.1
            v = torch.from_numpy(a.astype(np.float32))
        out[k] = v
    return out


def family_variables(name: str, seed: int = 0, in_channels: int = 3):
    """Flax variables (numpy trees) of a test family; see the module
    docstring."""
    if name == "unet++":
        x = jnp.zeros((1, HW, HW, in_channels), jnp.float32)
        v = jax.jit(jax_model(name).init)(jax.random.PRNGKey(seed), x)
        return jax.tree_util.tree_map(np.asarray, v)
    model = init_weights(port_model(name, in_channels), torch.Generator().manual_seed(seed))
    sd = randomise_constants(model.state_dict(), seed)
    return port_state_dict(name, to_upstream_state_dict(sd, name))


def family_input(seed: int = 0, batch: int = 2, in_channels: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (batch, HW, HW, in_channels)).astype(np.float32)


def family_labels(seed: int = 0, batch: int = 2) -> np.ndarray:
    """Binary NHWC masks: a seeded random disc per sample."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:HW, :HW]
    out = np.zeros((batch, HW, HW, 1), np.float32)
    for b in range(batch):
        cy, cx, r = rng.uniform(16, HW - 16), rng.uniform(16, HW - 16), rng.uniform(6, 14)
        out[b, ..., 0] = ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r)
    return out


def port_forward(model, x_nhwc: np.ndarray):
    with torch.inference_mode():
        return model.eval()(nchw(torch.from_numpy(x_nhwc)).contiguous(
            memory_format=torch.channels_last))


def paired_family_steps(name: str, variables, batches, lr: float = LR):
    """Paired float32 train steps of a family from the same weights, one
    per (image, label) numpy batch, on the family's ``auto`` loss: the JAX
    package's jitted step and the port's. Returns (JAX losses, port losses,
    JAX final state as a port ``state_dict``, port final ``state_dict``)."""
    loss_name = L.resolve_loss_name("auto", name)
    jm = jax_model(name)
    loss_fn = jax_trainer.make_loss_fn(loss_name, JaxLossConfig(), JAX_MODEL_REGISTRY[name])
    stats = variables.get("batch_stats", {})
    step = jax_trainer.make_train_step(jm, loss_fn, bool(stats), donate=False)
    tx = jax_build_optimizer(JaxOptimizerConfig(lr=lr), len(batches))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = JaxTrainState(params=params, batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                           opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
                           rng=jax.random.PRNGKey(0), tx=tx)
    loss_j = []
    for x, y in batches:
        jstate, loss, _ = step(jstate, jnp.asarray(x), jnp.asarray(y))
        loss_j.append(float(loss))
    want = from_flax_variables({"params": jax.device_get(jstate.params),
                                "batch_stats": jax.device_get(jstate.batch_stats)}, name)

    model = port_model(name)
    model.load_state_dict(from_flax_variables(variables, name), strict=True)
    opt, sched = build_optimizer(OptimizerConfig(lr=lr), model.parameters(), len(batches))
    pstate = TrainState(model, opt, sched, seed=0)
    pstep = make_train_step(make_loss_fn(loss_name, LossConfig(), MODEL_REGISTRY[name]))
    loss_t = []
    for x, y in batches:
        loss, ok = pstep(pstate, torch.from_numpy(x), torch.from_numpy(y))
        assert ok
        loss_t.append(float(loss))
    return np.array(loss_j), np.array(loss_t), want, model.state_dict()
