"""The port's losses, metrics and optimizer against the JAX package's, on
the same seeded inputs (numpy), on the CPU."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eelunet_tpu import losses as jax_losses
from eelunet_tpu import metrics as jax_metrics
from eelunet_tpu.config import OptimizerConfig as JaxOptimizerConfig
from eelunet_tpu.data.synthetic import make_blob_sample
from eelunet_tpu.train.state import build_optimizer as jax_build_optimizer
from eelunet_tpu_torch import losses, metrics
from eelunet_tpu_torch.config import LossConfig, OptimizerConfig
from eelunet_tpu_torch.train.state import build_optimizer, clip_by_global_norm

B, H = 2, 32
AUX_SIZES = (H // 16, H // 8, H // 4, H // 2, H)


def _probs(rng, size, kind):
    p = rng.uniform(0.02, 0.98, (B, size, size, 1)).astype(np.float32)
    if kind == "saturated":  # exact 0 and 1, where the -100 clamp and the 1e-12 floor act
        p[rng.uniform(size=p.shape) < 0.2] = 0.0
        p[rng.uniform(size=p.shape) < 0.2] = 1.0
    return p


def _masks(rng, size, n=B):
    return np.stack([make_blob_sample(rng, size, size)[1] for _ in range(n)]).astype(np.float32)


@pytest.mark.parametrize("kind", ["binary", "soft", "saturated"])
def test_edge_bce_dice_matches_jax(kind):
    rng = np.random.default_rng(0)
    out = _probs(rng, H, kind)
    aux = [_probs(rng, s, kind) for s in AUX_SIZES]
    target = _masks(rng, H)
    if kind == "soft":
        target = np.clip(target * 0.8 + rng.uniform(0, 0.2, target.shape), 0, 1).astype(np.float32)
    cfg = LossConfig(lambda_edge=0.7)

    def jax_fn(a, o):
        return jax_losses.edge_bce_dice_loss(a, o, jnp.asarray(target), lambda_edge=0.7)

    want, (want_ga, want_go) = jax.value_and_grad(jax_fn, argnums=(0, 1))(
        [jnp.asarray(a) for a in aux], jnp.asarray(out))

    a_t = [torch.from_numpy(a).requires_grad_(True) for a in aux]
    o_t = torch.from_numpy(out).requires_grad_(True)
    got = losses.LOSS_REGISTRY["edge_bce_dice"](a_t, o_t, torch.from_numpy(target), cfg)
    grads = torch.autograd.grad(got, [o_t, *a_t])
    assert got.dtype == torch.float32
    # float32 sums of a few thousand terms in another order
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for g, w in zip(grads, [want_go, *want_ga]):
        w = np.asarray(w)
        # the saturated case has gradients up to ~1e12 * weight/N beside O(1e-4)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6 * np.abs(w).max())


def test_metrics_match_jax():
    rng = np.random.default_rng(1)
    acc_t = acc_j = None
    for _ in range(2):  # two batches, summed in the accumulator
        labels = _masks(rng, 64, 3)
        probs = np.clip(labels * 0.7 + rng.uniform(0, 0.5, labels.shape), 0, 1).astype(np.float32)
        probs[1] = rng.uniform(size=probs[1].shape)  # one noisy prediction
        bt = metrics.update_metrics(torch.from_numpy(probs), torch.from_numpy(labels))
        bj = jax_metrics.update_metrics(jnp.asarray(probs), jnp.asarray(labels))
        acc_t = bt if acc_t is None else acc_t + bt
        acc_j = bj if acc_j is None else acc_j + bj
    got = metrics.finalize_metrics(acc_t)
    want = jax_metrics.finalize_metrics(acc_j)
    assert tuple(got) == metrics.METRIC_NAMES == jax_metrics.METRIC_NAMES
    assert 0.0 < float(want["boundary_f1"]) < 1.0
    for k in metrics.METRIC_NAMES:
        assert abs(float(got[k]) - float(want[k])) <= 1e-6, k


def test_out_of_scope_raise():
    """Every criterion of the JAX package is ported (the multi-class ones
    and ``focal``, ``edge_dice``, ``edge_bce`` are held to JAX in
    tests/test_torch_port_multiclass.py); a name outside the registry is a
    KeyError, as in JAX."""
    assert set(losses.LOSS_REGISTRY) == set(jax_losses.LOSS_REGISTRY)
    with pytest.raises(KeyError):
        losses.LOSS_REGISTRY["nope"]
    assert losses.resolve_loss_name("auto", "eelunet") == "edge_bce_dice"


# (optimizer, lr_schedule, grad_clip_norm): Adam + StepLR is the reference's;
# the others are the JAX package's options.
OPTIMIZERS = [("adam", "step", 0.0), ("sgd", "step", 0.0), ("adam", "cosine", 0.0),
              ("adam", "constant", 0.0), ("adam", "step", 0.05)]


@pytest.mark.parametrize("name,schedule,clip", OPTIMIZERS)
def test_optimizer_trajectory_matches_optax(name, schedule, clip):
    """A toy parameter under the gradient of a fixed quadratic, 9 steps at
    3 steps per epoch with StepLR(1, 0.5): the LR halves twice."""
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal(16).astype(np.float32)
    c = rng.standard_normal(16).astype(np.float32)
    wgt = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    kw = dict(name=name, lr=1e-2, weight_decay=1e-3, lr_schedule=schedule, lr_step_size=1,
              lr_gamma=0.5, grad_clip_norm=clip)
    spe, steps = 3, 9

    tx = jax_build_optimizer(JaxOptimizerConfig(**kw), spe)
    pj = jnp.asarray(p0)
    opt_state = tx.init(pj)
    grad_fn = jax.grad(lambda p: jnp.sum(wgt * (p - c) ** 2))

    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, sched = build_optimizer(OptimizerConfig(**kw), [pt], spe)
    for _ in range(steps):
        updates, opt_state = tx.update(grad_fn(pj), opt_state, pj)
        pj = optax.apply_updates(pj, updates)
        opt.zero_grad()
        torch.sum(torch.from_numpy(wgt) * (pt - torch.from_numpy(c)) ** 2).backward()
        if clip > 0:
            clip_by_global_norm([pt], clip)
        opt.step()
        sched.step()
        np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), atol=1e-6, rtol=0)
