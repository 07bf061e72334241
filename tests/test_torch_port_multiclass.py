"""Multi-class segmentation in the port (``model.out_channels > 1``) against
the JAX package on the CPU: every loss the port added (the multi-class
family and the binary ``edge_dice``, ``edge_bce`` and ``focal``), values and
input gradients; the confusion-matrix metrics; each family's softmax head;
and one multi-class EELUnet train step from the same weights."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eelunet_tpu import losses as jax_losses
from eelunet_tpu import metrics as jax_metrics
from eelunet_tpu.config import LossConfig as JaxLossConfig
from eelunet_tpu.data.synthetic import make_multiclass_sample
from eelunet_tpu_torch import losses, metrics
from eelunet_tpu_torch.config import DataConfig, LossConfig, ModelConfig
from eelunet_tpu_torch.data.augment import make_input_preprocess
from eelunet_tpu_torch.registry import MODEL_REGISTRY, create_model, seg_probabilities
from torch_port_helpers import CFG, LR, narrow_flax_variables, paired_train_steps

C = 3
B, HW = 2, 32
MULTICLASS = ("ce", "mc_dice", "ce_dice", "edge_ce_dice", "gt_ce_dice")
BINARY = ("edge_dice", "edge_bce", "focal")
# Aux heads: the EELUnet's pyramid (1/16..1/1) for the edge criteria, five
# full-resolution maps for the EGE-UNet's.
AUX_SCALES = {"edge": (16, 8, 4, 2, 1), "gt": (1, 1, 1, 1, 1)}


def _softmax(logits):
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _inputs(name: str, kind: str, seed: int = 0):
    """(aux, out, target) numpy for a criterion. ``kind``: "random"
    probabilities; "saturated", probabilities of exactly 0 and 1 (one-hot
    softmax, thresholded sigmoid maps); "ids_out_of_range", class ids >= C
    among the targets (a binary 0/255 tree fed to a 3-class model)."""
    rng = np.random.default_rng(seed)
    multi = name in MULTICLASS
    c = C if multi else 1
    if multi:
        ids = rng.integers(0, c, (B, HW, HW, 1))
        if kind == "ids_out_of_range":
            ids[:, : HW // 2] = rng.choice([3, 4, 255], (B, HW // 2, HW, 1))
        target = ids.astype(np.float32)
        logits = rng.standard_normal((B, HW, HW, c)) * 2
        out = np.eye(c, dtype=np.float32)[logits.argmax(-1)] if kind == "saturated" \
            else _softmax(logits)
    else:
        target = (rng.uniform(size=(B, HW, HW, 1)) > 0.6).astype(np.float32)
        out = rng.uniform(0.01, 0.99, (B, HW, HW, 1)).astype(np.float32)
        if kind == "saturated":
            out = (out > 0.5).astype(np.float32)
    scales = AUX_SCALES["gt" if name.startswith("gt") else "edge"]
    aux = []
    for s in scales:
        a = rng.uniform(0.01, 0.99, (B, HW // s, HW // s, 1)).astype(np.float32)
        aux.append((a > 0.5).astype(np.float32) if kind == "saturated" else a)
    return tuple(aux), out, target


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# Class ids >= C apply to the multi-class criteria only.
CASES = [(n, k) for n in MULTICLASS for k in ("random", "saturated", "ids_out_of_range")] + \
    [(n, k) for n in BINARY for k in ("random", "saturated")]


def _ce_float64(out, target) -> float:
    """``ce_loss`` with its mean taken in float64 (p clipped and its log
    taken in float32, as both packages do). XLA's float32 sum of the 2048
    terms of a saturated CE, each about -16.1, strays by 1.1e-5 relative
    from it (1.3e-6 jitted); the port's by 7e-8."""
    p = np.clip(out, np.float32(1e-7), np.float32(1 - 1e-7))
    log_p = np.maximum(np.log(p), np.float32(-100.0)).astype(np.float64)
    ids = np.round(target[..., 0]).astype(np.int64)
    onehot = ids[..., None] == np.arange(out.shape[-1])
    return float(-np.mean(np.sum(onehot * log_p, axis=-1)))


@pytest.mark.parametrize("name,kind", CASES)
def test_loss_and_input_gradients_match_jax(name, kind):
    """Value and the gradients with respect to the main and the aux
    probabilities, within 1e-6 relative to the largest, in float32. The
    value is JAX's, with its CE term (where it has one) summed in float64:
    see ``_ce_float64``."""
    aux, out, target = _inputs(name, kind)
    jfn = jax_losses.LOSS_REGISTRY[name]
    tfn = losses.LOSS_REGISTRY[name]

    def jloss(a, o):
        return jfn(a, o, jnp.asarray(target), JaxLossConfig())

    want, (ga_want, go_want) = jax.value_and_grad(jloss, argnums=(0, 1))(
        tuple(jnp.asarray(a) for a in aux), jnp.asarray(out))
    ta = tuple(torch.from_numpy(a).requires_grad_() for a in aux)
    to = torch.from_numpy(out).requires_grad_()
    got = tfn(ta, to, torch.from_numpy(target), LossConfig())
    got.backward()
    assert np.isfinite(float(want))
    want = float(want)
    if name.startswith(("ce", "edge_ce", "gt_ce")):
        jce = float(jax_losses.ce_loss(jnp.asarray(out), jnp.asarray(target)))
        want += LossConfig().wb * (_ce_float64(out, target) - jce)
    assert _rel(got.item(), want) <= 1e-6, (got.item(), want)
    assert _rel(to.grad.numpy(), go_want) <= 1e-6
    uses_aux = name.startswith(("edge", "gt"))
    for t, g in zip(ta, ga_want):
        if uses_aux:
            assert _rel(t.grad.numpy(), g) <= 1e-6
        else:
            assert t.grad is None and not np.any(np.asarray(g))


def test_one_hot_gives_a_zero_row_past_the_last_class():
    """``F.one_hot`` would raise on an id >= C; the port's one-hot is
    ``jax.nn.one_hot``'s, a zero row."""
    ids = torch.tensor([[[[0.0], [2.0], [3.0], [255.0]]]])
    got = losses._one_hot_target(ids, C)
    want = np.asarray(jax_losses._one_hot_target(jnp.asarray(ids.numpy()), C))
    assert torch.equal(got, torch.from_numpy(np.array(want)))
    assert got[0, 0, 2:].sum() == 0


def test_resolve_loss_name_multiclass():
    for model, c in (("eelunet", 3), ("egeunet", 3), ("unet", 3), ("unet", 1), ("malunet", 2)):
        assert losses.resolve_loss_name("auto", model, c) == \
            jax_losses.resolve_loss_name("auto", model, c)
    assert set(losses.LOSS_REGISTRY) == set(jax_losses.LOSS_REGISTRY)


@pytest.mark.parametrize("ids_out_of_range", [False, True])
def test_multiclass_metrics_match_jax(ids_out_of_range):
    """The confusion matrix equal to JAX's, the nine metrics and the
    per-class table within 1e-6. Ids >= C are clipped to C-1 here (the
    losses do not clip)."""
    rng = np.random.default_rng(5)
    probs = _softmax(rng.standard_normal((3, 48, 40, 4)) * 2)
    ids = rng.integers(0, 4, (3, 48, 40, 1)).astype(np.float32)
    # blobs, so that the boundary F1 sees contours
    ids[:, 10:30, 8:30] = 2.0
    probs[:, 12:30, 8:28, 2] += 2.0
    probs /= probs.sum(-1, keepdims=True)
    if ids_out_of_range:
        ids[:, :6] = 7.0
    acc = metrics.update_metrics_multiclass(torch.from_numpy(probs), torch.from_numpy(ids))
    jacc = jax_metrics.update_metrics_multiclass(jnp.asarray(probs), jnp.asarray(ids))
    np.testing.assert_array_equal(acc.confusion.numpy(), np.asarray(jacc.confusion))
    assert acc.confusion.dtype == torch.float32
    assert float(acc.samples) == float(jacc.samples) == 3.0
    assert abs(float(acc.boundary_f1_sum) - float(jacc.boundary_f1_sum)) <= 1e-6
    got = metrics.finalize_metrics_multiclass(acc + acc)
    want = jax_metrics.finalize_metrics_multiclass(jacc + jacc)
    assert tuple(got) == tuple(want) == metrics.METRIC_NAMES
    assert 0.0 < float(want["boundary_f1"]) < 1.0
    for k in metrics.METRIC_NAMES:
        assert abs(float(got[k]) - float(want[k])) <= 1e-6, k
    pc, jpc = metrics.per_class_metrics(acc), jax_metrics.per_class_metrics(jacc)
    assert pc.keys() == jpc.keys()
    for k in pc:
        np.testing.assert_allclose(pc[k], jpc[k], rtol=0, atol=1e-6)


def test_preprocess_keeps_class_ids():
    """uint8 class ids are cast without the binary /255."""
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 3, (2, 8, 8, 1),
                                                             dtype=np.uint8))
    imgs = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    _, labels = make_input_preprocess(DataConfig(), num_classes=3)(imgs, ids)
    assert torch.equal(labels, ids.float())
    _, binary = make_input_preprocess(DataConfig(), num_classes=1)(imgs, ids * 0 + 255)
    assert torch.equal(binary, torch.ones_like(binary))


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_softmax_heads_sum_to_one(name):
    """Each family at ``out_channels=3``: the probabilities over the class
    axis sum to 1 (tests/test_multiclass.py:190 holds the JAX heads so)."""
    cfg = ModelConfig(name=name, out_channels=C, fft_mask_range=6)
    model, meta = create_model(cfg)
    model.eval()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 3, 32, 32))
                         .astype(np.float32))
    with torch.no_grad():
        probs = seg_probabilities(model(x), meta)
    assert probs.shape == (1, C, 32, 32)
    np.testing.assert_allclose(probs.sum(1).numpy(), 1.0, rtol=1e-5)


# -------------------------------------------- one multi-class EELUnet step

STEPS = 2
MC_CFG = dataclasses.replace(CFG, out_channels=C)


def _mc_batches(seed=0, n=STEPS, batch=2, size=64):
    rng = np.random.default_rng(seed)
    mean, std = np.array([0.485, 0.456, 0.406]), np.array([0.229, 0.224, 0.225])
    out = []
    for _ in range(n):
        pairs = [make_multiclass_sample(rng, size, size, C) for _ in range(batch)]
        x = np.stack([(p[0] - mean) / std for p in pairs]).astype(np.float32)
        y = np.stack([p[1] for p in pairs]).astype(np.float32)
        out.append((x, x, y))
    return out


@pytest.fixture(scope="module")
def mc_run():
    return paired_train_steps(narrow_flax_variables(out_channels=C), _mc_batches(), False,
                              cfg=MC_CFG, loss_name="edge_ce_dice")


def test_multiclass_step_parity(mc_run):
    """``edge_ce_dice`` steps of the narrow 3-class EELUnet from the same
    weights, at the bounds of tests/test_torch_port_train.py: step-0 loss
    rel < 2e-4, trajectory < 1e-2, parameters < 8*lr*steps, BN statistics
    < 1e-1; and the head's first-step gradient within 1e-2 (relative L2)."""
    loss_j, loss_t, pstate = mc_run["loss_j"], mc_run["loss_t"], mc_run["pstate"]
    rel = np.abs(loss_t - loss_j) / np.abs(loss_j)
    assert rel[0] < 2e-4 and rel.max() < 1e-2, (loss_t, loss_j)
    want, got = mc_run["want"], pstate.model.state_dict()
    assert got["final_conv.weight"].shape[0] == C
    stats = ("running_mean", "running_var", "num_batches_tracked")
    worst = max((got[k] - want[k]).abs().max().item() for k in want if not k.endswith(stats))
    assert worst < 8 * LR * STEPS, worst
    worst_bn = max((got[k] - want[k]).abs().max().item() for k in want
                   if k.endswith(stats[:2]))
    assert worst_bn < 1e-1, worst_bn
    gj, gt = mc_run["grad_j"]["final_conv.weight"], mc_run["grad_t"]["final_conv.weight"]
    assert ((gt - gj).norm() / gj.norm()).item() < 1e-2
