"""The port's pruning (``eelunet_tpu_torch/prune.py``) and physical channel
removal (``prune_physical.py``) against the JAX package's on the same
weights: masks, reports and keep-sets exactly, slim weights exactly, the
slim forward against the masked one at JAX's bounds and against JAX's slim
forward, slim checkpoints, a masked finetune paired with JAX's, ``slim_init``
through the Trainer, and ``cli.prune --physical`` end to end.

JAX's physical slice hard-codes the full-width concat offsets, so the slim
weights and forwards are compared with it at full width; the port derives
the offsets from the widths and is also held to its own masked model at the
narrow widths."""

from __future__ import annotations

import contextlib
import io
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eelunet_tpu import prune as jax_prune
from eelunet_tpu import prune_physical as jax_pp
from eelunet_tpu.config import LossConfig as JaxLossConfig
from eelunet_tpu.config import OptimizerConfig as JaxOptimizerConfig
from eelunet_tpu.data.synthetic import make_blob_sample
from eelunet_tpu.models.eelunet import EELUnet as JaxEELUnet
from eelunet_tpu.models.torch_port import port_state_dict
from eelunet_tpu.registry import MODEL_REGISTRY as JAX_MODEL_REGISTRY
from eelunet_tpu.train import trainer as jax_trainer
from eelunet_tpu.train.state import TrainState as JaxTrainState
from eelunet_tpu.train.state import build_optimizer as jax_build_optimizer
from eelunet_tpu_torch import prune as P
from eelunet_tpu_torch import prune_physical as PP
from eelunet_tpu_torch.config import ModelConfig, OptimizerConfig, TrainConfig, apply_overrides
from eelunet_tpu_torch.inference import Predictor, random_state_dict
from eelunet_tpu_torch.models.convert import from_flax_variables, to_upstream_state_dict
from eelunet_tpu_torch.models.unet import Unet
from eelunet_tpu_torch.nn.layers import init_weights, nchw
from eelunet_tpu_torch.registry import create_model
from eelunet_tpu_torch.train.trainer import make_train_step
from torch_port_families import UNET_NARROW, family_variables, port_model
from torch_port_helpers import (
    CFG,
    LR,
    MASK_RANGE,
    NARROW,
    edge_loss_fn,
    narrow_flax_variables,
    once_per_run,
    port_state,
)


def _variables(name):
    return narrow_flax_variables() if name == "eelunet" else family_variables(name)


def _port(name, variables):
    """The port model of a test family holding ``variables`` (eval mode)."""
    if name == "eelunet":
        model, _ = create_model(CFG, widths=NARROW)
    elif name == "unet":
        model = Unet(3, 1, **UNET_NARROW)
    else:
        model = port_model(name)
    model.load_state_dict(from_flax_variables(variables, name), strict=True)
    return model.eval()


def _leaf_paths(variables, name):
    """Port ``state_dict`` key -> the flax params path ("a/b/kernel") of the
    leaf it comes from: the conversion moves elements and computes none, so a
    tree of element numbers tells where each port tensor lies."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(variables)
    start = np.cumsum([0] + [np.size(a) for _, a in flat])
    numbered = treedef.unflatten([np.arange(a, a + np.size(leaf), dtype=np.float64)
                                  .reshape(np.shape(leaf)) for a, (_, leaf) in zip(start, flat)])
    out = {}
    for k, v in from_flax_variables(numbered, name).items():
        if not v.is_floating_point():
            continue
        i = int(np.searchsorted(start, int(v.reshape(-1)[0]), side="right")) - 1
        path = [str(getattr(q, "key", q)) for q in flat[i][0]]
        out[k] = "/".join(path[1:]) if path[0] == "params" else None
    return out


def _jax_masks_as_port(masks, variables, name):
    ones = jax.tree_util.tree_map(np.ones_like, variables.get("batch_stats", {}))
    tree = {"params": jax.tree_util.tree_map(np.asarray, masks)}
    if ones:
        tree["batch_stats"] = ones
    return from_flax_variables(tree, name)


# (family, zero_bias, round_to); amount 0.3, and 0.5 with round_to 32, which
# prunes only the convs wider than 32 (the narrow U-Net has none).
MASK_CASES = [(name, zb, rt) for name in ("unet", "eelunet", "malunet")
              for zb in (False, True) for rt in (1, 32)] + [("unext_s", True, 1),
                                                             ("egeunet", False, 32)]


@pytest.mark.parametrize("name,zero_bias,round_to", MASK_CASES)
def test_masks_and_reports_match_jax(name, zero_bias, round_to):
    """``compute_prune_masks``: the same output channels masked in the same
    convs (rank-4 flax kernels: convs, transposed convs, MALUNet's 1-d convs
    but not its external-attention matmuls), the same report, sparsity
    report and global sparsity."""
    amount = 0.5 if round_to > 1 else 0.3
    variables = _variables(name)
    jmasks, jreport = jax_prune.compute_prune_masks(variables["params"], amount,
                                                    zero_bias=zero_bias, round_to=round_to)
    want = _jax_masks_as_port(jmasks, variables, name)
    model = _port(name, variables)
    masks, report = P.compute_prune_masks(model, amount, zero_bias=zero_bias,
                                          round_to=round_to)
    paths = _leaf_paths(variables, name)
    jax_kernels = {"/".join(str(q.key) for q in path)
                   for path, leaf in jax.tree_util.tree_flatten_with_path(variables["params"])[0]
                   if path[-1].key == "kernel" and np.ndim(leaf) == 4}
    assert {paths[k] for k in masks if k.endswith(".weight")} == jax_kernels
    for k, w in want.items():
        if k in masks:
            assert torch.equal(masks[k], w), k
        elif w.is_floating_point():
            assert bool((w == 1).all()), k
    assert {paths[k]: v for k, v in report.items()} == jreport
    widest = max(m.weight.shape[P.cout_axis(m)] for m in P.conv_modules(model).values())
    assert report or widest <= round_to, "nothing pruned"
    P.apply_masks(model, masks)
    jmasked = jax_prune.apply_masks(variables["params"], jmasks)
    # JAX takes the mean in float32
    assert {paths[k]: pytest.approx(v, rel=1e-6) for k, v in P.sparsity_report(model).items()} \
        == jax_prune.sparsity_report(jmasked)
    assert P.global_sparsity(model) == pytest.approx(jax_prune.global_sparsity(jmasked),
                                                     rel=1e-12)


@pytest.mark.parametrize("amount,round_to", [(0.3, 4), (0.5, 1), (0.5, 8)])
def test_keep_sets_and_group_masks_match_jax(amount, round_to):
    """The EELUnet's group keep-sets and group masks (producers, biases, BN
    affines) equal JAX's exactly, at the narrow widths (groups of 8 to 32
    channels; round_to 32 is held at full width by the slim weights)."""
    variables = narrow_flax_variables()
    sd = from_flax_variables(variables)
    jkeeps = jax_pp.eelunet_keep_sets(variables["params"], amount, round_to)
    keeps = PP.eelunet_keep_sets(sd, amount, round_to)
    assert sorted(keeps) == sorted(jkeeps) == sorted(g.name for g in jax_pp.eelunet_groups())
    for g in keeps:
        np.testing.assert_array_equal(keeps[g], jkeeps[g], err_msg=g)
    jm, _ = jax_pp.eelunet_prune_masks(variables["params"], amount, round_to)
    want = _jax_masks_as_port(jm, variables, "eelunet")
    masks, _ = PP.eelunet_prune_masks(sd, amount, round_to)
    for k, w in want.items():
        if k in masks:
            assert torch.equal(masks[k], w), k
        elif w.is_floating_point():
            assert bool((w == 1).all()), k
    assert any(not bool((m == 1).all()) for m in masks.values())


def test_l2_keep_indices_match_jax():
    """Conv (O, I, kh, kw) and transposed conv (I, O, kh, kw) weights against
    JAX's flax kernels (kh, kw, I, O), several amounts and round_to."""
    rng = np.random.default_rng(5)
    for shape in ((3, 3, 8, 24), (2, 2, 16, 40)):
        k = rng.standard_normal(shape).astype(np.float32)
        conv = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        convt = torch.from_numpy(np.ascontiguousarray(k[::-1, ::-1].transpose(2, 3, 0, 1)))
        for amount, rt in ((0.3, 1), (0.5, 1), (0.3, 8), (0.0, 1), (0.25, 3)):
            want = jax_pp.l2_keep_indices(k, amount, rt)
            np.testing.assert_array_equal(PP.l2_keep_indices(conv, amount, rt, axis=0), want)
            np.testing.assert_array_equal(PP.l2_keep_indices(convt, amount, rt, axis=1), want)


# ----------------------------------------------------------- full width, JAX

def _full_variables(name):
    """Flax variables of the full-width U-Net or EELUnet from the port's
    seeded init (BN statistics and affines randomised), through the JAX
    package's upstream importer."""
    if name == "unet":
        sd = init_weights(Unet(), torch.Generator().manual_seed(0)).state_dict()
    else:
        sd = random_state_dict(ModelConfig(name="eelunet", fft_mask_range=MASK_RANGE), seed=0)
        rng = np.random.default_rng(1)
        for k, v in sd.items():
            if k.endswith((".running_var", ".weight")) and ".bn" in f".{k}":
                sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
            elif k.endswith((".running_mean", ".bias")) and ".bn" in f".{k}":
                sd[k] = torch.from_numpy((rng.standard_normal(v.shape) * 0.1).astype(np.float32))
    return port_state_dict(name, to_upstream_state_dict(sd, name))


@pytest.fixture(scope="module")
def full_slims(tmp_path_factory):
    return once_per_run(tmp_path_factory, "full_slims", lambda _: _full_slims())


def _full_slims():
    """JAX's and the port's slices of the same full-width weights."""
    out = {}
    for name, amount, rt in (("unet", 0.3, 64), ("eelunet", 0.5, 32)):
        variables = _full_variables(name)
        sd = from_flax_variables(variables, name)
        if name == "unet":
            jp, jw = jax_pp.physical_prune_unet(variables["params"], amount, rt)
            jslim = from_flax_variables({"params": jp}, name)
            slim, widths = PP.physical_prune_unet(sd, amount, rt)
        else:
            jp, jbs, jw = jax_pp.physical_prune_eelunet(variables["params"],
                                                        variables["batch_stats"], amount, rt)
            jslim = from_flax_variables({"params": jp, "batch_stats": jbs}, name)
            slim, widths = PP.physical_prune_eelunet(sd, amount, rt)
        out[name] = dict(jparams=(jp if name == "unet" else {"params": jp, "batch_stats": jbs}),
                         jwidths=jw, jslim=jslim, slim=slim, widths=widths)
    return out


@pytest.mark.parametrize("name", ["unet", "eelunet"])
def test_slim_weights_match_jax(full_slims, name):
    s = full_slims[name]
    assert json.loads(json.dumps(s["widths"])) == json.loads(json.dumps(s["jwidths"]))
    assert sorted(s["slim"]) == sorted(s["jslim"])
    for k, v in s["jslim"].items():
        assert torch.equal(s["slim"][k], v) or not v.is_floating_point(), k


@pytest.mark.parametrize("name", ["unet", "eelunet"])
def test_slim_forward_matches_jax_slim(full_slims, name):
    """The port's slim module (built from the widths) against JAX's slim
    module on the same slim weights, float32, within the EELUnet's forward
    bound of tests/test_torch_port_eelunet.py (5e-4)."""
    s = full_slims[name]
    x = np.random.default_rng(4).standard_normal((1, 32, 32, 3)).astype(np.float32)
    if name == "unet":
        jm = jax_pp.slim_unet(s["jwidths"])
        want = jax.jit(lambda v, xx: jm.apply(v, xx).seg)({"params": s["jparams"]}, x)
        model = PP.slim_unet(s["widths"])
    else:
        jm = jax_pp.slim_eelunet(s["jwidths"], mask_range=MASK_RANGE)
        jm = jm.clone(highpass_impl="lowrank")
        want = jax.jit(lambda v, xx: jm.apply(v, xx, train=False).seg)(s["jparams"], x)
        model = PP.slim_eelunet(s["widths"], mask_range=MASK_RANGE, highpass_impl="lowrank")
    model.load_state_dict(s["slim"], strict=True)
    with torch.no_grad():
        got = model.eval()(nchw(torch.from_numpy(x))).seg.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-4, rtol=0)
    assert np.asarray(want).std() > 1e-4


def test_quarters_preserved(full_slims):
    """Groups feeding a channel shift keep equal counts in each quarter."""
    sd = from_flax_variables(_full_variables("eelunet"))
    for amount, rt in ((0.3, 4), (0.5, 32)):
        keeps = PP.eelunet_keep_sets(sd, amount, rt)
        for g in PP.eelunet_groups():
            if not g.quarter:
                continue
            c = PP._width(sd, g.rank[0])
            per = [int(((keeps[g.name] >= j * c // 4) & (keeps[g.name] < (j + 1) * c // 4)).sum())
                   for j in range(4)]
            assert len(set(per)) == 1 and 0 < per[0] < c // 4, (g.name, per)


# ------------------------------------------------------------ narrow, port

NARROW_D = dict(NARROW)


def _narrow_eelunet(seed=0):
    model, _ = create_model(CFG, widths=NARROW)
    model.load_state_dict(from_flax_variables(narrow_flax_variables(seed)), strict=True)
    return model.eval()


def test_eelunet_slim_matches_masked():
    """Narrow EELUnet, random BN statistics and affines: the sliced model
    reproduces the group-masked one, seg and every aux map, within JAX's
    bounds (atol 3e-5, rtol 1e-4; tests/test_prune_physical.py:212)."""
    model = _narrow_eelunet()
    masks, _ = PP.eelunet_prune_masks(model.state_dict(), 0.3, round_to=4)
    P.apply_masks(model, masks)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = model(x)
    slim_sd, widths = PP.physical_prune_eelunet(model.state_dict(), 0.3, round_to=4)
    slim = PP.slim_eelunet(widths, mask_range=MASK_RANGE)
    slim.load_state_dict(slim_sd, strict=True)
    with torch.no_grad():
        got = slim.eval()(x)
    assert PP.param_count(slim) < PP.param_count(model)
    assert widths["d4sum"] < NARROW_D["d4sum"] and widths["e3a"] % 4 == 0
    for g, w in zip((got.seg, *got.aux), (want.seg, *want.aux)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=3e-5, rtol=1e-4)


def test_slim_eelunet_folded_matches_unfolded():
    """The slim EELUnet is served unfolded, as in the JAX package; the BN
    fold applied to the same slim weights computes the same function, seg
    and every aux map, within the fold's bound of
    tests/test_torch_port_eelunet.py (2e-5)."""
    from eelunet_tpu_torch.inference import build_serving_model

    model = _narrow_eelunet(seed=1)
    masks, _ = PP.eelunet_prune_masks(model.state_dict(), 0.3, round_to=4)
    P.apply_masks(model, masks)
    slim_sd, widths = PP.physical_prune_eelunet(model.state_dict(), 0.3, round_to=4)
    unfolded = build_serving_model(slim_sd, CFG, "cpu", fold_bn=False, widths=widths)
    folded = build_serving_model(slim_sd, CFG, "cpu", fold_bn=True, widths=widths)
    assert folded.bn_folded and not unfolded.bn_folded
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want, got = unfolded(x), folded(x)
    for g, w in zip((got.seg, *got.aux), (want.seg, *want.aux)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5, rtol=2e-5)


def test_unet_slim_matches_masked():
    """Narrow U-Net, bias-zeroed masks: the slice reproduces the masked
    model within JAX's 1e-5 (tests/test_prune_physical.py:56,70), and
    without ``zero_bias`` it does not (the bias leaks through ReLU)."""
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    for zero_bias in (True, False):
        model = init_weights(Unet(3, 1, **UNET_NARROW), torch.Generator().manual_seed(2)).eval()
        masks, _ = P.compute_prune_masks(model, 0.3, zero_bias=zero_bias)
        P.apply_masks(model, masks)
        with torch.no_grad():
            want = model(x).seg
        slim_sd, widths = PP.physical_prune_unet(model.state_dict(), 0.3)
        slim = PP.slim_unet(widths)
        slim.load_state_dict(slim_sd, strict=True)
        with torch.no_grad():
            got = slim.eval()(x).seg
        close = np.allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
        assert close == zero_bias, float((got - want).abs().max())


def test_slim_checkpoint_roundtrip(tmp_path, full_slims):
    """``save_slim`` -> ``is_slim_checkpoint`` -> ``load_slim``: the same
    forward; ``widths.json`` in JAX's schema ``{"model", "widths"}``, and
    the legacy flat-widths U-Net sidecar read as a U-Net."""
    model = _narrow_eelunet()
    masks, _ = PP.eelunet_prune_masks(model.state_dict(), 0.5, round_to=4)
    P.apply_masks(model, masks)
    slim_sd, widths = PP.physical_prune_eelunet(model.state_dict(), 0.5, round_to=4)
    path = PP.save_slim(str(tmp_path / "eslim"), slim_sd, widths, model_name="eelunet")
    assert PP.is_slim_checkpoint(path) and not PP.is_slim_checkpoint(str(tmp_path))
    with open(os.path.join(path, "widths.json")) as f:
        assert json.load(f) == {"model": "eelunet", "widths": widths}
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(3))
    loaded = PP.load_slim(path, CFG).eval()
    fresh = PP.slim_eelunet(widths, mask_range=MASK_RANGE)
    fresh.load_state_dict(slim_sd)
    with torch.no_grad():
        assert torch.equal(loaded(x).seg, fresh.eval()(x).seg)

    u = full_slims["unet"]
    upath = PP.save_slim(str(tmp_path / "uslim"), u["slim"], u["widths"])
    with open(os.path.join(upath, "widths.json")) as f:
        assert json.load(f) == json.loads(json.dumps({"model": "unet", "widths": u["jwidths"]}))
    with open(os.path.join(upath, "widths.json"), "w") as f:  # the legacy form
        json.dump(json.loads(json.dumps(u["jwidths"])), f)
    name, w = PP.read_widths(upath)
    assert name == "unet" and w["up_widths"] == list(u["jwidths"]["up_widths"])
    assert PP.param_count(PP.load_slim(upath)) == sum(
        int(np.prod(np.shape(a))) for a in jax.tree_util.tree_leaves(u["jparams"]))


# ----------------------------------------------------------- finetune, JAX

def _blob_batches(n=2, batch=2, size=64, seed=0):
    rng = np.random.default_rng(seed)
    mean, std = np.array([0.485, 0.456, 0.406]), np.array([0.229, 0.224, 0.225])
    out = []
    for _ in range(n):
        pairs = [make_blob_sample(rng, size, size) for _ in range(batch)]
        out.append((np.stack([(p[0] - mean) / std for p in pairs]).astype(np.float32),
                    np.stack([p[1] for p in pairs]).astype(np.float32)))
    return out


def test_masked_finetune_pairs_with_jax():
    """Two masked-finetune steps from the same narrow weights and masks:
    JAX's ``finetune_pruned`` (its jitted step, low-rank high-pass) and the
    port's, each behind a trainer stub giving its package's step. Bounds of
    tests/test_step_parity.py: step-0 loss rel < 2e-4, trajectory < 1e-2,
    parameters < 8 lr steps; the masked channels are exactly 0 in both."""
    variables = narrow_flax_variables()
    batches = _blob_batches()
    amount, rt = 0.3, 4

    jmasks, _ = jax_pp.eelunet_prune_masks(variables["params"], amount, rt)
    model = JaxEELUnet(mask_range=MASK_RANGE, widths=NARROW, highpass_impl="lowrank")
    loss_fn = jax_trainer.make_loss_fn("edge_bce_dice", JaxLossConfig(),
                                       JAX_MODEL_REGISTRY["eelunet"])
    jstep = jax_trainer.make_train_step(model, loss_fn, True, donate=False)
    loss_j = []

    def jax_step(state, x, y):
        state, loss, ok = jstep(state, x, y)
        loss_j.append(float(loss))
        return state, loss, ok

    jt = types.SimpleNamespace(
        cfg=types.SimpleNamespace(optimizer=JaxOptimizerConfig(lr=10 * LR)),
        _get_step=lambda name, state: jax_step,
        _device_batches=lambda loader: ((jnp.asarray(x), jnp.asarray(y)) for x, y in loader),
        val_one_epoch=lambda state, loader: 0.0)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = jax_build_optimizer(JaxOptimizerConfig(lr=LR), len(batches))
    jstate = JaxTrainState(params=params,
                           batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                              variables["batch_stats"]),
                           opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
                           rng=jax.random.PRNGKey(0), tx=tx)
    jstate = jax_prune.finetune_pruned(jt, jstate, jmasks, batches, [], epochs=1,
                                       log=lambda *a: None)
    want = from_flax_variables({"params": jax.device_get(jstate.params),
                                "batch_stats": jax.device_get(jstate.batch_stats)})

    init = from_flax_variables(variables)
    pstate = port_state(init, CFG, spe=len(batches))
    masks, _ = PP.eelunet_prune_masks(init, amount, rt)
    pstep = make_train_step(edge_loss_fn())
    loss_t = []

    def port_step(state, x, y):
        loss, ok = pstep(state, x, y)
        loss_t.append(float(loss))
        return loss, ok

    pt = types.SimpleNamespace(
        cfg=types.SimpleNamespace(optimizer=OptimizerConfig(lr=10 * LR)),
        _get_step=lambda name: port_step,
        _device_batches=lambda loader: ((torch.from_numpy(x), torch.from_numpy(y))
                                        for x, y in loader),
        val_one_epoch=lambda state, loader: 0.0)
    logs = []
    P.finetune_pruned(pt, pstate, masks, batches, [], epochs=1, log=logs.append)
    assert logs and logs[0].startswith("[finetune 1/1] train=")

    rel = np.abs(np.array(loss_t) - np.array(loss_j)) / np.abs(np.array(loss_j))
    assert rel[0] < 2e-4 and rel.max() < 1e-2, (loss_t, loss_j)
    got = pstate.model.state_dict()
    worst = max((got[k] - want[k]).abs().max().item() for k in want
                if not k.endswith(("running_mean", "running_var", "num_batches_tracked")))
    assert worst < 8 * LR * len(batches), worst
    for k, m in masks.items():
        assert bool((got[k][m == 0] == 0).all()) and bool((want[k][m == 0] == 0).all()), k
    assert any(bool((m == 0).any()) for m in masks.values())
    assert pstate.optimizer.param_groups[0]["lr"] == pytest.approx(LR)


# ------------------------------------------------------------- entry points

def test_slim_init_through_the_trainer(tmp_path):
    """``model.slim_init`` builds the slim module from ``widths.json`` and
    starts from its weights (registry + Trainer); a step runs. Other
    families refuse it with JAX's message."""
    from eelunet_tpu_torch.train.trainer import Trainer

    model = _narrow_eelunet()
    slim_sd, widths = PP.physical_prune_eelunet(model.state_dict(), 0.5, round_to=4)
    path = PP.save_slim(str(tmp_path / "slim"), slim_sd, widths, "eelunet")
    cfg = apply_overrides(TrainConfig(), [
        "model.name=eelunet", f"model.fft_mask_range={MASK_RANGE}", f"model.slim_init={path}",
        f"save_dir={tmp_path}/ck", f"log_dir={tmp_path}/runs", "seed=0"])
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    sd = state.model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in slim_sd.items())
    x, y = _blob_batches(n=1)[0]
    loss, ok = trainer._get_step("train")(state, torch.from_numpy(x), torch.from_numpy(y))
    assert ok and bool(torch.isfinite(loss))
    with pytest.raises(ValueError, match="slim_init supports unet/eelunet"):
        create_model(ModelConfig(name="unext", slim_init=path))


@pytest.fixture
def narrow_trainer(monkeypatch):
    """The CLIs' Trainer builds the narrow EELUnet (full width at 32x32 would
    write 300 MB snapshots); a slim checkpoint still brings its own widths."""
    import eelunet_tpu_torch.train.trainer as T

    orig = T.create_model
    monkeypatch.setattr(T, "create_model", lambda cfg, **kw: orig(
        cfg, **({**kw, "widths": NARROW} if kw.get("widths") is None else kw)))


def test_cli_prune_physical_end_to_end(tmp_path, narrow_trainer):
    """``cli.prune --physical --device cpu``: the comparison table, a
    pruned snapshot and ``<out>_slim``; then ``cli.evaluate`` on the slim
    checkpoint prints the slim metrics ``cli.prune`` printed, and the
    Predictor serves it (unfolded) as the slim model does. ``--physical``
    on another family stops with JAX's message."""
    from eelunet_tpu.cli import prune as jax_prune_cli
    from eelunet_tpu_torch.cli import evaluate as evaluate_cli
    from eelunet_tpu_torch.cli import prune as prune_cli
    from eelunet_tpu_torch.data.synthetic import write_synthetic_tree

    tree = str(tmp_path / "tree")
    write_synthetic_tree(tree, n_train=8, n_test=4, image_size=(32, 32))
    sd = random_state_dict(CFG, seed=0, widths=NARROW)
    np.savez(tmp_path / "w.npz", **to_upstream_state_dict(sd))
    common = ["--device", "cpu", "--model_type", "eelunet", "--data_dir", tree, "--image_size",
              "32", "--batch_size", "2", "--seed", "0", "--set",
              f"model.fft_mask_range={MASK_RANGE}", "--save_dir", str(tmp_path / "ck"),
              "--set", f"log_dir={tmp_path}/runs"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        prune_cli.main(common + ["--checkpoint", str(tmp_path / "w.npz"), "--physical",
                                 "--prune_round_to", "4", "--finetune_epochs", "1"])
    text = out.getvalue()
    assert "metric          original   pruned  finetuned" in text and "== physical ==" in text
    assert json.loads(text.split("kernel launches: ")[1].splitlines()[0])["highpass_expand"] == 0
    slim = text.split("Saved slim checkpoint to ")[1].split()[0]
    assert slim.endswith("eelunet_pruned_30_slim") and PP.is_slim_checkpoint(slim)
    assert os.path.isfile(os.path.join(slim[:-len("_slim")], "state.pt"))
    m_prune = json.loads(text.split("slim metrics: ")[1].splitlines()[0])

    assert evaluate_cli.main(common + ["--checkpoint", slim]) == m_prune
    with pytest.raises(ValueError, match="not supported on the slim"):
        evaluate_cli.main(common + ["--checkpoint", slim, "--set", "data.canny_enhance=true"])

    pred = Predictor(CFG, checkpoint=slim, device="cpu", bucket_batches=False)
    slim_model = PP.load_slim(slim, CFG).eval()
    assert not slim_model.bn_folded and not pred.model.bn_folded
    u8 = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    x = (u8.astype(np.float32) / 255.0 - np.array([0.485, 0.456, 0.406], np.float32)) \
        / np.array([0.229, 0.224, 0.225], np.float32)
    with torch.no_grad():
        want = slim_model(nchw(torch.from_numpy(x))).seg.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(pred.predict_proba(u8), want, atol=1e-6, rtol=0)

    bad = ["--device", "cpu", "--model_type", "unext", "--checkpoint", "x", "--physical"]
    for main in (prune_cli.main, jax_prune_cli.main):
        err = io.StringIO()
        with contextlib.redirect_stderr(err), pytest.raises(SystemExit):
            main(bad if main is prune_cli.main else bad[2:])
        assert "--physical supports model_type unet/eelunet" in err.getvalue()

