"""The port's training path on the CPU: paired-init train-step parity with
the JAX package, gradient accumulation, the non-finite guard, the train CLI
end to end, exact resume, and a best tag served by the Predictor."""

from __future__ import annotations

import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eelunet_tpu.config import LossConfig as JaxLossConfig
from eelunet_tpu.config import OptimizerConfig as JaxOptimizerConfig
from eelunet_tpu.data.synthetic import make_blob_sample
from eelunet_tpu.models.eelunet import EELUnet as JaxEELUnet
from eelunet_tpu.registry import MODEL_REGISTRY as JAX_MODEL_REGISTRY
from eelunet_tpu.train import trainer as jax_trainer
from eelunet_tpu.train.state import TrainState as JaxTrainState
from eelunet_tpu.train.state import build_optimizer as jax_build_optimizer
from eelunet_tpu_torch.cli import train as train_cli
from eelunet_tpu_torch.config import ModelConfig, OptimizerConfig, TrainConfig, apply_overrides
from eelunet_tpu_torch.data.synthetic import write_synthetic_tree
from eelunet_tpu_torch.inference import Predictor
from eelunet_tpu_torch.models.convert import from_flax_variables
from eelunet_tpu_torch.registry import MODEL_REGISTRY, create_model
from eelunet_tpu_torch.train.state import TrainState, build_optimizer
from eelunet_tpu_torch.train.trainer import (
    Trainer,
    forward_loss,
    make_loss_fn,
    make_train_step,
)
from torch_port_helpers import MASK_RANGE, NARROW, narrow_flax_variables

LR = 1e-4
STEPS = 3
CFG = ModelConfig(name="eelunet", fft_mask_range=MASK_RANGE)


def _batches(seed=0, n=STEPS, batch=2, size=64):
    """Seeded normalised images and blob masks, NHWC float32 numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pairs = [make_blob_sample(rng, size, size) for _ in range(batch)]
        mean, std = np.array([0.485, 0.456, 0.406]), np.array([0.229, 0.224, 0.225])
        x = np.stack([(p[0] - mean) / std for p in pairs]).astype(np.float32)
        y = np.stack([p[1] for p in pairs]).astype(np.float32)
        out.append((x, y))
    return out


def _port_state(sd, lr=LR, spe=STEPS, dtype=torch.float32):
    model, _ = create_model(CFG, widths=NARROW)
    model = model.to(dtype=dtype, memory_format=torch.channels_last)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    opt, sched = build_optimizer(OptimizerConfig(lr=lr), model.parameters(), spe)
    return TrainState(model, opt, sched, seed=0)


def _loss_fn():
    from eelunet_tpu_torch.config import LossConfig

    return make_loss_fn("edge_bce_dice", LossConfig(), MODEL_REGISTRY["eelunet"])


def _port_index(variables):
    """Where each element of each port tensor lies in the JAX ``variables``
    leaves, concatenated in tree order. ``from_flax_variables`` moves
    elements and computes none, so applied to a tree of element numbers it
    gives a map that takes any tree of that structure over exactly, in any
    dtype (it converts through float32, exact for element numbers < 2**24)."""
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    start = np.cumsum([0] + [np.size(leaf) for leaf in leaves])
    assert start[-1] < 2 ** 24
    numbered = treedef.unflatten([np.arange(a, a + np.size(leaf)).reshape(np.shape(leaf))
                                  for a, leaf in zip(start, leaves)])
    return {k: v.long().numpy() for k, v in from_flax_variables(numbered).items()
            if v.is_floating_point()}


def _port_tree(variables, index):
    flat = np.concatenate([np.ravel(np.asarray(leaf))
                           for leaf in jax.tree_util.tree_leaves(variables)])
    return {k: torch.from_numpy(flat[ix]) for k, ix in index.items()}


def _paired(float64: bool):
    """STEPS paired train steps, 64x64, batch 2, from the same narrow
    weights, in float32 or float64: the JAX step on its low-rank high-pass,
    the port's step on the high-pass Function (plain twins on the CPU).
    Also the first step's gradients: the port's ``.grad``, and JAX's from
    its Adam first moment after one step, (1 - b1) (g + wd p)."""
    variables = narrow_flax_variables()
    index = _port_index(variables)
    batches = _batches()
    wd = OptimizerConfig().weight_decay
    with jax.enable_x64(float64):
        jdt = jnp.float64 if float64 else jnp.float32
        model = JaxEELUnet(mask_range=MASK_RANGE, widths=NARROW, highpass_impl="lowrank",
                           **({"dtype": jdt} if float64 else {}))
        loss_fn = jax_trainer.make_loss_fn("edge_bce_dice", JaxLossConfig(),
                                           JAX_MODEL_REGISTRY["eelunet"])
        step = jax_trainer.make_train_step(model, loss_fn, True, donate=False)
        tx = jax_build_optimizer(JaxOptimizerConfig(lr=LR), STEPS)
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), t)  # noqa: E731
        params = cast(variables["params"])
        jstate = JaxTrainState(params=params, batch_stats=cast(variables["batch_stats"]),
                               opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
                               rng=jax.random.PRNGKey(0), tx=tx)
        loss_j = []
        for i, (x, y) in enumerate(batches):
            jstate, loss, _ = step(jstate, jnp.asarray(x, jdt), jnp.asarray(y, jdt))
            loss_j.append(float(loss))
            if i == 0:
                mu1 = next(s.mu for s in jstate.opt_state if hasattr(s, "mu"))
                mu1 = _port_tree({"params": jax.device_get(mu1),
                                  "batch_stats": variables["batch_stats"]}, index)
        want = _port_tree({"params": jax.device_get(jstate.params),
                           "batch_stats": jax.device_get(jstate.batch_stats)}, index)

    tdt = torch.float64 if float64 else torch.float32
    init = {k: v.to(tdt) for k, v in _port_tree(variables, index).items()}
    pstate = _port_state(init, dtype=tdt)
    pstep = make_train_step(_loss_fn())
    loss_t = []
    for i, (x, y) in enumerate(batches):
        loss, ok = pstep(pstate, torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt))
        assert ok
        loss_t.append(float(loss))
        if i == 0:
            grad_t = {k: p.grad.clone() for k, p in pstate.model.named_parameters()}
    grad_j = {k: mu1[k].to(tdt) / 0.1 - wd * init[k] for k in grad_t}
    return {"loss_j": np.array(loss_j), "loss_t": np.array(loss_t), "want": want,
            "pstate": pstate, "init": init, "grad_j": grad_j, "grad_t": grad_t}


@pytest.fixture(scope="module")
def paired_run():
    return _paired(float64=False)


@pytest.fixture(scope="module")
def paired_run64():
    return _paired(float64=True)


# The bounds tests/test_step_parity.py holds the JAX EELUnet step to against
# the upstream torch loop: step-0 loss rel < 2e-4 (float dust from the same
# weights), trajectory rel < 1e-2 (the deep-supervision loss and the
# high-pass float path drift), parameters < 8*lr*steps (the worst two-path
# Adam divergence), BN running statistics < 1e-1 (dust on O(1-10) values).
def test_step_parity_losses(paired_run):
    loss_j, loss_t, pstate = paired_run["loss_j"], paired_run["loss_t"], paired_run["pstate"]
    rel = np.abs(loss_t - loss_j) / np.abs(loss_j)
    assert rel[0] < 2e-4, (loss_t, loss_j)
    assert rel.max() < 1e-2, (loss_t, loss_j)
    assert pstate.step == STEPS


def test_step_parity_params(paired_run):
    want, pstate = paired_run["want"], paired_run["pstate"]
    got = pstate.model.state_dict()
    worst = max((got[k] - want[k]).abs().max().item() for k in want
                if not k.endswith(("running_mean", "running_var", "num_batches_tracked")))
    assert worst < 8 * LR * STEPS, worst


def _rel(a, b):
    return ((a - b).norm() / b.norm()).item()


# The bounds above pass a port that skips its update or flips every
# gradient's sign: Adam moves a weight about lr per step whatever the
# gradient. The two checks below can fail. They run in float64, where the
# JAX step is a reference to compare with: its float32 gradient is about
# 1e-1 off its float64 one (relative L2 over all leaves), against about
# 6e-3 for the port's. In float64 the packages agree to 1.6e-6 on the worst
# leaf's gradient and to 2.1e-5 on the whole parameter change over STEPS
# steps; a flipped gradient reads 2, a skipped update 1.
def _flat(tree, keys):
    return torch.cat([tree[k].flatten() for k in keys])


def test_step_parity_first_step_grads(paired_run64):
    """Leaf by leaf, the port's first-step gradient against JAX's. Biases
    that feed a batch norm have a zero gradient (below 1e-9 of the whole
    gradient's norm here, the live leaves above 3e-5): they carry only
    rounding and are left out."""
    gj, gt = paired_run64["grad_j"], paired_run64["grad_t"]
    total = _flat(gj, gj).norm()
    live = [k for k in gj if gj[k].norm() > 1e-6 * total]
    assert len(live) > 200, len(live)
    worst = max((_rel(gt[k], gj[k]), k) for k in live)
    assert worst[0] < 1e-4, worst


def test_step_parity_param_change(paired_run64):
    """The whole parameter change over STEPS Adam steps, port against JAX."""
    want, init = paired_run64["want"], paired_run64["init"]
    got, keys = paired_run64["pstate"].model.state_dict(), list(paired_run64["grad_j"])
    delta_j = _flat(want, keys) - _flat(init, keys)
    delta_t = _flat(got, keys) - _flat(init, keys)
    assert _rel(delta_t, delta_j) < 1e-3, _rel(delta_t, delta_j)


def test_step_parity_bn_stats(paired_run):
    want, pstate = paired_run["want"], paired_run["pstate"]
    got = pstate.model.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 33
    worst = max((got[k] - want[k]).abs().max().item() for k in keys)
    assert worst < 1e-1, worst
    assert all(int(got[k]) == STEPS for k in got if k.endswith("num_batches_tracked"))


def test_accum_steps_loss_is_mean_of_micro_batches():
    sd = from_flax_variables(narrow_flax_variables())
    state = _port_state(sd)
    (x, y), = _batches(seed=3, n=1, batch=4)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    ref = copy.deepcopy(state.model).train()
    with torch.no_grad():
        micro = [forward_loss(ref, _loss_fn(), x[i:i + 2], y[i:i + 2]).item() for i in (0, 2)]
    loss, ok = make_train_step(_loss_fn(), accum_steps=2)(state, x, y)
    assert ok and state.step == 1
    np.testing.assert_allclose(loss.item(), np.mean(micro), rtol=1e-6)
    # BN statistics updated once per micro-batch, as two sequential forwards
    got, want = state.model.state_dict(), ref.state_dict()
    for k in want:
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-7)


def test_remat_step_equals_plain_step():
    """Recomputing the forward in the backward changes neither the update
    nor the BN statistics (updated once, not again by the recompute)."""
    sd = from_flax_variables(narrow_flax_variables())
    plain, remat = _port_state(sd), _port_state(sd)
    (x, y), = _batches(seed=5, n=1)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    loss_p, _ = make_train_step(_loss_fn())(plain, x, y)
    loss_r, _ = make_train_step(_loss_fn(), remat=True)(remat, x, y)
    assert loss_r.item() == loss_p.item()
    want = plain.model.state_dict()
    for k, v in remat.model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=1e-6, atol=1e-7, msg=k)


def test_nonfinite_guard_skips_the_update():
    sd = from_flax_variables(narrow_flax_variables())
    state = _port_state(sd)
    step = make_train_step(_loss_fn(), skip_nonfinite=True)
    (x, y), = _batches(seed=4, n=1)
    x[0, 3, 5, 1] = np.nan
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    loss, ok = step(state, torch.from_numpy(x), torch.from_numpy(y))
    assert not ok and not np.isfinite(loss.item())
    assert state.step == 1 and state.scheduler.last_epoch == 0
    assert state.optimizer.state_dict()["state"] == {}
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    x[0, 3, 5, 1] = 0.0  # a finite batch is applied
    loss, ok = step(state, torch.from_numpy(x), torch.from_numpy(y))
    assert ok and np.isfinite(loss.item()) and state.step == 2
    assert not torch.equal(state.model.enc1.conv0.weight, before["enc1.conv0.weight"])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree32")
    return write_synthetic_tree(str(root), n_train=8, n_test=4, image_size=(32, 32))


def test_cli_train_end_to_end_and_serve_a_best_tag(tree, tmp_path):
    """Full width, 32x32, m = 6, on the CPU: two epochs write the history,
    the best tags and ``last``; a best tag loads into the Predictor."""
    save, logs = tmp_path / "ckpt", tmp_path / "runs"
    train_cli.main(["--device", "cpu", "--model_type", "eelunet", "--data_dir", tree,
                    "--image_size", "32", "--batch_size", "2", "--epochs", "2", "--seed", "0",
                    "--save_dir", str(save), "--log_dir", str(logs),
                    "--set", f"model.fft_mask_range={MASK_RANGE}", "--set", "data.num_workers=1"])
    root = save / "eelunet"
    try:
        hist = json.loads((root / "loss_history.json").read_text())
        assert len(hist["train_loss"]) == len(hist["val_loss"]) == 2
        assert all(np.isfinite(hist["train_loss"])) and hist["metrics"][1]["dice"] >= 0
        assert (root / "eelunet_best.npz").is_file() and (root / "eelunet_best_dice.npz").is_file()
        meta = json.loads((root / "eelunet_last" / "framework_meta.json").read_text())
        assert meta["epoch"] == 2 and (root / "eelunet_last" / "state.pt").is_file()
        assert list(logs.glob("eelunet/*/metrics.jsonl"))

        pred = Predictor(dataclasses.replace(CFG), checkpoint=str(root / "eelunet_best.npz"),
                         device="cpu")
        u8 = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
        probs = pred.predict_proba(u8)
        assert probs.shape == (2, 32, 32, 1)
        assert np.isfinite(probs).all() and probs.min() >= 0 and probs.max() <= 1
    finally:  # 100 MB files at full width
        for f in root.glob("*.npz"):
            f.unlink()
        (root / "eelunet_last" / "state.pt").unlink(missing_ok=True)


def _narrow_fit(tree, save, epochs, resume=""):
    cfg = apply_overrides(TrainConfig(), [
        f"data.data_dir={tree}", "data.image_size=32", "data.batch_size=2",
        "data.num_workers=1", "data.random_flip=true", f"model.fft_mask_range={MASK_RANGE}",
        f"epochs={epochs}", "seed=3", f"save_dir={save}", f"log_dir={save}/runs",
        f"resume_from={resume}", "optimizer.ema_decay=0.9"])
    from eelunet_tpu_torch.cli.common import build_loaders

    trainer = Trainer(cfg, device="cpu", widths=NARROW)
    state, hist = trainer.fit(*build_loaders(cfg), log=lambda *a: None)
    return state, hist


def test_exact_resume(tree, tmp_path):
    """One epoch, then a resumed second one, ends where two straight epochs
    end: same batches, same step-keyed flips, same optimizer state."""
    straight, hist = _narrow_fit(tree, tmp_path / "a", 2)
    _narrow_fit(tree, tmp_path / "b", 1)
    resumed, hist_b = _narrow_fit(tree, tmp_path / "b", 2, resume="auto")
    assert resumed.step == straight.step == 6
    for (k, v), w in zip(resumed.model.state_dict().items(), straight.model.state_dict().values()):
        assert torch.equal(v, w), k
    for k in straight.ema:
        assert torch.equal(resumed.ema[k], straight.ema[k]), k
    assert hist_b["train_loss"] == hist["train_loss"]
    assert (tmp_path / "b" / "eelunet" / "eelunet_ema.npz").is_file()


def test_trainer_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        Trainer(TrainConfig())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(apply_overrides(TrainConfig(), ["model.out_channels=2"]), device="cpu")
