"""The port's training path on the CPU: paired-init train-step parity with
the JAX package, gradient accumulation, the non-finite guard, the train CLI
end to end, exact resume, and a best tag served by the Predictor."""

from __future__ import annotations

import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from eelunet_tpu.data.synthetic import make_blob_sample
from eelunet_tpu_torch.cli import train as train_cli
from eelunet_tpu_torch.config import TrainConfig, apply_overrides
from eelunet_tpu_torch.data.synthetic import write_synthetic_tree
from eelunet_tpu_torch.inference import Predictor
from eelunet_tpu_torch.models.convert import from_flax_variables
from eelunet_tpu_torch.train.trainer import Trainer, forward_loss, make_train_step
from torch_port_helpers import (
    CFG,
    LR,
    MASK_RANGE,
    NARROW,
    STEPS,
    edge_loss_fn,
    narrow_flax_variables,
    paired_train_steps,
    port_state,
)


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


def _paired(float64: bool):
    """STEPS paired train steps on normalised batches (``paired_train_steps``)."""
    return paired_train_steps(narrow_flax_variables(), [(x, x, y) for x, y in _batches()],
                              float64)


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
    state = port_state(sd)
    (x, y), = _batches(seed=3, n=1, batch=4)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    ref = copy.deepcopy(state.model).train()
    with torch.no_grad():
        micro = [forward_loss(ref, edge_loss_fn(), x[i:i + 2], y[i:i + 2]).item()
                 for i in (0, 2)]
    loss, ok = make_train_step(edge_loss_fn(), accum_steps=2)(state, x, y)
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
    plain, remat = port_state(sd), port_state(sd)
    (x, y), = _batches(seed=5, n=1)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    loss_p, _ = make_train_step(edge_loss_fn())(plain, x, y)
    loss_r, _ = make_train_step(edge_loss_fn(), remat=True)(remat, x, y)
    assert loss_r.item() == loss_p.item()
    want = plain.model.state_dict()
    for k, v in remat.model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=1e-6, atol=1e-7, msg=k)


def test_nonfinite_guard_skips_the_update():
    sd = from_flax_variables(narrow_flax_variables())
    state = port_state(sd)
    step = make_train_step(edge_loss_fn(), skip_nonfinite=True)
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
    # the data axis is ported (tests/test_torch_port_ddp.py): one process
    # has one device, so a data axis of 2 is JAX's ValueError; the model and
    # spatial axes are the next slice
    with pytest.raises(ValueError, match="needs more than 1 devices"):
        Trainer(apply_overrides(TrainConfig(), ["mesh.data_axis=2"]), device="cpu")
    for axis in ("model", "spatial"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Trainer(apply_overrides(TrainConfig(), [f"mesh.{axis}_axis=2"]), device="cpu")
    # slim checkpoints are ported: a slim_init without its widths.json is
    # an error of the path, not a refusal
    with pytest.raises(FileNotFoundError, match="widths.json"):
        Trainer(apply_overrides(TrainConfig(), ["model.slim_init=no_such_dir"]), device="cpu")


def test_trainer_names_the_options_it_ignores(tmp_path):
    """``donate_buffers`` and ``compile_cache`` are accepted and not acted
    on: ``fit`` says so in one line at its start, naming each one that is
    set, and says nothing when none is. ``async_checkpoint`` is acted on
    (tests/test_torch_port_async_ckpt.py) and never named."""
    base = ["model.name=eelunet", "epochs=0", f"save_dir={tmp_path}/ck",
            f"log_dir={tmp_path}/runs"]
    for sets, want in (([], ["donate_buffers", "compile_cache"]),
                       (["compile_cache="], ["donate_buffers"]),
                       (["async_checkpoint=false", "donate_buffers=false", "compile_cache="],
                        [])):
        cfg = apply_overrides(TrainConfig(), base + sets)
        lines = []
        Trainer(cfg, device="cpu", widths=NARROW).fit([], [], [], log=lines.append)
        named = [ln for ln in lines if ln.startswith("ignored by eelunet_tpu_torch: ")]
        assert len(named) == (1 if want else 0), lines
        if want:
            assert lines[0] == named[0]
            assert [k for k in ("async_checkpoint", "donate_buffers", "compile_cache")
                    if k in named[0]] == want
