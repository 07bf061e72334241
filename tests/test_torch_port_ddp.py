"""Data-parallel training on the CPU: the port's Trainer on 2 gloo ranks
(tests/torch_port_ddp_worker.py) against the JAX package's Trainer on a
2-device data mesh, and against the port's own single-process run on the
same global batch.

UNeXt-S (published width, with batch norms, random BN statistics and
affines) at 32x32, global batch 8 (4 rows per rank), from the same
weights in both packages. JAX draws its flips from ``jax.random`` and the
port from a torch generator, so with ``random_flip`` the 2-rank run is held
to the port's single-process run, as is the run with gradient accumulation,
flips and the non-finite guard. (Not the EELUnet: where |z| is near 0 its
high-pass backward turns with summation order, so its float32 gradient is
about 1e-1 away from itself in another order, tests/test_torch_port_train.py.)
One spawn runs every part (``ddp`` scenario) while this process runs the JAX
side.
"""

from __future__ import annotations

import json
import os
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eelunet_tpu.config import TrainConfig as JaxTrainConfig
from eelunet_tpu.config import apply_overrides as jax_apply_overrides
from eelunet_tpu.data.pipeline import DataLoader as JaxDataLoader
from eelunet_tpu.data.synthetic import SyntheticDataset
from eelunet_tpu.parallel.mesh import create_mesh as jax_create_mesh
from eelunet_tpu.train.state import TrainState as JaxTrainState
from eelunet_tpu.train.state import build_optimizer as jax_build_optimizer
from eelunet_tpu.train.trainer import Trainer as JaxTrainer
from eelunet_tpu_torch.config import ModelConfig, TrainConfig, apply_overrides
from eelunet_tpu_torch.data.pipeline import DataLoader
from eelunet_tpu_torch.data.synthetic import write_synthetic_tree
from eelunet_tpu_torch.models.convert import from_flax_variables
from eelunet_tpu_torch.nn.layers import init_weights
from eelunet_tpu_torch.parallel.mesh import create_mesh
from eelunet_tpu_torch.registry import MODEL_REGISTRY, create_model
from eelunet_tpu_torch.train.trainer import Trainer, forward_loss, make_loss_fn
from torch_port_ddp_worker import spawn
from torch_port_families import UNET_NARROW, family_variables
from torch_port_helpers import MASK_RANGE, NARROW, once_per_run

# The bound tests/test_sharding.py::test_dp_training_matches_single_device
# holds JAX's data-parallel loss trajectory to, and the bound of its
# test_eval_with_ragged_tail_batch.
TRAJ_RTOL, EVAL_REL = 2e-4, 1e-5
OVERRIDES = ["model.name=unext_s", "data.image_size=32", "data.batch_size=8", "epochs=1",
             "seed=0", "snapshot_every=100", "data.num_workers=1"]
# SGD, whose update is linear in the gradient: Adam scales each gradient to
# a step of about lr, so a gradient that is rounding noise (the biases
# before a batch norm have none) moves its weight by lr in a direction the
# noise picks, which is no test of the step.
ACCUM_SETS = ["accum_steps=2", "data.random_flip=true", "skip_nonfinite_updates=true",
              "optimizer.name=sgd", "optimizer.lr=0.01"]


def _jax_run(variables, train, test, workdir):
    """JAX's Trainer on create_mesh(2, 1): one epoch from ``variables``
    (history), then the metrics of those weights on the ragged test split.
    The state is built from the variables directly: ``init_state`` would
    trace an init that is thrown away."""
    cfg = jax_apply_overrides(JaxTrainConfig(), [o for o in OVERRIDES if "image_size" not in o] + [
        "data.image_size=[32,32]", f"save_dir={workdir}/jax_ck", f"log_dir={workdir}/jax_runs",
        "compile_cache=", "async_checkpoint=false"])
    trainer = JaxTrainer(cfg, mesh=jax_create_mesh(2, 1))

    def state():
        tx = jax_build_optimizer(cfg.optimizer, len(train) // 8)
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        s = JaxTrainState(params=params,
                          batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                             variables["batch_stats"]),
                          opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
                          rng=jax.random.PRNGKey(0), tx=tx)
        return jax.device_put(s, trainer._state_shardings(s))

    loaders = (JaxDataLoader(train, 8, shuffle=True, seed=0),
               JaxDataLoader(test, 4, drop_remainder=False),
               JaxDataLoader(test, 4, drop_remainder=False))
    _, hist = trainer.fit(*loaders, state=state(), log=lambda *a: None)
    metrics = trainer.evaluate(state(), JaxDataLoader(test, 4, drop_remainder=False))
    return hist, metrics


def _port_fit(sets, sd, workdir, save, train, test):
    """The port's single-process run of a worker's ``fit``."""
    cfg = apply_overrides(TrainConfig(), OVERRIDES + sets + [
        f"save_dir={workdir}/{save}", f"log_dir={workdir}/runs1"])
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(len(train) // 8)
    state.model.load_state_dict(sd)
    loaders = (DataLoader(train, 8, shuffle=True, seed=cfg.seed, num_workers=1),
               DataLoader(test, 4, drop_remainder=False, num_workers=1),
               DataLoader(test, 4, drop_remainder=False, num_workers=1))
    return trainer.fit(*loaders, state=state, log=lambda *a, **k: None)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return once_per_run(tmp_path_factory, "ddp", _run)


def _run(work: str):
    """The 2-rank spawn (in a thread) and, here, JAX's fit and the port's
    single-process fits."""
    variables = family_variables("unext_s")
    train = list(SyntheticDataset(n=16, image_size=(32, 32), seed=0).samples)
    test = list(SyntheticDataset(n=7, image_size=(32, 32), seed=1).samples)  # tail of 3
    inputs = {
        "train": train, "test": test, "overrides": OVERRIDES,
        "unext_s": from_flax_variables(variables, "unext_s"),
        "accum_sets": ACCUM_SETS,
        "tree": write_synthetic_tree(os.path.join(work, "tree"), n_train=9, n_test=3,
                                     image_size=(32, 32)),
    }
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    ranks = {}

    def ddp():
        try:
            ranks["out"] = spawn("ddp", work, timeout=300)
        except BaseException as e:  # raised in the tests that read it
            ranks["error"] = e

    thread = threading.Thread(target=ddp)
    thread.start()
    try:
        jax_hist, jax_metrics = _jax_run(variables, train, test, work)
        flip = _port_fit(["data.random_flip=true"], inputs["unext_s"], work, "ck_flip",
                         train=train, test=test)[1]
        accum_state, accum_hist = _port_fit(ACCUM_SETS, inputs["unext_s"], work, "ck_acc",
                                            train=train, test=test)
        _port_fit(["snapshot_every=1"], inputs["unext_s"], work, "ck_c",
                              train=train, test=test)
    finally:
        thread.join()
    if "error" in ranks:
        raise ranks["error"]
    return {"ranks": ranks["out"], "work": work, "jax_hist": jax_hist,
            "jax_metrics": jax_metrics, "flip": flip, "accum_hist": accum_hist,
            "accum_state": types.SimpleNamespace(model=accum_state.model)}


def _part(run, name):
    parts = [r[name] for r in run["ranks"]]
    for p in parts:
        assert not (isinstance(p, dict) and "error" in p), p.get("error")
    return parts


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol)


def test_ddp_fit_matches_jax_data_mesh(run):
    """The 2-rank fit's train and val losses against JAX's Trainer on a
    2-device data mesh: global-batch BN statistics, averaged gradients and
    global loss means make it the same step."""
    for hist in _part(run, "jax_fit"):
        _close(hist["train_loss"], run["jax_hist"]["train_loss"], TRAJ_RTOL)
        _close(hist["val_loss"], run["jax_hist"]["val_loss"], TRAJ_RTOL)


def test_ddp_fit_with_flips_matches_single_process(run):
    """With ``random_flip`` each rank applies its rows of the global
    batch's draw: the single-process port's run on the whole batch."""
    for hist in _part(run, "flip_fit"):
        _close(hist["train_loss"], run["flip"]["train_loss"], TRAJ_RTOL)
        _close(hist["val_loss"], run["flip"]["val_loss"], TRAJ_RTOL)


def test_ddp_eval_with_ragged_tail_matches_jax(run):
    """7 test images in batches of 4: the first is split over the ranks and
    its counts summed, the tail of 3 runs whole and counts once."""
    want = run["jax_metrics"]
    for metrics in _part(run, "ragged_eval"):
        assert set(metrics) == set(want)
        for k in want:
            assert metrics[k] == pytest.approx(want[k], rel=EVAL_REL, abs=1e-12), k


def test_ddp_accumulation_flips_guard_match_single_process(run):
    """``accum_steps=2``: each rank's micro-batch i holds its share of the
    global micro-batch i (``process_rows``), so the BN statistics are those
    of the single-process micro-batch; flips and the guard on. The running
    statistics end equal on both ranks, and equal to the single process's
    but for rounding."""
    parts = _part(run, "accum")
    for p in parts:
        _close(p["hist"]["train_loss"], run["accum_hist"]["train_loss"], TRAJ_RTOL)
        _close(p["hist"]["val_loss"], run["accum_hist"]["val_loss"], TRAJ_RTOL)
    assert parts[0]["stats"] == parts[1]["stats"]
    sd = run["accum_state"].model.state_dict()
    for k, v in parts[0]["stats"].items():
        np.testing.assert_allclose(v, sd[k].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_checkpoints_written_by_rank_0_only(run):
    """Every file under the save dirs is moved into place by rank 0, and
    the 2-rank run leaves the single-process run's files with its keys."""
    parts = _part(run, "checkpoints")
    assert parts[1]["writes"] == [] and parts[0]["writes"]
    work = run["work"]
    one = sorted(os.listdir(os.path.join(work, "ck_c", "unext_s")))
    two = sorted(os.listdir(os.path.join(work, "ck_b", "unext_s")))
    assert set(one) <= set(two), (one, two)
    assert "unext_s_best.npz" in one and "unext_s_epoch_1" in one
    a = torch.load(os.path.join(work, "ck_c", "unext_s", "unext_s_epoch_1", "state.pt"),
                   weights_only=True)
    b = torch.load(os.path.join(work, "ck_b", "unext_s", "unext_s_epoch_1", "state.pt"),
                   weights_only=True)
    assert a.keys() == b.keys() and a["model"].keys() == b["model"].keys()
    za = np.load(os.path.join(work, "ck_c", "unext_s", "unext_s_best.npz"))
    zb = np.load(os.path.join(work, "ck_b", "unext_s", "unext_s_best.npz"))
    assert sorted(za.files) == sorted(zb.files)


def test_exact_resume_under_two_ranks(run):
    """One epoch, then a resumed second, ends where two straight epochs
    end, on each rank: same weights, same history."""
    for p in _part(run, "checkpoints"):
        assert p["same_state"] and p["steps"] == [4, 4]
        assert p["hist_a"]["train_loss"] == p["hist_b"]["train_loss"]
        assert p["hist_a"]["val_loss"] == p["hist_b"]["val_loss"]


def test_cli_train_under_two_ranks(run):
    """``cli.train --device cpu`` on 2 ranks: rank 0 prints the mesh over
    the ranks and the epochs, rank 1 prints nothing; the history is written."""
    out0, out1 = (p["stdout"] for p in _part(run, "cli"))
    assert "Mesh: {'data': 2, 'model': 1, 'spatial': 1} over 2 device(s)" in out0, out0
    assert "Epoch [1/1]" in out0 and "kernel launches: " in out0
    assert out1 == ""
    hist = json.load(open(os.path.join(run["work"], "ck_cli", "unext_s", "loss_history.json")))
    assert len(hist["train_loss"]) == 1 and np.isfinite(hist["train_loss"][0])


FAMILIES = tuple(MODEL_REGISTRY)


@pytest.mark.parametrize("name", FAMILIES)
def test_every_parameter_gets_a_gradient(name):
    """DDP (without ``find_unused_parameters``) needs a gradient for every
    parameter of the train forward; each family's ``auto`` loss gives one."""
    cfg = ModelConfig(name=name, fft_mask_range=MASK_RANGE)
    widths = {"eelunet": NARROW, "unet": UNET_NARROW}.get(name)
    model, meta = create_model(cfg, widths=widths)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last).train()
    from eelunet_tpu_torch import losses as L

    loss_fn = make_loss_fn(L.resolve_loss_name("auto", name), TrainConfig().loss, meta)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 64, 64, 3)).astype(np.float32))
    y = torch.from_numpy((rng.random((2, 64, 64, 1)) > 0.5).astype(np.float32))
    forward_loss(model, loss_fn, x, y).backward()
    assert [n for n, p in model.named_parameters() if p.grad is None] == []


def test_single_process_trainer_keeps_one_device():
    """Without a process group the Trainer's data axis is 1: a mesh whose
    data axis spans devices of one process is refused (launch a process per
    device), and ``mesh.data_axis=2`` raises JAX's ValueError."""
    cfg = apply_overrides(TrainConfig(), ["model.name=unext_s"])
    with pytest.raises(ValueError, match="processes"):
        Trainer(cfg, device="cpu", mesh=create_mesh(2, devices=["cpu", "cpu"]))
    with pytest.raises(ValueError, match="needs more than 1 devices"):
        Trainer(apply_overrides(cfg, ["mesh.data_axis=2"]), device="cpu")
    assert Trainer(cfg, device="cpu").mesh.shape == {"data": 1, "model": 1, "spatial": 1}
