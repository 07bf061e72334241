"""Asynchronous checkpoint writes in the port (``async_checkpoint``, on by
default), mirroring tests/test_async_checkpoint.py: ``fit`` with the
background writer gives the files of the synchronous ``fit``; a background
save keeps the state of its call through later in-place updates; writes
land in order; a failed write is raised on the next call."""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import pytest
import torch

from eelunet_tpu_torch.config import TrainConfig, apply_overrides
from eelunet_tpu_torch.data.pipeline import DataLoader
from eelunet_tpu_torch.data.synthetic import SyntheticDataset
from eelunet_tpu_torch.inference import read_checkpoint
from eelunet_tpu_torch.train.checkpoint import CheckpointManager
from eelunet_tpu_torch.train.trainer import Trainer


def _cfg(tmp_path, sub, async_ckpt):
    return apply_overrides(TrainConfig(), [
        "model.name=unext_s", "data.image_size=[32,32]", "data.batch_size=4", "seed=0",
        f"save_dir={tmp_path}/{sub}/ckpt", f"log_dir={tmp_path}/{sub}/runs", "epochs=3",
        "snapshot_every=2", "keep_snapshots=1", "optimizer.lr=0.003",
        f"async_checkpoint={json.dumps(async_ckpt)}"])


def _state_equal(a, b):
    """Nested state dicts equal, tensors bit for bit."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_state_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_state_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_async_fit_matches_sync_fit(tmp_path):
    """Same seed, writer on and off: the same history, the same files, bit
    for bit (tags, the pruned epoch_2 snapshot, last, best_meta.json)."""
    files = {}
    for mode in (True, False):
        cfg = _cfg(tmp_path, f"async_{mode}", mode)
        trainer = Trainer(cfg, device="cpu")
        ds = SyntheticDataset(n=8, image_size=(32, 32), seed=0)
        loader = DataLoader(ds, batch_size=4, shuffle=True, seed=0, num_workers=1)
        _, history = trainer.fit(loader, loader, loader, log=lambda *a: None)
        root = os.path.join(cfg.save_dir, "unext_s")
        names = sorted(os.listdir(root))
        snaps = {d: torch.load(os.path.join(root, d, "state.pt"), weights_only=True)
                 for d in ("unext_s_epoch_2", "unext_s_last")}
        tags = {}
        for n in names:
            if n.endswith(".npz"):
                with np.load(os.path.join(root, n)) as f:
                    tags[n] = {k: f[k] for k in f.files}
        with open(os.path.join(root, "best_meta.json")) as f:
            files[mode] = (history, names, snaps, tags, json.load(f))
    (ha, na, sa, ta, ma), (hs, ns, ss, ts, ms) = files[True], files[False]
    assert ha["train_loss"] == hs["train_loss"] and ha["val_loss"] == hs["val_loss"]
    assert na == ns and ma == ms
    assert _state_equal(sa, ss)
    assert ta.keys() == ts.keys()
    for n in ta:
        for k in ta[n]:
            np.testing.assert_array_equal(ta[n][k], ts[n][k])


def test_background_save_outlives_later_steps(tmp_path):
    """A background save holds the state of its call, though the next steps
    change the very tensors it was given in place (``optimizer.step()``, BN
    statistics, then a zeroing) before the writer runs."""
    cfg = _cfg(tmp_path, "later", True)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(steps_per_epoch=2)
    step = trainer._get_step("train")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 32, 32, 3)).astype(np.float32))
    y = torch.from_numpy((rng.uniform(size=(4, 32, 32, 1)) > 0.5).astype(np.float32))
    step(state, x, y)  # Adam moments exist
    want = {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in state.model.state_dict().items()}
    want_opt = {i: {k: v.clone() for k, v in s.items()}
                for i, s in state.optimizer.state_dict()["state"].items()}
    gate = threading.Event()
    trainer.ckpt.run_after_saves(gate.wait)  # hold the writer until the steps ran
    path = trainer.ckpt.save("later", state, epoch=1, background=True)
    tags = trainer.ckpt.save_weights_tags(["best"], state.model.state_dict(), background=True)
    for _ in range(2):
        step(state, x, y)
    with torch.no_grad():
        for p in state.model.parameters():
            p.zero_()
    assert not os.path.exists(os.path.join(path, "state.pt"))  # still queued
    gate.set()
    trainer.ckpt.wait()
    saved = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    assert any(bool(v.abs().sum() > 0) for v in want.values() if v.is_floating_point())
    assert _state_equal(saved["model"], want)
    assert _state_equal(saved["optimizer"]["state"], want_opt)
    assert saved["step"] == 1
    tag = read_checkpoint(tags[0], "unext_s")
    assert _state_equal({k: v for k, v in tag.items() if not k.endswith("tracked")},
                        {k: v for k, v in want.items() if not k.endswith("tracked")})


def test_write_ordering_and_failure_propagation(tmp_path):
    mgr = CheckpointManager(str(tmp_path), "unext_s", async_writes=True)
    order = []
    mgr.run_after_saves(lambda: order.append(1))
    mgr.run_after_saves(lambda: order.append(2))
    mgr.wait()
    assert order == [1, 2]

    def boom():
        raise OSError("disk on fire")

    mgr.run_after_saves(boom)
    mgr.run_after_saves(lambda: order.append(3))  # skipped after a failure
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        mgr.wait()
    assert order == [1, 2]
    mgr.run_after_saves(lambda: order.append(4))  # the failure was consumed
    mgr.wait()
    assert order == [1, 2, 4]
    mgr.run_after_saves(boom)
    mgr._async._q.join()
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        mgr.run_after_saves(lambda: order.append(5))  # raised on the next submit
    assert order == [1, 2, 4]


def test_sync_manager_runs_inline(tmp_path):
    mgr = CheckpointManager(str(tmp_path), "unext_s", async_writes=False)
    order = []
    mgr.run_after_saves(lambda: order.append("now"))
    assert order == ["now"]
    mgr.wait()  # no-op


def test_direct_save_is_synchronous_even_with_writer(tmp_path):
    """Direct calls (no ``background=``) can be read when they return."""
    cfg = _cfg(tmp_path, "direct", True)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    path = trainer.ckpt.save("direct_test", state)
    assert os.path.exists(os.path.join(path, "framework_meta.json"))
    assert os.path.isfile(trainer.ckpt.save_weights_tags(["best"],
                                                         state.model.state_dict())[0])
