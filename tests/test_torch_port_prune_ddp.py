"""``cli.prune`` under a process group on the CPU: the port's CLI on 2 gloo
ranks (the ``prune`` scenario of tests/torch_port_ddp_worker.py) against
the same CLI in a single process on the same global batch.

Two runs, each at 32x32, global batch 8 (4 rows per rank), one finetune
epoch of 2 steps, 10 test images (a batch of 8 split over the ranks, then
one of 2):
- UNeXt-S (published width, random BN statistics), the masked finetune;
- the narrow U-Net with ``--physical`` (channels rounded to 4): the masked
  finetune, then the slice and the slim model's evaluation.

The ranks must print and write once (rank 0), agree with each other on
every metric and every parameter, keep the masked channels exactly zero,
and agree with the single process within the bounds of
tests/test_torch_port_ddp.py: the original and pruned rows are the same
weights evaluated on split batches (EVAL_REL), the finetuned and slim rows
come after two DDP steps (TRAJ_RTOL)."""

from __future__ import annotations

import os
import threading

import numpy as np
import pytest
import torch

from eelunet_tpu_torch import prune as P
from eelunet_tpu_torch.data.synthetic import write_synthetic_tree
from eelunet_tpu_torch.inference import read_checkpoint
from eelunet_tpu_torch.models.convert import from_flax_variables, to_upstream_state_dict
from eelunet_tpu_torch.models.unet import Unet
from eelunet_tpu_torch.nn.layers import init_weights
from torch_port_ddp_worker import prune as prune_scenario
from torch_port_ddp_worker import spawn
from torch_port_families import UNET_NARROW, family_variables, port_model
from torch_port_helpers import once_per_run

# tests/test_torch_port_ddp.py's bounds (JAX's tests/test_sharding.py).
TRAJ_RTOL, EVAL_REL = 2e-4, 1e-5
LABELS = ("unext_s", "unet")


def _inputs(work: str, save: str, tree: str, ckpts: dict):
    common = ["--device", "cpu", "--data_dir", tree, "--image_size", "32", "--batch_size", "8",
              "--seed", "0", "--prune_amount", "0.3", "--finetune_epochs", "1", "--save_dir",
              os.path.join(work, save), "--set", f"log_dir={work}/runs", "--set",
              "data.num_workers=1"]
    runs = [("unext_s", common + ["--model_type", "unext_s", "--checkpoint", ckpts["unext_s"]],
             None),
            ("unet", common + ["--model_type", "unet", "--checkpoint", ckpts["unet"],
                               "--physical", "--prune_round_to", "4"], UNET_NARROW)]
    torch.save({"runs": runs}, os.path.join(work, "inputs.pt"))


def _make(work: str):
    """The 2-rank spawn (in a thread) and the single-process runs (here)."""
    tree = write_synthetic_tree(os.path.join(work, "tree"), n_train=18, n_test=10,
                                image_size=(32, 32))
    unet = init_weights(Unet(**UNET_NARROW), torch.Generator().manual_seed(0)).state_dict()
    ckpts = {"unext_s": os.path.join(work, "unext_s.npz"), "unet": os.path.join(work, "unet.npz")}
    np.savez(ckpts["unext_s"], **to_upstream_state_dict(
        from_flax_variables(family_variables("unext_s"), "unext_s"), "unext_s"))
    np.savez(ckpts["unet"], **to_upstream_state_dict(unet, "unet"))
    two, one = os.path.join(work, "two"), os.path.join(work, "one")
    for w in (two, one):
        os.makedirs(w)
        _inputs(w, "ck", tree, ckpts)
    ranks = {}

    def ddp():
        try:
            ranks["out"] = spawn("prune", two, timeout=300)
        except BaseException as e:  # raised below, once the single process is done
            ranks["error"] = e

    thread = threading.Thread(target=ddp)
    thread.start()
    try:
        single = prune_scenario(0, 1, one)
    finally:
        thread.join()
    if "error" in ranks:
        raise ranks["error"]
    params = {(r, label): torch.load(os.path.join(w, f"params{i}_{label}.pt"))
              for label in LABELS for r, i, w in ((0, 0, two), (1, 1, two), ("single", 0, one))}
    masks = {}
    for label, path, physical in (("unext_s", ckpts["unext_s"], False),
                                  ("unet", ckpts["unet"], True)):
        model = Unet(**UNET_NARROW) if label == "unet" else port_model("unext_s")
        model.load_state_dict(read_checkpoint(path, label), strict=True)
        masks[label] = P.compute_prune_masks(model, 0.3, zero_bias=physical,
                                             round_to=4 if physical else 1)[0]
    return {"ranks": ranks["out"], "single": single, "params": params, "masks": masks,
            "two": two}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return once_per_run(tmp_path_factory, "prune_ddp", _make)


@pytest.mark.parametrize("label", LABELS)
def test_metric_rows_match_the_single_process(runs, label):
    """Original, pruned, finetuned (and for ``--physical`` the slim model):
    equal on both ranks, each the metrics of the whole test split, and the
    single process's within EVAL_REL (same weights) and TRAJ_RTOL (after the
    DDP finetune)."""
    r0, r1 = (r[label]["evals"] for r in runs["ranks"])
    want = runs["single"][label]["evals"]
    assert r0 == r1
    assert len(r0) == len(want) == (4 if label == "unet" else 3)
    for i, (got, ref) in enumerate(zip(r0, want)):
        rel = EVAL_REL if i < 2 else TRAJ_RTOL
        assert set(got) == set(ref)
        for k in ref:
            assert got[k] == pytest.approx(ref[k], rel=rel, abs=1e-12), (i, k)


@pytest.mark.parametrize("label", LABELS)
def test_ranks_hold_equal_parameters_and_zero_masked_channels(runs, label):
    """After the finetune both ranks hold the same parameters, bit for bit,
    and every masked channel is exactly zero, as in the single process.
    (The parameters themselves are not held to the single process's: Adam
    moves a bias before a batch norm, whose gradient is rounding noise, by
    about lr in the direction the noise picks; the metric rows are.)"""
    p0, p1 = runs["params"][(0, label)], runs["params"][(1, label)]
    single = runs["params"][("single", label)]
    assert p0.keys() == p1.keys() == single.keys()
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert any(bool((m == 0).any()) for m in runs["masks"][label].values())
    for name, mask in runs["masks"][label].items():
        for p in (p0, single):
            assert bool((p[name][mask == 0] == 0).all()), name


@pytest.mark.parametrize("label", LABELS)
def test_rank_0_alone_prints_and_writes(runs, label):
    """Rank 0 prints the runtime line, the comparison table and the launches
    and moves every file into place; rank 1 prints nothing and writes
    nothing. One tag (and, with ``--physical``, one slim checkpoint) lands,
    as in the single process."""
    out0, out1 = (r[label] for r in runs["ranks"])
    assert "Distributed runtime: 2 processes" in out0["stdout"]
    assert "metric          original   pruned  finetuned" in out0["stdout"]
    assert "kernel launches: " in out0["stdout"] and out1["stdout"] == ""
    assert out1["writes"] == [] and out1["slims"] == []
    tag = f"ck/{label}/{label}_pruned_30"
    assert out0["writes"] and all(w.startswith((tag + "/", tag + "_slim/"))
                                  for w in out0["writes"])
    assert out0["writes"] == runs["single"][label]["writes"]
    assert out0["slims"] == ([tag + "_slim"] if label == "unet" else [])
    root = os.path.join(runs["two"], "ck", label)
    want = {f"{label}_pruned_30"} | ({f"{label}_pruned_30_slim"} if label == "unet" else set())
    assert set(os.listdir(root)) == want
