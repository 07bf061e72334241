"""Subprocess body of the port's multi-rank tests on the CPU
(tests/test_torch_port_distributed.py, tests/test_torch_port_ddp.py).

``spawn`` starts ``world`` copies of this file, one per rank, as
tests/_distributed_worker.py does for the JAX package. The ranks join one
gloo group through ``init_method=file://`` under the test's directory (no
TCP port, so parallel test workers cannot collide), run one scenario with
one thread each, and write their results as JSON. Each subprocess streams
its output to ``rank<r>.log`` there and has its own timeout. This file
imports torch and the port only: the parent test brings what it needs from
the JAX package in ``inputs.pt``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn(scenario: str, workdir: str, world: int = 2, timeout: float = 240.0):
    """Run ``scenario`` on ``world`` ranks; returns their results, rank
    order. A rank that fails or outlives ``timeout`` fails the call with the
    end of its log."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    init = f"file://{os.path.join(workdir, 'rendezvous')}"
    procs = []
    for rank in range(world):
        log = open(os.path.join(workdir, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__), scenario, str(rank), str(world),
             workdir, init], stdout=log, stderr=subprocess.STDOUT, env=env, cwd=workdir), log))
    deadline = time.monotonic() + timeout
    failures = []
    try:
        for rank, (proc, _) in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                rc = f"timeout after {timeout:.0f} s"
            if rc != 0:
                failures.append((rank, rc))
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if failures:
        tails = "\n".join(
            f"--- rank {r} ({rc}):\n" + open(os.path.join(workdir, f"rank{r}.log")).read()[-3000:]
            for r, rc in failures)
        raise AssertionError(f"scenario {scenario!r} failed:\n{tails}")
    out = []
    for rank in range(world):
        with open(os.path.join(workdir, f"result{rank}.json")) as f:
            out.append(json.load(f))
    return out


def _rel(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got - want).abs().max() / want.abs().max())


# ------------------------------------------------------------------ scenarios

def runtime(rank: int, world: int, workdir: str):
    """The runtime's functions in a real group, and the global-batch BN
    against ``nn.BatchNorm2d`` on the whole batch (float32, three train
    steps: outputs, input and affine gradients, running statistics)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from eelunet_tpu_torch.nn.layers import BatchNorm2d, sync_batch_norms
    from eelunet_tpu_torch.parallel.distributed import (
        assemble_global_batch,
        barrier,
        is_primary,
        process_count,
        process_index,
        process_shard_spec,
        sync_seed,
    )
    from eelunet_tpu_torch.parallel.mesh import create_mesh

    np.random.seed(1000 + rank)  # each rank draws differently; rank 0's wins
    rows = np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * rank
    mesh = create_mesh()
    out = {"index": process_index(), "count": process_count(), "primary": is_primary(),
           "shard": process_shard_spec(), "seed": sync_seed(None),
           "assembled": assemble_global_batch(rows, "cpu").tolist(),
           "mesh": mesh.shape, "mesh_devices": mesh.devices.ravel().tolist()}
    barrier()

    rng = np.random.default_rng(0)
    b, c = 8, 6
    x = torch.from_numpy(rng.standard_normal((b, c, 5, 7)).astype(np.float32) * 3 + 1.5)
    g = torch.from_numpy(rng.standard_normal((b, c, 5, 7)).astype(np.float32))
    ref = torch.nn.BatchNorm2d(c)
    with torch.no_grad():
        ref.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
        ref.bias.copy_(torch.from_numpy(rng.standard_normal(c).astype(np.float32)))
    bn = sync_batch_norms(BatchNorm2d(c), dist.group.WORLD)
    bn.load_state_dict(ref.state_dict())
    k = b // world
    mine = slice(rank * k, (rank + 1) * k)
    xr, xl = x.clone().requires_grad_(), x[mine].clone().requires_grad_()
    for _ in range(3):
        yr = ref(xr)
        (yr * g).sum().backward()
        yl = bn(xl)
        (yl * g[mine]).sum().backward()
    for t in (bn.weight.grad, bn.bias.grad):  # what DDP reduces
        dist.all_reduce(t)
    out["bn"] = {"output": _rel(yl, yr[mine]), "input_grad": _rel(xl.grad, xr.grad[mine]),
                 "weight_grad": _rel(bn.weight.grad, ref.weight.grad),
                 "bias_grad": _rel(bn.bias.grad, ref.bias.grad),
                 "running_mean": _rel(bn.running_mean, ref.running_mean),
                 "running_var": _rel(bn.running_var, ref.running_var),
                 "num_batches_tracked": int(bn.num_batches_tracked)}
    return out


def ddp(rank: int, world: int, workdir: str):
    """Data-parallel fits, evaluation, checkpoints, resume and the train CLI
    on the inputs of test_torch_port_ddp.py. Each part records its result
    or its error, so the tests fail one by one."""
    import numpy as np
    import torch

    from eelunet_tpu_torch.config import TrainConfig, apply_overrides
    from eelunet_tpu_torch.data.pipeline import DataLoader
    from eelunet_tpu_torch.train import checkpoint
    from eelunet_tpu_torch.train.trainer import Trainer

    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    train, test = inp["train"], inp["test"]
    out = {}

    def part(name, fn):
        try:
            out[name] = fn()
        except Exception:  # recorded; the test of this part fails with it
            out[name] = {"error": traceback.format_exc()}

    def fit(sets, sd, save="ck"):
        cfg = apply_overrides(TrainConfig(), inp["overrides"] + sets
                              + [f"save_dir={workdir}/{save}", f"log_dir={workdir}/runs"])
        trainer = Trainer(cfg, device="cpu")
        state = trainer.init_state(len(train) // 8)
        state.model.load_state_dict(sd)
        loaders = (DataLoader(train, 8, shuffle=True, seed=cfg.seed, num_workers=1,
                              process_shard=(rank, world), accum_steps=cfg.accum_steps),
                   DataLoader(test, 4, drop_remainder=False, num_workers=1),
                   DataLoader(test, 4, drop_remainder=False, num_workers=1))
        state, hist = trainer.fit(*loaders, state=state, log=lambda *a, **k: None)
        return trainer, state, hist

    def running_stats(state):
        return {k: v.tolist() for k, v in state.model.state_dict().items()
                if k.endswith(("running_mean", "running_var"))}

    part("jax_fit", lambda: fit([], inp["unext_s"])[2])
    part("flip_fit", lambda: fit(["data.random_flip=true"], inp["unext_s"])[2])

    def ragged_eval():
        cfg = apply_overrides(TrainConfig(), inp["overrides"] + [f"save_dir={workdir}/ck_eval"])
        trainer = Trainer(cfg, device="cpu")
        state = trainer.init_state()
        state.model.load_state_dict(inp["unext_s"])
        return trainer.evaluate(state, DataLoader(test, 4, drop_remainder=False, num_workers=1))

    part("ragged_eval", ragged_eval)

    def accum():
        _, state, hist = fit(inp["accum_sets"], inp["unext_s"], save="ck_acc")
        return {"hist": hist, "stats": running_stats(state)}

    part("accum", accum)

    def checkpoints_and_resume():
        writes = []  # files this rank moved into place under a save_dir
        real_replace = checkpoint.os.replace

        def recording_replace(src, dst):
            writes.append(os.path.relpath(dst, workdir))
            return real_replace(src, dst)

        checkpoint.os.replace = recording_replace
        try:
            sets = ["snapshot_every=1", "epochs=2"]
            _, straight, hist_a = fit(sets, inp["unext_s"], save="ck_a")
            fit(["snapshot_every=1", "epochs=1"], inp["unext_s"], save="ck_b")
            _, resumed, hist_b = fit(sets + ["resume_from=auto"], inp["unext_s"], save="ck_b")
        finally:
            checkpoint.os.replace = real_replace
        same = all(torch.equal(v, resumed.model.state_dict()[k])
                   for k, v in straight.model.state_dict().items())
        return {"writes": sorted(writes), "hist_a": hist_a, "hist_b": hist_b,
                "same_state": same, "steps": [straight.step, resumed.step]}

    part("checkpoints", checkpoints_and_resume)

    def cli_train():
        from eelunet_tpu_torch.cli import train as train_cli

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train_cli.main(["--device", "cpu", "--model_type", "unext_s", "--data_dir",
                            inp["tree"], "--image_size", "32", "--batch_size", "4",
                            "--epochs", "1", "--save_dir", f"{workdir}/ck_cli",
                            "--log_dir", f"{workdir}/runs_cli", "--set", "data.num_workers=1"])
        return {"stdout": buf.getvalue()}

    part("cli", cli_train)
    return out


SCENARIOS = {"runtime": runtime, "ddp": ddp}


def main() -> None:
    scenario, rank, world, workdir, init = sys.argv[1:6]
    rank, world = int(rank), int(world)
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)
    from eelunet_tpu_torch.parallel.distributed import init_distributed, shutdown_distributed

    assert init_distributed(init, world, rank, device="cpu")
    result = SCENARIOS[scenario](rank, world, workdir)
    with open(os.path.join(workdir, f"result{rank}.json"), "w") as f:
        json.dump(result, f)
    shutdown_distributed()


if __name__ == "__main__":
    main()
