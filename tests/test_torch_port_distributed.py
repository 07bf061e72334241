"""The port's distributed runtime and mesh on the CPU, against the JAX
package's: the process-sharded loader's rows, ``choose_batch_placement``,
``create_mesh``'s shapes and errors on the 8 virtual CPU devices, and, on 2
gloo ranks (tests/torch_port_ddp_worker.py, ``runtime`` scenario), the
runtime's functions and the global-batch BatchNorm against
``nn.BatchNorm2d`` on the whole batch."""

from __future__ import annotations

import itertools

import jax
import numpy as np
import pytest
import torch

from eelunet_tpu.data.pipeline import DataLoader as JaxDataLoader
from eelunet_tpu.parallel.mesh import create_mesh as jax_create_mesh
from eelunet_tpu.train.trainer import choose_batch_placement as jax_choose_batch_placement
from eelunet_tpu_torch.data.pipeline import DataLoader, process_rows
from eelunet_tpu_torch.parallel import distributed
from eelunet_tpu_torch.parallel.mesh import Mesh, create_mesh
from eelunet_tpu_torch.train.trainer import choose_batch_placement
from torch_port_ddp_worker import spawn
from torch_port_helpers import once_per_run


class _Index:
    """Sample i is an image filled with i (and its mask)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        x = np.full((2, 2, 3), float(i), np.float32)
        return x, x[..., :1]


def _rows(loader):
    return [b[0][:, 0, 0, 0].tolist() for b in loader]


@pytest.mark.parametrize("pc", [2, 4])
def test_process_sharded_loader_equals_jax(pc):
    """Each rank's batches hold exactly the JAX loader's rows for that
    process, over two epochs of the seed + epoch shuffle, and the ranks
    together cover every global batch."""
    ds = _Index(37)
    for pid in range(pc):
        mine = DataLoader(ds, 8, shuffle=True, seed=5, num_workers=1, process_shard=(pid, pc))
        jax_loader = JaxDataLoader(ds, 8, shuffle=True, seed=5, num_workers=1,
                                   process_shard=(pid, pc))
        for epoch in range(2):
            mine.set_epoch(epoch)
            jax_loader.set_epoch(epoch)
            assert _rows(mine) == _rows(jax_loader)
    whole = DataLoader(ds, 8, shuffle=True, seed=5, num_workers=1)
    shards = [_rows(DataLoader(ds, 8, shuffle=True, seed=5, num_workers=1,
                               process_shard=(p, pc))) for p in range(pc)]
    for b, batch in enumerate(_rows(whole)):
        assert sum((s[b] for s in shards), []) == batch


@pytest.mark.parametrize("pc,accum", [(2, 2), (2, 4), (4, 2)])
def test_process_rows_hold_each_micro_batch(pc, accum):
    """With gradient accumulation, rank p's local micro-batch i is its share
    of JAX's micro-batch i, global rows [i mb, (i+1) mb)."""
    b = 16
    mb, k = b // accum, b // (pc * accum)
    for i in range(accum):
        got = sorted(r for p in range(pc) for r in process_rows(p, pc, b, accum)[i * k:(i + 1) * k])
        assert got == list(range(i * mb, (i + 1) * mb))
    assert process_rows(1, 2, 8).tolist() == [4, 5, 6, 7]  # JAX's slice at accum 1


def test_process_shard_validation():
    """JAX's refusals, and the micro-batches that must divide among the ranks."""
    ds = _Index(16)
    with pytest.raises(ValueError, match="out of range"):
        DataLoader(ds, 8, process_shard=(2, 2))
    with pytest.raises(ValueError, match="drop_remainder"):
        DataLoader(ds, 8, drop_remainder=False, process_shard=(0, 2))
    with pytest.raises(ValueError, match="not divisible by 3"):
        DataLoader(ds, 8, process_shard=(0, 3))
    with pytest.raises(ValueError, match="accum_steps 4"):
        DataLoader(ds, 4, process_shard=(0, 2), accum_steps=4)
    assert DataLoader(ds, 8, process_shard=(0, 1)).process_shard is None


def test_choose_batch_placement_equals_jax():
    grid = itertools.product((1, 2, 3, 4, 6, 8), (16, 30, 32), (1, 2, 4, 8), (1, 2, 4),
                             (1, 2, 4), (False, True))
    n = 0
    for rows, h, n_data, n_sp, pc, sharded in grid:
        try:
            want = jax_choose_batch_placement(rows, h, n_data, n_sp, pc, sharded)
        except ValueError as e:
            with pytest.raises(ValueError, match="cannot be replicated"):
                choose_batch_placement(rows, h, n_data, n_sp, pc, sharded)
            assert "cannot be replicated" in str(e)
            continue
        assert choose_batch_placement(rows, h, n_data, n_sp, pc, sharded) == want
        n += 1
    assert n > 500


@pytest.mark.parametrize("axes", [(-1, 1, 1), (1, 1, 1), (2, 1, 1), (4, 1, 1), (8, 1, 1),
                                  (16, 1, 1), (-1, 3, 1), (3, 1, 1)])
def test_create_mesh_equals_jax(axes):
    """Shapes and ValueErrors of the data axis, over JAX's 8 virtual CPU
    devices and as many CPU entries in the port."""
    assert jax.device_count() == 8
    cpus = [torch.device("cpu")] * 8
    try:
        want = jax_create_mesh(*axes)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            create_mesh(*axes, devices=cpus)
        assert str(got.value) == str(e)
        return
    mesh = create_mesh(*axes, devices=cpus)
    assert mesh.shape == dict(want.shape)
    assert mesh.devices.shape == want.devices.shape


def test_create_mesh_refuses_the_model_and_spatial_axes():
    cpus = ["cpu"] * 4
    for axes in ((-1, 2, 1), (-1, 1, 2), (1, 2, 2)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            create_mesh(*axes, devices=cpus)
    mesh = create_mesh(2, devices=["cpu", "cpu"])
    assert isinstance(mesh, Mesh) and mesh.data_devices == [torch.device("cpu")] * 2


def test_single_process_runtime_is_a_noop(monkeypatch):
    """No coordinator and no torchrun environment: a single-process run."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.init_distributed(device="cpu") is False
    assert distributed.process_shard_spec() is None and distributed.is_primary()
    assert distributed.sync_seed(7) == 7 and distributed.process_count() == 1
    t = distributed.all_reduce_sum_(torch.ones(2))
    assert t.tolist() == [1.0, 1.0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            distributed.init_distributed("localhost:1", 2, 0)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return once_per_run(tmp_path_factory, "runtime",
                        lambda work: spawn("runtime", work, timeout=180))


def test_process_group_runtime(ranks):
    """Two ranks: each knows its index, rank 0 is the primary, the loader
    shard spec, rank 0's seed on both, local rows assembled on the rank's
    device, and a mesh whose data axis spans the ranks."""
    for r, out in enumerate(ranks):
        assert out["index"] == r and out["count"] == 2 and out["primary"] == (r == 0)
        assert out["shard"] == [r, 2]
        assert out["assembled"] == (np.arange(6).reshape(2, 3) + 10 * r).tolist()
        assert out["mesh"] == {"data": 2, "model": 1, "spatial": 1}
        assert out["mesh_devices"] == [0, 1]
    assert ranks[0]["seed"] == ranks[1]["seed"]


@pytest.mark.parametrize("what", ["output", "input_grad", "weight_grad", "bias_grad",
                                  "running_mean", "running_var"])
def test_global_batch_norm_equals_whole_batch(ranks, what):
    """Three train steps of the global-batch BN on 4 rows per rank against
    ``nn.BatchNorm2d`` on all 8 rows, float32: max |d| over max |ref|
    within 1e-6 (the running variance Bessel-corrected over the global
    count)."""
    for out in ranks:
        assert out["bn"][what] <= 1e-6, out["bn"]
        assert out["bn"]["num_batches_tracked"] == 3
