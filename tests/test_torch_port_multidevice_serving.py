"""Batch-parallel serving on the CPU: ``Predictor(mesh=...)`` over two CPU
devices against the JAX package's Predictor on a 2-device data mesh, on the
narrow EELUnet of tests/test_torch_port_serving.py (BN folded on each side
by its own package), at that file's bound; the dispatch/collect contract,
reloads, the service's stats and the refusals of the mesh axes not ported."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from eelunet_tpu.bnfold import fold_bn_eval as jax_fold_bn_eval
from eelunet_tpu.config import ModelConfig as JaxModelConfig
from eelunet_tpu.inference import Predictor as JaxPredictor
from eelunet_tpu.models.eelunet import EELUnet as JaxEELUnet
from eelunet_tpu.parallel.mesh import create_mesh as jax_create_mesh
from eelunet_tpu_torch.cli import serve as serve_cli
from eelunet_tpu_torch.config import ModelConfig
from eelunet_tpu_torch.inference import Predictor, build_serving_model
from eelunet_tpu_torch.models.convert import from_flax_variables
from eelunet_tpu_torch.parallel.mesh import Mesh, create_mesh
from eelunet_tpu_torch.serving import SegmentationService
from torch_port_helpers import MASK_RANGE, NARROW, narrow_flax_variables

CFG = ModelConfig(name="eelunet", fft_mask_range=MASK_RANGE)
TOL = 5e-4  # tests/test_torch_port_serving.py: the EELUnet forward bound, folded f32


def _narrow(variables):
    return build_serving_model(from_flax_variables(variables), CFG, "cpu", widths=NARROW)


@pytest.fixture(scope="module")
def predictors():
    variables = narrow_flax_variables()
    jpred = JaxPredictor(JaxModelConfig(name="eelunet", fft_mask_range=MASK_RANGE),
                         mesh=jax_create_mesh(2, 1))
    params, stats, _ = jax_fold_bn_eval("eelunet", variables["params"], variables["batch_stats"])
    jpred.commit((JaxEELUnet(mask_range=MASK_RANGE, widths=NARROW, bn_folded=True),
                  params, stats))
    jpred._replicate_weights()
    pred = Predictor(CFG, mesh=create_mesh(2, devices=["cpu", "cpu"]), device="cpu")
    pred.commit(_narrow(variables))
    single = Predictor(CFG, device="cpu")
    single.commit(_narrow(variables))
    return jpred, pred, single


@pytest.mark.parametrize("b", [1, 2, 3, 4, 5])
def test_mesh_predictor_matches_jax_mesh_predictor(predictors, b):
    """Equal shards on each device (a ragged batch pads up to a multiple of
    the data size), gathered in order: JAX's 2-device Predictor's output."""
    jpred, pred, _ = predictors
    u8 = np.random.default_rng(b).integers(0, 256, (b, 64, 64, 3), dtype=np.uint8)
    want = jpred.predict_proba(u8)
    got = pred.predict_proba(u8)
    assert got.shape == (b, 64, 64, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_mesh_predictor_equals_one_device(predictors):
    """Each shard runs the single-device forward on its rows."""
    _, pred, single = predictors
    u8 = np.random.default_rng(9).integers(0, 256, (6, 64, 64, 3), dtype=np.uint8)
    np.testing.assert_allclose(pred.predict_proba(u8), single.predict_proba(u8),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(pred.predict(u8), single.predict(u8))


def test_dispatch_collect_on_the_mesh(predictors):
    """``collect(dispatch(b)) == predict(b)``, with one output per device;
    a bucket of 3 becomes 4 rows, 2 per device."""
    _, pred, _ = predictors
    assert pred.data_size == 2 and len(pred.replicas) == 2
    assert pred.replicas[0] is not pred.replicas[1]
    u8 = np.random.default_rng(3).integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    handle = pred.dispatch_proba(u8)
    outs, b, _ = handle
    assert b == 3 and [o.shape[0] for o in outs] == [2, 2]
    np.testing.assert_array_equal(pred.collect(handle), pred.predict_proba(u8))
    masks = pred.collect(pred.dispatch_mask_wire(u8))
    assert masks.dtype == np.uint8 and masks.shape == (3, 64, 64, 1)


def test_commit_swaps_every_replica(predictors):
    """A staged model replaces the model on every device."""
    variables = narrow_flax_variables(seed=1)
    pred = Predictor(CFG, mesh=create_mesh(2, devices=["cpu", "cpu"]), device="cpu")
    pred.commit(_narrow(variables))
    single = Predictor(CFG, device="cpu")
    single.commit(_narrow(variables))
    u8 = np.random.default_rng(5).integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    np.testing.assert_allclose(pred.predict_proba(u8), single.predict_proba(u8), atol=1e-6)
    _, _, single0 = predictors
    assert np.abs(pred.predict_proba(u8) - single0.predict_proba(u8)).max() > 1e-3


def test_service_reports_the_data_size(predictors):
    _, pred, single = predictors
    for p, n in ((pred, 2), (single, 1)):
        service = SegmentationService(p, (64, 64), max_batch=4, window_ms=1.0)
        try:
            u8 = np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)
            kind, row = service.batcher.submit(u8).result(timeout=60)
            assert kind == "proba" and row.shape == (64, 64, 1)
            assert service.stats()["data_size"] == n
        finally:
            service.close()


def test_mesh_axes_not_ported_are_refused(tmp_path):
    """The Predictor and ``cli.serve`` refuse the ``model`` and ``spatial``
    axes, naming the next slice; a data axis larger than the devices is
    JAX's ValueError."""
    for shape in ((1, 2, 1), (1, 1, 2)):
        grid = np.empty(2, dtype=object)
        grid[:] = [torch.device("cpu")] * 2
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            Predictor(CFG, mesh=Mesh(grid.reshape(shape)), device="cpu")
    args = ["--device", "cpu", "--model_type", "eelunet", "--checkpoint", str(tmp_path / "x")]
    for sets, err in ((["mesh.model_axis=2"], NotImplementedError),
                      (["mesh.spatial_axis=2"], NotImplementedError),
                      (["mesh.data_axis=2"], ValueError)):
        with pytest.raises(err, match="ROADMAP.md|needs more than 1 devices"):
            serve_cli.main(args + [a for s in sets for a in ("--set", s)])
