"""The port's serving path against the JAX package's: the Predictor on the
same weights and uint8 input, and the SegmentationService's .npy and PNG
requests (in-process and over HTTP on localhost).

Both Predictors build the full-width model from the config; the narrow test
model (tests/torch_port_helpers.py) is swapped in through ``commit``, with BN
folded on each side by its own package, so the comparison stays small.
"""

from __future__ import annotations

import io
import threading
import urllib.request

import numpy as np
import pytest
import torch

from eelunet_tpu.bnfold import fold_bn_eval as jax_fold_bn_eval
from eelunet_tpu.config import ModelConfig as JaxModelConfig
from eelunet_tpu.inference import Predictor as JaxPredictor
from eelunet_tpu.models.eelunet import EELUnet as JaxEELUnet
from eelunet_tpu_torch.config import ModelConfig
from eelunet_tpu_torch.inference import Predictor, build_serving_model
from eelunet_tpu_torch.models.convert import from_flax_variables
from eelunet_tpu_torch.serving import SegmentationService, make_server
from torch_port_helpers import MASK_RANGE, NARROW, narrow_flax_variables


@pytest.fixture(scope="module")
def predictors():
    jmodel = JaxEELUnet(mask_range=MASK_RANGE, widths=NARROW)
    variables = narrow_flax_variables()
    jpred = JaxPredictor(JaxModelConfig(name="eelunet", fft_mask_range=MASK_RANGE),
                         bucket_batches=False)
    params, stats, _ = jax_fold_bn_eval("eelunet", variables["params"], variables["batch_stats"])
    jpred.commit((jmodel.clone(bn_folded=True), params, stats))

    cfg = ModelConfig(name="eelunet", fft_mask_range=MASK_RANGE)
    pred = Predictor(cfg, bucket_batches=True, device="cpu")
    pred.commit(build_serving_model(from_flax_variables(variables), cfg, "cpu", widths=NARROW))
    return jpred, pred


def test_predictor_matches_jax(predictors):
    jpred, pred = predictors
    u8 = np.random.default_rng(4).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    want = jpred.predict_proba(u8)
    got = pred.predict_proba(u8)
    assert got.shape == (2, 64, 64, 1) and got.dtype == np.float32
    # tests/test_torch_parity.py's EELUnet bound, on folded f32 models
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
    masks = pred.predict(u8)  # thresholded on the device
    assert masks.dtype == np.float32 and set(np.unique(masks)) <= {0.0, 1.0}
    clear = np.abs(want - 0.5) > 1e-3  # away from the threshold the masks agree
    np.testing.assert_array_equal(masks[clear], (want > 0.5).astype(np.float32)[clear])


def test_dispatch_collect_and_buckets(predictors):
    _, pred = predictors
    u8 = np.random.default_rng(5).integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    outs, b, _ = handle = pred.dispatch_proba(u8)
    # padded to the bucket, on the device (one output per device of the mesh)
    assert b == 3 and [o.shape[0] for o in outs] == [4]
    np.testing.assert_array_equal(pred.collect(handle), pred.predict_proba(u8))
    mask = pred.predict_mask_wire(u8)
    assert mask.dtype == np.uint8 and mask.shape == (3, 64, 64, 1)


def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def test_service_answers_npy_and_png(predictors):
    from PIL import Image

    _, pred = predictors
    service = SegmentationService(pred, (64, 64), max_batch=4, window_ms=10.0)
    server = make_server(service, "eelunet", port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        rng = np.random.default_rng(6)
        u8 = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
        probs = np.load(io.BytesIO(service.predict_npy(_npy(u8))))
        assert probs.shape == (1, 64, 64, 1) and probs.dtype == np.float32
        np.testing.assert_allclose(probs, pred.predict_proba(u8[None]), atol=1e-6)
        batch = rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
        masks = np.load(io.BytesIO(service.predict_npy(_npy(batch), output="mask")))
        np.testing.assert_array_equal(masks, (pred.predict_proba(batch) > 0.5).astype(np.float32))

        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)).save(buf, format="PNG")
        base = f"http://{server.server_address[0]}:{server.server_address[1]}"
        req = urllib.request.Request(base + "/v1/predict", data=buf.getvalue(),
                                     headers={"Content-Type": "image/png"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200 and r.headers.get("Content-Type") == "image/png"
            png = np.asarray(Image.open(io.BytesIO(r.read())))
        assert png.shape == (64, 64) and set(np.unique(png)) <= {0, 255}

        stats = service.stats()
        assert stats["requests"] == 5
        # a CPU device runs the plain twins: no kernel launches
        assert stats["kernel_launches"] == {"highpass_contract": 0, "highpass_expand": 0,
                                            "highpass_bwd_contract": 0, "highpass_bwd_expand": 0}
    finally:
        server.shutdown()
        service.close()


def test_upstream_checkpoints_load_and_hot_reload(tmp_path):
    """The .npz that cli.export_torch --numpy writes and a torch .pth of the
    same tensors load to the same model; POST-style hot reload swaps it in."""
    import torch

    from eelunet_tpu_torch.inference import random_state_dict
    from eelunet_tpu_torch.models.convert import to_upstream_state_dict

    cfg = ModelConfig(name="eelunet")
    up = to_upstream_state_dict(random_state_dict(cfg, seed=1))
    np.savez(tmp_path / "w.npz", **up)
    torch.save({k: torch.from_numpy(v) for k, v in up.items()}, tmp_path / "w.pth")
    u8 = np.random.default_rng(8).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    from_npz = Predictor(cfg, checkpoint=str(tmp_path / "w.npz"), device="cpu")
    from_pth = Predictor(cfg, checkpoint=str(tmp_path / "w.pth"), device="cpu")
    want = from_npz.predict_proba(u8)
    np.testing.assert_array_equal(from_pth.predict_proba(u8), want)

    live = Predictor(cfg, device="cpu")  # seed-0 random weights
    assert not np.array_equal(live.predict_proba(u8), want)
    service = SegmentationService(live, (64, 64), max_batch=2)
    try:
        assert service.reload_checkpoint(str(tmp_path / "w.npz"))["reloads"] == 1
        np.testing.assert_array_equal(live.predict_proba(u8), want)
    finally:
        service.close()
        for name in ("w.npz", "w.pth"):  # 100 MB each at full width
            (tmp_path / name).unlink()


def test_predictor_without_a_card_raises():
    """No device means the card; without one the Predictor refuses rather
    than serve on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(ModelConfig(name="eelunet"))


def test_out_of_scope_options_raise():
    """A mesh's ``model`` and ``spatial`` axes are still refused, naming the
    next slice, and a data axis larger than the devices raises JAX's
    ValueError; the data axis is ported (test_torch_port_multidevice_serving.py).
    int8 and slim checkpoints are ported: an unknown quantize mode and a
    ``slim_init`` without its ``widths.json`` raise, and ``quantize="int8"``
    serves."""
    from eelunet_tpu_torch.parallel.mesh import Mesh, create_mesh

    cfg = ModelConfig(name="eelunet")
    with pytest.raises(ValueError, match="quantize"):
        Predictor(cfg, quantize="int4", device="cpu")
    for shape in ((1, 2, 1), (1, 1, 2)):
        grid = np.empty(2, dtype=object)
        grid[:] = [torch.device("cpu")] * 2
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Predictor(cfg, mesh=Mesh(grid.reshape(shape)), device="cpu")
    with pytest.raises(ValueError, match="needs more than 1 devices"):
        Predictor(cfg, mesh=create_mesh(2, devices=["cpu"]), device="cpu")
    with pytest.raises(FileNotFoundError, match="widths.json"):
        Predictor(ModelConfig(name="eelunet", slim_init="slim_dir"), device="cpu")
    with pytest.raises(ValueError, match="slim_init supports unet/eelunet"):
        Predictor(ModelConfig(name="unext_s", slim_init="slim_dir"), device="cpu")
    quant = Predictor(ModelConfig(name="unext_s"), quantize="int8", device="cpu")
    assert quant.predict_proba(np.zeros((1, 32, 32, 3), np.uint8)).shape == (1, 32, 32, 1)
    assert quant.quant_stats["quantized_convs"] > 0
