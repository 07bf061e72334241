"""The port's Predictor against the JAX package's on the CPU, binary and
3-class: tiled prediction with flip TTA, a tile that covers the image and
one that does not; the service behind ``cli.serve`` answering the
Predictor's masks (class ids in multi-class mode); and what ``cli.predict``
still refuses. The model and the tie rule: ``torch_port_predict.py``."""

from __future__ import annotations

import io
import os

import numpy as np
import pytest
from PIL import Image

from eelunet_tpu.config import ModelConfig as JaxModelConfig
from eelunet_tpu.inference import Predictor as JaxPredictor
from eelunet_tpu_torch.cli import predict as predict_cli
from eelunet_tpu_torch.config import ModelConfig
from eelunet_tpu_torch.inference import Predictor
from torch_port_predict import (
    MAX_TIES,
    NAME,
    NATIVE,
    OVERLAP,
    PROB_TOL,
    SIZE,
    predict_setup,
    ties,
)


@pytest.fixture(scope="module", params=[1, 3], ids=["binary", "3class"])
def setup(request, tmp_path_factory):
    return predict_setup(request.param, tmp_path_factory.mktemp(f"tiled{request.param}"))


def _args(s):
    return ["--model_type", NAME, "--data_dir", s["tree"], "--image_size", str(SIZE),
            "--batch_size", "4", "--set", f"model.out_channels={s['classes']}",
            "--set", "data.num_workers=1"]


@pytest.mark.parametrize("tile", [64, 32], ids=["tile_covers", "tile_inside"])
def test_predictor_tiled_and_tta_match_jax(setup, tile):
    """``Predictor.predict_proba_tiled`` with flip TTA, port against JAX, on
    the same uint8 images at native size: a tile that covers the image (the
    reflect-padded path) and one that does not (shifted edge windows);
    probabilities within PROB_TOL, masks equal but at ties."""
    s = setup
    classes = s["classes"]
    rng = np.random.default_rng(7)
    u8 = rng.integers(0, 256, (2, *NATIVE, 3), dtype=np.uint8)
    jp = JaxPredictor(JaxModelConfig(name=NAME, out_channels=classes),
                      checkpoint=s["jax_ckpt"], tta=True)
    tp = Predictor(ModelConfig(name=NAME, out_channels=classes), checkpoint=s["npz"],
                   tta=True, device="cpu")
    want = jp.predict_proba_tiled(u8, tile=tile, overlap=OVERLAP)
    got = tp.predict_proba_tiled(u8, tile=tile, overlap=OVERLAP)
    assert got.shape == want.shape == (2, *NATIVE, classes)
    assert np.abs(got - want).max() <= PROB_TOL, np.abs(got - want).max()
    mask_t = tp.predict_tiled(u8, tile=tile, overlap=OVERLAP)
    mask_j = jp.predict_tiled(u8, tile=tile, overlap=OVERLAP)
    differ = (mask_t != mask_j)[..., 0]
    assert not np.any(differ & ~ties(want)) and differ.mean() <= MAX_TIES


def test_predict_refuses_what_is_not_ported(setup, tmp_path):
    """``--quantize int8`` is ported and writes masks; a slim checkpoint
    refuses the Canny flags, as in the JAX package; a missing checkpoint
    and the Canny flags with ``--tile`` stay refused, and so do a mesh's
    ``model`` and ``spatial`` axes; a data axis larger than the devices
    raises JAX's ValueError."""
    s = setup
    base = _args(s) + ["--device", "cpu", "--results_dir", str(tmp_path)]
    out = predict_cli.main(base + ["--checkpoint", s["npz"], "--quantize", "int8"])
    assert len(os.listdir(out)) == 5
    slim = tmp_path / "slim"
    slim.mkdir()
    (slim / "widths.json").write_text('{"model": "unet", "widths": {}}')
    with pytest.raises(ValueError, match="not supported on the slim"):
        predict_cli.main(base + ["--checkpoint", str(slim), "--set", "data.canny_enhance=true"])
    with pytest.raises(FileNotFoundError):
        predict_cli.main(base + ["--checkpoint", str(tmp_path / "nope.npz")])
    with pytest.raises(ValueError, match="--tile"):
        predict_cli.main(base + ["--checkpoint", s["npz"], "--tile", "32",
                                 "--set", "data.canny_enhance=true"])
    with pytest.raises(ValueError, match="needs more than 1 devices"):
        predict_cli.main(base + ["--checkpoint", s["npz"], "--set", "mesh.data_axis=2"])
    for axis in ("model", "spatial"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            predict_cli.main(base + ["--checkpoint", s["npz"], "--set", f"mesh.{axis}_axis=2"])


def test_service_serves_masks_of_the_predictor(setup):
    """``SegmentationService`` (behind ``cli.serve``) with the checkpoint:
    a mask request (.npy and PNG) gives the Predictor's masks, class ids for
    the 3-class model, as the JAX service's PNG does (raw ids)."""
    from eelunet_tpu_torch.serving import SegmentationService

    s = setup
    pred = Predictor(ModelConfig(name=NAME, out_channels=s["classes"]), checkpoint=s["npz"],
                     device="cpu")
    service = SegmentationService(pred, (SIZE, SIZE), max_batch=4, window_ms=5.0)
    try:
        rng = np.random.default_rng(3)
        batch = rng.integers(0, 256, (3, SIZE, SIZE, 3), dtype=np.uint8)
        buf = io.BytesIO()
        np.save(buf, batch)
        masks = np.load(io.BytesIO(service.predict_npy(buf.getvalue(), output="mask")))
        want = pred.predict(batch)
        np.testing.assert_array_equal(masks, want)
        assert len(np.unique(want)) > 1
        png = io.BytesIO()
        Image.fromarray(batch[0]).save(png, format="PNG")
        got = np.asarray(Image.open(io.BytesIO(service.predict_png(png.getvalue()))))
        scale = 255 if s["classes"] == 1 else 1
        np.testing.assert_array_equal(got, want[0, :, :, 0].astype(np.uint8) * scale)
    finally:
        service.close()
