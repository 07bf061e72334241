"""The port's ``cli.predict`` against the JAX package's on the CPU, binary and
3-class, on the same weights and the same PNG tree: resize mode with flip
TTA and tiled mode at native resolution (the model and the tie rule:
``torch_port_predict.py``)."""

from __future__ import annotations

import os

import numpy as np
import pytest
from PIL import Image

from eelunet_tpu.cli import predict as jax_predict_cli
from eelunet_tpu.config import ModelConfig as JaxModelConfig
from eelunet_tpu.data.dataset import SegmentationFolderDataset as JaxFolderDataset
from eelunet_tpu.inference import Predictor as JaxPredictor
from eelunet_tpu_torch.cli import predict as predict_cli
from torch_port_predict import MAX_TIES, NAME, NATIVE, OVERLAP, SIZE, TILE, predict_setup, ties


@pytest.fixture(scope="module", params=[1, 3], ids=["binary", "3class"])
def setup(request, tmp_path_factory):
    return predict_setup(request.param, tmp_path_factory.mktemp(f"predict{request.param}"))


def _args(s, mode):
    args = ["--model_type", NAME, "--data_dir", s["tree"], "--image_size", str(SIZE),
            "--batch_size", "4", "--set", f"model.out_channels={s['classes']}",
            "--set", "data.num_workers=1", "--set", "tta=true"]
    if mode == "tiled":
        args += ["--tile", str(TILE), "--tile_overlap", str(OVERLAP)]
    return args


def _masks(out_dir, n):
    assert sorted(os.listdir(out_dir)) == sorted(f"pred_{i}.png" for i in range(n))
    return np.stack([np.asarray(Image.open(os.path.join(out_dir, f"pred_{i}.png")))
                     for i in range(n)])


@pytest.mark.parametrize("mode", ["resize", "tiled"])
def test_cli_predict_matches_jax(setup, mode):
    """Resize mode (data.image_size, flip TTA) and tiled mode (native size,
    TILE with OVERLAP): the port's PNGs equal JAX's but at ties, of which
    at most 0.1%; binary masks are {0, 255}, class masks ids in [0, 3)."""
    s = setup
    jax_dir = jax_predict_cli.main(
        _args(s, mode) + ["--checkpoint", s["jax_ckpt"], "--set", "compile_cache=",
                          "--results_dir", str(s["root"] / f"jax_{mode}")])
    port_dir = predict_cli.main(
        _args(s, mode) + ["--device", "cpu", "--checkpoint", s["npz"],
                          "--results_dir", str(s["root"] / f"port_{mode}")])
    want, got = _masks(jax_dir, 5), _masks(port_dir, 5)
    assert got.shape == want.shape == ((5, SIZE, SIZE) if mode == "resize" else (5, *NATIVE))
    allowed = {0, 255} if s["classes"] == 1 else set(range(s["classes"]))
    assert set(np.unique(got).tolist()) <= allowed
    assert len(np.unique(want)) > 1  # the comparison is not between two blank masks

    # JAX's probabilities for the same pixels: the CLI's own model, unfolded
    # in resize mode; the Predictor's folded one in tiled mode.
    ds = JaxFolderDataset(s["tree"], "test", (SIZE, SIZE) if mode == "resize" else None,
                          as_uint8=True, multiclass=s["classes"] > 1)
    jp = JaxPredictor(JaxModelConfig(name=NAME, out_channels=s["classes"]),
                      checkpoint=s["jax_ckpt"], tta=True,
                      fold_bn=False if mode == "resize" else "auto")
    images = np.stack([ds[i][0] for i in range(5)])
    probs = (jp.predict_proba(images) if mode == "resize"
             else jp.predict_proba_tiled(images, tile=TILE, overlap=OVERLAP))
    differ = got != want
    assert not np.any(differ & ~ties(probs)), np.argwhere(differ & ~ties(probs))[:5]
    assert differ.mean() <= MAX_TIES, differ.mean()
