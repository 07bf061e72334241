"""The Canny edge path of the port on the CPU, against the JAX package:
the augmentations and the device-side input chain, paired train steps with
both Canny flags on (4 input channels), and ``cli.train`` then
``cli.evaluate`` end to end.

Tolerances: the edge channel equals the JAX one exactly, RGB within 1e-6
(f32 rounding of the blend and the normalisation); the paired steps hold
the bounds of ``tests/test_torch_port_train.py``; ``cli.evaluate``
reproduces the training run's metrics for the tag it loads exactly.
"""

from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eelunet_tpu.config import TrainConfig as JaxTrainConfig
from eelunet_tpu.config import apply_overrides as jax_apply_overrides
from eelunet_tpu.data import augment as jaug
from eelunet_tpu_torch.cli import evaluate as evaluate_cli
from eelunet_tpu_torch.cli import train as train_cli
from eelunet_tpu_torch.cli.common import kernel_launches, make_folder_dataset, wants_raw_images
from eelunet_tpu_torch.config import TrainConfig, apply_overrides
from eelunet_tpu_torch.data import augment
from eelunet_tpu_torch.data.synthetic import make_blob_sample, write_synthetic_tree
from eelunet_tpu_torch.train.trainer import Trainer
from torch_port_helpers import (
    CFG,
    LR,
    MASK_RANGE,
    STEPS,
    narrow_flax_variables,
    once_per_run,
    paired_train_steps,
)

FLAGS = {"edge": ["data.add_canny_edge=true"], "enhance": ["data.canny_enhance=true"],
         "both": ["data.add_canny_edge=true", "data.canny_enhance=true"]}


def _raw(seed=0, n=2, h=48, w=40):
    """Seeded blob images in [0,1] (NHWC float32) and their masks."""
    rng = np.random.default_rng(seed)
    pairs = [make_blob_sample(rng, h, w) for _ in range(n)]
    return (np.stack([p[0] for p in pairs]).astype(np.float32),
            np.stack([p[1] for p in pairs]).astype(np.float32))


def _assert_chain_equal(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got[..., :3], want[..., :3], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[..., 3:], want[..., 3:])


def test_canny_augmentations_match_jax():
    x, _ = _raw()
    edges = augment.add_canny_edge(torch.from_numpy(x)).numpy()
    assert edges.shape == (2, 48, 40, 4) and edges[..., 3].sum() > 0
    _assert_chain_equal(edges, np.asarray(jaug.add_canny_edge(jnp.asarray(x))))
    for alpha in (0.2, 0.5):
        got = augment.canny_enhance(torch.from_numpy(x), alpha).numpy()
        assert not np.array_equal(got, x)
        np.testing.assert_allclose(got, np.asarray(jaug.canny_enhance(jnp.asarray(x), alpha)),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("feed", ["uint8", "float"])
@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_input_chain_matches_jax(flags, feed):
    """``make_augment_fn`` and ``make_input_preprocess`` on uint8 and raw
    float batches: enhance, then the edge channel, then ImageNet
    normalisation of the RGB channels only."""
    cfg = apply_overrides(TrainConfig(), FLAGS[flags])
    jcfg = jax_apply_overrides(JaxTrainConfig(), FLAGS[flags])
    x, y = _raw(seed=1)
    if feed == "uint8":
        x, y = (x * 255).astype(np.uint8), (y * 255).astype(np.uint8)
    jpre, has_augment = jaug.make_input_preprocess(jcfg.data)
    assert has_augment
    want_x, want_y = (np.asarray(a) for a in jpre(jnp.asarray(x), jnp.asarray(y)))
    got_x, got_y = augment.make_input_preprocess(cfg.data)(torch.from_numpy(x),
                                                           torch.from_numpy(y))
    assert got_x.shape[-1] == (4 if cfg.data.add_canny_edge else 3)
    _assert_chain_equal(got_x.numpy(), want_x)
    np.testing.assert_array_equal(got_y.numpy(), want_y)
    if feed == "float":
        _assert_chain_equal(augment.make_augment_fn(cfg.data)(torch.from_numpy(x)).numpy(),
                            np.asarray(jaug.make_augment_fn(jcfg.data)(jnp.asarray(x))))


def test_chain_off_and_raw_datasets(tmp_path):
    cfg = TrainConfig()
    assert augment.make_augment_fn(cfg.data) is None and not wants_raw_images(cfg.data)
    tree = write_synthetic_tree(str(tmp_path / "t"), n_train=2, n_test=1, image_size=(16, 16))
    on = apply_overrides(cfg, FLAGS["edge"] + [f"data.data_dir={tree}", "data.uint8_feed=false",
                                                "data.image_size=16"])
    assert wants_raw_images(on.data)
    raw, _ = make_folder_dataset(on.data, "train")[0]
    norm, _ = make_folder_dataset(apply_overrides(on, ["data.add_canny_edge=false"]).data,
                                  "train")[0]
    assert 0.0 <= raw.min() and raw.max() <= 1.0 and norm.min() < -0.5


# ------------------------------------------------------------ paired steps

def _canny_batches():
    """STEPS batches at 64x64, b2, through each package's input chain with
    both flags on: (JAX input, port input, mask) numpy triples."""
    jcfg = jax_apply_overrides(JaxTrainConfig(), FLAGS["both"])
    jchain = jaug.make_augment_fn(jcfg.data)
    pchain = augment.make_augment_fn(apply_overrides(TrainConfig(), FLAGS["both"]).data)
    out = []
    for i in range(STEPS):
        x, y = _raw(seed=10 + i, h=64, w=64)
        xj = np.asarray(jchain(jnp.asarray(x)))
        xt = pchain(torch.from_numpy(x)).numpy()
        _assert_chain_equal(xt, xj)
        out.append((xj, xt, y))
    return out


def _paired(float64):
    cfg4 = dataclasses.replace(CFG, in_channels=4)
    return paired_train_steps(narrow_flax_variables(in_channels=4), _canny_batches(),
                              float64, cfg=cfg4)


@pytest.fixture(scope="module")
def canny_run(tmp_path_factory):
    return once_per_run(tmp_path_factory, "canny_paired", lambda _: _paired(float64=False))


@pytest.fixture(scope="module")
def canny_run64(tmp_path_factory):
    return once_per_run(tmp_path_factory, "canny_paired64", lambda _: _paired(float64=True))


def _rel(a, b):
    return ((a - b).norm() / b.norm()).item()


def _flat(tree, keys):
    return torch.cat([tree[k].flatten() for k in keys])


def test_canny_step_parity_losses_and_params(canny_run):
    """float32: the bounds of tests/test_step_parity.py (see
    tests/test_torch_port_train.py)."""
    loss_j, loss_t, pstate = canny_run["loss_j"], canny_run["loss_t"], canny_run["pstate"]
    assert pstate.model.enc1.conv0.weight.shape[1] == 4
    rel = np.abs(loss_t - loss_j) / np.abs(loss_j)
    assert rel[0] < 2e-4 and rel.max() < 1e-2, (loss_t, loss_j)
    want, got = canny_run["want"], pstate.model.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    worst = max((got[k] - want[k]).abs().max().item() for k in want if k not in stats)
    assert worst < 8 * LR * STEPS, worst
    assert max((got[k] - want[k]).abs().max().item() for k in stats) < 1e-1


def test_canny_step_parity_first_step_grads(canny_run64):
    gj, gt = canny_run64["grad_j"], canny_run64["grad_t"]
    total = _flat(gj, gj).norm()
    live = [k for k in gj if gj[k].norm() > 1e-6 * total]
    assert len(live) > 200 and "enc1.conv0.weight" in live, len(live)
    worst = max((_rel(gt[k], gj[k]), k) for k in live)
    assert worst[0] < 1e-4, worst


def test_canny_step_parity_param_change(canny_run64):
    want, init = canny_run64["want"], canny_run64["init"]
    got, keys = canny_run64["pstate"].model.state_dict(), list(canny_run64["grad_j"])
    delta_j = _flat(want, keys) - _flat(init, keys)
    delta_t = _flat(got, keys) - _flat(init, keys)
    assert _rel(delta_t, delta_j) < 1e-3, _rel(delta_t, delta_j)


# ------------------------------------------------------- cli.train -> evaluate

def test_cli_train_then_evaluate_reproduces_the_metrics(tmp_path, capsys):
    """Full width, 32x32, both Canny flags, on the CPU: cli.evaluate on a
    best tag and on the ``last`` snapshot prints the metrics the training
    run recorded for those weights on the test split."""
    tree = write_synthetic_tree(str(tmp_path / "tree"), n_train=8, n_test=3,
                                image_size=(32, 32), seed=1)
    save, logs = tmp_path / "ckpt", tmp_path / "runs"
    common = ["--device", "cpu", "--model_type", "eelunet", "--data_dir", tree,
              "--image_size", "32", "--batch_size", "2", "--seed", "0",
              "--save_dir", str(save), "--set", f"model.fft_mask_range={MASK_RANGE}",
              "--set", "data.num_workers=1"]
    for ov in FLAGS["both"]:
        common += ["--set", ov]
    train_cli.main(common + ["--epochs", "2", "--log_dir", str(logs)])
    root = save / "eelunet"
    try:
        hist = json.loads((root / "loss_history.json").read_text())
        best_epoch = int(np.argmin(hist["val_loss"]))
        capsys.readouterr()
        m_best = evaluate_cli.main(common + ["--checkpoint", str(root / "eelunet_best.npz")])
        out = capsys.readouterr().out
        assert m_best == hist["metrics"][best_epoch]
        assert json.loads(out.split("metrics: ", 1)[1].splitlines()[0]) == m_best
        assert "Dice Coefficient (foreground):" in out
        assert set(json.loads(out.split("kernel launches: ", 1)[1].splitlines()[0]).values()) \
            == {0}
        m_last = evaluate_cli.main(common + ["--checkpoint", str(root / "eelunet_last")])
        assert m_last == hist["metrics"][-1]
    finally:  # 100 MB files at full width
        for f in root.glob("*.npz"):
            f.unlink()
        (root / "eelunet_last" / "state.pt").unlink(missing_ok=True)


def test_evaluate_refuses_what_is_not_ported(tmp_path):
    """A mesh's ``model`` and ``spatial`` axes are still refused, and a data
    axis larger than the devices raises JAX's ValueError. Slim checkpoints
    are ported, and refuse the Canny flags, as in the JAX package (a slim
    model has 3 input channels)."""
    slim = tmp_path / "slim"
    slim.mkdir()
    (slim / "widths.json").write_text('{"model": "eelunet", "widths": {}}')
    with pytest.raises(ValueError, match="not supported on the slim"):
        evaluate_cli.main(["--device", "cpu", "--checkpoint", str(slim),
                           "--set", "data.add_canny_edge=true"])
    with pytest.raises(ValueError, match="needs more than 1 devices"):
        evaluate_cli.main(["--device", "cpu", "--set", "mesh.data_axis=2"])
    for axis in ("model", "spatial"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            evaluate_cli.main(["--device", "cpu", "--set", f"mesh.{axis}_axis=2"])


def test_trainer_takes_four_channels_with_the_edge_flag():
    cfg = apply_overrides(TrainConfig(), FLAGS["both"] + ["model.name=eelunet"])
    trainer = Trainer(cfg, device="cpu")
    assert trainer.cfg.model.in_channels == 4
    assert trainer.model.enc1.conv0.weight.shape[1] == 4
    assert set(kernel_launches()) == {"highpass_contract", "highpass_expand",
                                      "highpass_bwd_contract", "highpass_bwd_expand",
                                      "fused_canny", "hysteresis", "conv3x3"}
