"""``cli.visualize`` and ``cli.export_torch`` of the port against the JAX
package's, on the same weights.

``cli.visualize``: the JAX CLI builds its Trainer's model and state from
the test's flax variables (its ``create_model`` and ``init_state`` stand in
for an orbax checkpoint), the port's CLI reads the same weights from an
upstream-layout ``.npz``. Both write the same set of files at
``--max_depth 1``; each channel grid (``_to_grid`` of a captured module
output) is within the forward bound of tests/test_torch_port_eelunet.py of
JAX's, and the seg/edge contribution percentages agree.

``cli.export_torch``: from a full snapshot of the port, the ``.pth`` and the
``.npz`` hold JAX's ``export_state_dict`` of the same weights, bit for bit."""

from __future__ import annotations

import contextlib
import io
import os
import types

import numpy as np
import pytest
import torch

import eelunet_tpu.cli.visualize as jax_visualize
import eelunet_tpu.train.trainer as jax_trainer_module
import eelunet_tpu_torch.cli.visualize as visualize_cli
import eelunet_tpu_torch.train.trainer as T
from eelunet_tpu.models.eelunet import EELUnet as JaxEELUnet
from eelunet_tpu.models.torch_port import export_state_dict
from eelunet_tpu.registry import MODEL_REGISTRY as JAX_MODEL_REGISTRY
from eelunet_tpu.utils.visualize import _to_grid as jax_to_grid
from eelunet_tpu_torch.cli import export_torch as export_torch_cli
from eelunet_tpu_torch.data.synthetic import write_synthetic_tree
from eelunet_tpu_torch.models.convert import from_flax_variables, to_upstream_state_dict
from eelunet_tpu_torch.models.unet import Unet
from eelunet_tpu_torch.registry import MODEL_REGISTRY
from eelunet_tpu_torch.utils.visualize import _to_grid, edge_seg_contribution, save_image
from torch_port_families import UNET_NARROW, family_variables, jax_model
from torch_port_helpers import MASK_RANGE, NARROW, narrow_flax_variables

# tests/test_torch_port_eelunet.py's forward bound (float32), on grids of
# maps scaled per channel to [0, 1].
GRID_TOL = 5e-4
# The contribution percentages count pixels where one head's value is the
# larger: equal weights give the same counts but where two values lie
# within rounding of each other.
CONTRIB_TOL = 0.5  # percentage points
VIZ_FAMILIES = ("eelunet", "unet", "egeunet", "malunet")


def _variables(name):
    return narrow_flax_variables() if name == "eelunet" else family_variables(name)


def _jax_module(name):
    if name == "eelunet":
        return JaxEELUnet(widths=NARROW, mask_range=MASK_RANGE)
    return jax_model(name)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_synthetic_tree(str(tmp_path_factory.mktemp("viz_tree")), n_train=4, n_test=2,
                                image_size=(64, 64))


@pytest.mark.parametrize("name", VIZ_FAMILIES)
def test_cli_visualize_matches_jax(name, tree, tmp_path, monkeypatch):
    """The narrow EELUnet (the seg/edge diagnostic), the narrow U-Net (flax
    names ``ConvBlock_i`` for ``enc1``...), EGE-UNet (``encoder3`` split into
    flax's ``encoder3_conv`` and ``encoder3_block``) and MALUNet (``_ea`` and
    ``_dga`` halves; the 5 outputs of ``scab``) at 64^2: the same file
    names, grids within GRID_TOL, the same contributions."""
    variables = _variables(name)
    jm = _jax_module(name)
    monkeypatch.setattr(jax_trainer_module, "create_model",
                        lambda cfg: (jm, JAX_MODEL_REGISTRY[name]))
    monkeypatch.setattr(jax_trainer_module.Trainer, "init_state",
                        lambda self, steps_per_epoch=1: types.SimpleNamespace(
                            params=variables["params"],
                            batch_stats=variables.get("batch_stats", {})))
    if name == "unet":
        monkeypatch.setattr(T, "create_model",
                            lambda cfg, **kw: (Unet(**UNET_NARROW), MODEL_REGISTRY["unet"]))
    elif name == "eelunet":
        orig = T.create_model
        monkeypatch.setattr(T, "create_model",
                            lambda cfg, **kw: orig(cfg, **{**kw, "widths": NARROW}))
    ckpt = str(tmp_path / "w.npz")
    np.savez(ckpt, **to_upstream_state_dict(from_flax_variables(variables, name), name))

    grids = {"jax": {}, "port": {}}
    contrib = {}
    for side, module, to_grid in (("jax", jax_visualize, jax_to_grid),
                                  ("port", visualize_cli, _to_grid)):
        real_save, real_contrib = module.save_feature_grid, module.edge_seg_contribution

        def save(fm, path, num_cols=8, title=None, side=side, real=real_save, grid=to_grid):
            grids[side][os.path.basename(path)] = grid(np.asarray(fm) if side == "jax" else fm,
                                                       num_cols)
            real(fm, path, num_cols, title)

        def contribution(a, b, side=side, real=real_contrib):
            contrib[side] = real(a, b)
            return contrib[side]

        monkeypatch.setattr(module, "save_feature_grid", save)
        monkeypatch.setattr(module, "edge_seg_contribution", contribution)

    common = ["--model_type", name, "--data_dir", tree, "--image_size", "64", "--index", "1",
              "--max_depth", "1"]
    if name == "eelunet":
        common += ["--set", f"model.fft_mask_range={MASK_RANGE}"]
    with contextlib.redirect_stdout(io.StringIO()):
        jdir = jax_visualize.main(common + ["--results_dir", str(tmp_path / "jax")])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        pdir = visualize_cli.main(common + ["--results_dir", str(tmp_path / "port"), "--device",
                                            "cpu", "--checkpoint", ckpt])
    assert f"Loaded model weights from {ckpt}" in out.getvalue()
    assert out.getvalue().splitlines()[-1].startswith("kernel launches: ")

    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    assert sorted(grids["port"]) == sorted(grids["jax"]) and grids["port"]
    for k, want in grids["jax"].items():
        got = grids["port"][k]
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, atol=GRID_TOL, rtol=0, err_msg=k)
    assert contrib.keys() == ({"jax", "port"} if name in ("eelunet", "egeunet") else set())
    for k, want in contrib.get("jax", {}).items():
        assert abs(contrib["port"][k] - want) <= CONTRIB_TOL, (k, contrib)


def test_cli_visualize_filters_and_refusals(tree, tmp_path):
    """``--modules`` keeps the matching paths at any depth (flax's names:
    the U-Net's transposed convs are ``UpConvBlock_i``), a module called
    twice gets ``~call{i}`` names, and an index outside the split raises
    JAX's IndexError."""
    common = ["--device", "cpu", "--model_type", "unet", "--data_dir", tree, "--image_size",
              "32", "--results_dir", str(tmp_path / "viz")]
    with contextlib.redirect_stdout(io.StringIO()):
        out = visualize_cli.main(common + ["--modules", "UpConvBlock"])
    grids = set(os.listdir(out)) - {"input.png", "probabilities.png", "mask.png"}
    assert grids and all(g.startswith("UpConvBlock_") for g in grids)
    with open(os.path.join(out, sorted(grids)[0]), "rb") as f:
        assert f.read(4) == b"\x89PNG"
    with pytest.raises(IndexError, match="out of range"):
        visualize_cli.main(common + ["--index", "99"])

    conv = torch.nn.Conv2d(3, 3, 1)
    _, captured = visualize_cli.capture_outputs(
        torch.nn.Sequential(conv), "eelunet", lambda: conv(conv(torch.zeros(1, 3, 4, 4))),
        lambda name: True)
    assert list(captured) == ["0"] and len(captured["0"]) == 2


def test_visualize_utils_match_jax(tmp_path):
    """``_to_grid`` of a (B,C,H,W) map equals JAX's of its (B,H,W,C)
    transpose; ``edge_seg_contribution`` equals JAX's; ``save_image``
    writes the PNG JAX writes."""
    from eelunet_tpu.utils.visualize import edge_seg_contribution as jax_contribution
    from eelunet_tpu.utils.visualize import save_image as jax_save_image

    rng = np.random.default_rng(0)
    fm = rng.standard_normal((1, 11, 6, 5)).astype(np.float32)
    np.testing.assert_array_equal(_to_grid(torch.from_numpy(fm), 4),
                                  jax_to_grid(fm.transpose(0, 2, 3, 1), 4))
    a, b = rng.uniform(size=(2, 1, 8, 8)), rng.uniform(size=(2, 1, 8, 8))
    b[0, 0, :2] = a[0, 0, :2]
    assert edge_seg_contribution(a, b) == jax_contribution(a, b)
    img = rng.uniform(size=(8, 8, 1))
    save_image(img, str(tmp_path / "p.png"))
    jax_save_image(img, str(tmp_path / "j.png"))
    assert open(tmp_path / "p.png", "rb").read() == open(tmp_path / "j.png", "rb").read()


EXPORT_FAMILIES = ("eelunet", "unet", "unext", "unext_s", "egeunet", "malunet")


@pytest.mark.parametrize("name", EXPORT_FAMILIES)
def test_cli_export_torch_matches_jax(name, tmp_path):
    """A full snapshot of the port (``state.pt``) -> ``.pth`` and ``.npz``
    (``--numpy``): JAX's ``export_state_dict`` of the same weights, keys,
    dtypes and values bit for bit, and JAX's printed line."""
    variables = _variables(name)
    want = export_state_dict(name, variables)
    snap = tmp_path / f"{name}_last"
    os.makedirs(snap)
    torch.save({"model": from_flax_variables(variables, name)}, snap / "state.pt")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        export_torch_cli.main(["--model_type", name, "--checkpoint", str(snap), "--output",
                               str(tmp_path / "w.pth")])
        export_torch_cli.main(["--model_type", name, "--checkpoint", str(snap), "--output",
                               str(tmp_path / "w"), "--numpy"])
    n = sum(int(np.asarray(v).size) for v in want.values())
    assert out.getvalue().splitlines()[0] == (
        f"Exported {name} ({n / 1e6:.2f}M params) from {snap} -> {tmp_path / 'w.pth'}")
    pth = torch.load(tmp_path / "w.pth", weights_only=True)
    with np.load(tmp_path / "w.npz") as f:
        npz = {k: f[k] for k in f.files}
    for got in ({k: v.numpy() for k, v in pth.items()}, npz):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_cli_export_torch_refuses_what_jax_refuses(tmp_path):
    """U-Net++ has no upstream layout: JAX's KeyError, word for word; a
    missing checkpoint is named."""
    from eelunet_tpu.models.torch_port import export_state_dict as jax_export

    with pytest.raises(KeyError) as jax_err:
        jax_export("unet++", {})
    with pytest.raises(KeyError) as err:
        export_torch_cli.main(["--model_type", "unetpp", "--checkpoint", str(tmp_path),
                               "--output", str(tmp_path / "w.pth")])
    assert str(err.value) == str(jax_err.value)
    with pytest.raises(FileNotFoundError, match="checkpoint not found"):
        export_torch_cli.main(["--model_type", "unet", "--checkpoint", str(tmp_path / "none"),
                               "--output", str(tmp_path / "w.pth")])
