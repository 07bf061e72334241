"""The five families other than the EELUnet in the port: the registry, the
parameter counts, the weight routes (flax variables, upstream layout and
back), BN folding, UNeXt's shift, EGE-UNet's loss, the families' inits, and
the CLIs on the CPU. Forward and train-step parity with the JAX package are
in tests/test_torch_port_families_forward.py and
tests/test_torch_port_families_train*.py."""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eelunet_tpu import losses as jax_losses
from eelunet_tpu.bnfold import fold_bn_eval as jax_fold_bn_eval
from eelunet_tpu.models.torch_port import export_state_dict
from eelunet_tpu.models.unext import shift_chunks as jax_shift_chunks
from eelunet_tpu.registry import MODEL_REGISTRY as JAX_MODEL_REGISTRY
from eelunet_tpu_torch import losses
from eelunet_tpu_torch.bnfold import FOLDABLE_MODELS, fold_bn_eval
from eelunet_tpu_torch.cli import evaluate as evaluate_cli
from eelunet_tpu_torch.cli import train as train_cli
from eelunet_tpu_torch.cli.common import base_parser, load_config
from eelunet_tpu_torch.config import LossConfig, ModelConfig
from eelunet_tpu_torch.data.synthetic import write_synthetic_tree
from eelunet_tpu_torch.inference import Predictor, random_state_dict
from eelunet_tpu_torch.models.convert import (
    from_flax_variables,
    from_upstream_state_dict,
    load_upstream_checkpoint,
    to_upstream_state_dict,
)
from eelunet_tpu_torch.models.unext import shift_chunks
from eelunet_tpu_torch.nn.layers import nchw, nhwc
from eelunet_tpu_torch.registry import MODEL_REGISTRY, NOT_PORTED, create_model
from torch_port_families import (
    FAMILIES,
    family_input,
    family_variables,
    port_forward,
    port_model,
)

# tests/test_models.py:18-25, in millions; U-Net++ has no reference count.
PARAM_COUNTS = {"unet": 31.03, "unext": 1.47, "unext_s": 0.25, "egeunet": 0.044,
                "malunet": 0.178, "unet++": None}
UPSTREAM = ("unet", "unext", "unext_s", "egeunet", "malunet")


def test_every_family_is_ported_and_every_model_type_builds():
    assert NOT_PORTED == ()
    assert MODEL_REGISTRY == JAX_MODEL_REGISTRY
    choices = next(a for a in base_parser("x")._actions if a.dest == "model_type").choices
    assert set(choices) == set(MODEL_REGISTRY) | {"unetpp"}
    for name in choices:
        args = base_parser("x").parse_args(["--model_type", name])
        cfg = load_config(args)
        model, meta = create_model(cfg.model, device="meta")
        assert meta.name == cfg.model.name == ("unet++" if name == "unetpp" else name)
        # every family takes the 4th input channel of data.add_canny_edge
        model4, _ = create_model(ModelConfig(name=cfg.model.name, in_channels=4), device="meta")
        first = lambda m: next(p for p in m.parameters() if p.dim() == 4)  # noqa: E731
        assert first(model).shape[1] == 3 and first(model4).shape[1] == 4, name
    with pytest.raises(ValueError, match="widths"):
        create_model(ModelConfig(name="unet"), widths=(("e1", 8),))


@pytest.mark.parametrize("name", FAMILIES)
def test_full_width_param_count(name):
    model, _ = create_model(ModelConfig(name=name), device="meta")
    n = sum(p.numel() for p in model.parameters()) / 1e6
    print(f"{name}: {n:.4f}M parameters")
    if PARAM_COUNTS[name] is None:
        assert 8.0 < n < 10.0, n
    else:
        assert abs(n - PARAM_COUNTS[name]) < 0.005, n


@pytest.mark.parametrize("name", UPSTREAM)
def test_flax_and_upstream_routes_agree(name):
    variables = family_variables(name)
    direct = from_flax_variables(variables, name)
    via_upstream = from_upstream_state_dict(export_state_dict(name, variables), name)
    assert direct.keys() == via_upstream.keys()
    for k in direct:
        assert direct[k].dtype == via_upstream[k].dtype
        assert torch.equal(direct[k], via_upstream[k]), k
    # the keys and shapes are the model's own
    model = port_model(name)
    assert {k: tuple(v.shape) for k, v in direct.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name", UPSTREAM)
def test_upstream_round_trip(name):
    variables = family_variables(name)
    sd = from_flax_variables(variables, name)
    up = to_upstream_state_dict(sd, name)
    want = export_state_dict(name, variables)
    assert up.keys() == want.keys()
    for k in up:
        assert up[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(up[k], want[k], err_msg=k)
    back = from_upstream_state_dict(up, name)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_upstream_route_refuses_a_wrong_layout():
    sd = to_upstream_state_dict(random_state_dict(ModelConfig(name="unext_s")), "unext_s")
    with pytest.raises(KeyError, match="missing 'final.weight'"):
        from_upstream_state_dict({k: v for k, v in sd.items() if k != "final.weight"},
                                 "unext_s")
    with pytest.raises(ValueError, match="not mapped"):
        from_upstream_state_dict({**sd, "extra.weight": np.zeros(1)}, "unext_s")
    with pytest.raises(KeyError, match="no weight mapping"):
        from_upstream_state_dict(sd, "nope")


def test_malunet_options_and_its_routes():
    """MALUNet without its bridge has no ``scab.*`` tensors, and its tags
    round-trip all the same; ``split_att="conv"`` is the same dense map
    (one code path, as in the JAX package)."""
    for bridge in (True, False):
        cfg = ModelConfig(name="malunet", bridge=bridge)
        sd = random_state_dict(cfg)
        assert any(k.startswith("scab.") for k in sd) == bridge
        back = from_upstream_state_dict(to_upstream_state_dict(sd, "malunet"), "malunet")
        model, _ = create_model(cfg)
        model.load_state_dict(back, strict=True)
    conv = random_state_dict(ModelConfig(name="malunet", split_att="conv"))
    assert {k: v.shape for k, v in conv.items()} == \
        {k: v.shape for k, v in random_state_dict(ModelConfig(name="malunet")).items()}
    with pytest.raises(ValueError, match="split_att"):
        create_model(ModelConfig(name="malunet", split_att="mlp"))


def test_drop_path():
    """Identity at rate 0 and in eval mode; otherwise whole samples are
    dropped or scaled by 1 / (1 - rate), drawn from the given generator."""
    from eelunet_tpu_torch.nn.layers import DropPath

    x = torch.ones(64, 2, 3, 3)
    assert DropPath(0.0).train()(x) is x
    assert DropPath(0.5, torch.Generator().manual_seed(0)).eval()(x) is x
    y = DropPath(0.25, torch.Generator().manual_seed(0)).train()(x)
    per_sample = y.flatten(1)
    assert set(per_sample.unique().tolist()) == {0.0, (torch.ones(()) / 0.75).item()}
    assert bool((per_sample == per_sample[:, :1]).all())
    y2 = DropPath(0.25, torch.Generator().manual_seed(0)).train()(x)
    assert torch.equal(y, y2) and 0 < int((per_sample[:, 0] == 0).sum()) < 64


def test_unetpp_has_its_own_names(tmp_path):
    """U-Net++ has no upstream layout: its flax route maps the JAX tree onto
    the port's module names, which its checkpoints keep."""
    variables = family_variables("unet++")
    sd = from_flax_variables(variables, "unet++")
    model = port_model("unet++")
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}
    n_leaves = len(jax.tree_util.tree_leaves(variables["params"]))
    assert len(sd) == n_leaves
    tag = to_upstream_state_dict(sd, "unet++")
    assert tag.keys() == sd.keys()
    path = tmp_path / "unetpp.npz"
    np.savez(path, **tag)
    back = load_upstream_checkpoint(str(path), "unet++")
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def _random_bn(sd, seed):
    g = torch.Generator().manual_seed(seed)
    out = dict(sd)
    for k, v in sd.items():
        if k.endswith(".running_var"):
            out[k] = 0.5 + torch.rand(v.shape, generator=g)
        elif k.endswith(".running_mean"):
            out[k] = 0.3 * torch.randn(v.shape, generator=g)
        elif k.rpartition(".")[0].endswith(("bn1", "bn2", "bn3", "bn4")) and \
                k.endswith((".weight", ".bias")):
            out[k] = 0.5 + torch.rand(v.shape, generator=g)
    return out


@pytest.mark.parametrize("name,n_pairs", [("unet", 0), ("unext", 7), ("unext_s", 7)])
def test_folded_model_is_same_function(name, n_pairs):
    variables = family_variables(name)
    sd = _random_bn(from_flax_variables(variables, name), 1)
    folded, n = fold_bn_eval(sd, name)
    _, bstats, n_jax = jax_fold_bn_eval(name, variables["params"],
                                        variables.get("batch_stats", {}))
    assert n == n_jax == n_pairs and bstats == {}
    assert not any(k.endswith("running_mean") for k in folded)
    x = family_input()
    if name == "unet":
        assert folded.keys() == sd.keys()
        return
    model, _ = create_model(ModelConfig(name=name))
    model.load_state_dict(sd, strict=True)
    model_f, _ = create_model(ModelConfig(name=name), bn_folded=True)
    model_f.load_state_dict(folded, strict=True)
    out0 = port_forward(model.to(memory_format=torch.channels_last), x)
    out1 = port_forward(model_f.to(memory_format=torch.channels_last), x)
    assert out0.seg.std() > 1e-3
    # tests/test_bnfold.py's bound for the same transform in JAX
    np.testing.assert_allclose(out1.seg.numpy(), out0.seg.numpy(), atol=2e-5, rtol=2e-5)


def test_unfoldable_families_stay_unfolded():
    assert set(FOLDABLE_MODELS) == {"eelunet", "unet", "unext", "unext_s"}
    for name in ("egeunet", "malunet", "unet++"):
        with pytest.raises(ValueError, match="BN folding"):
            fold_bn_eval(random_state_dict(ModelConfig(name=name)), name)
        with pytest.raises(ValueError, match="fold_bn=True"):
            Predictor(ModelConfig(name=name), fold_bn=True, device="cpu")


@pytest.mark.parametrize("c", [3, 4, 7, 12, 13, 16])
def test_shift_chunks_matches_jax(c):
    """torch.chunk gives fewer than five chunks below 5 channels, and a short
    last chunk where 5 does not divide them."""
    x = np.random.default_rng(c).standard_normal((2, 9, 11, c)).astype(np.float32)
    xt = nchw(torch.from_numpy(x)).contiguous(memory_format=torch.channels_last)
    for dim, axis in ((2, 1), (3, 2)):
        got = nhwc(shift_chunks(xt, dim)).numpy()
        want = np.asarray(jax_shift_chunks(jnp.asarray(x), axis=axis))
        np.testing.assert_array_equal(got, want)


def test_gt_bce_dice_matches_jax():
    rng = np.random.default_rng(0)
    out = rng.uniform(0, 1, (2, 16, 16, 1)).astype(np.float32)
    out[0, 0, 0, 0] = 1.0  # saturated: the -100 clamp
    aux = [rng.uniform(0, 1, out.shape).astype(np.float32) for _ in range(5)]
    target = (rng.uniform(0, 1, out.shape) > 0.6).astype(np.float32)
    cfg = LossConfig(wb=0.7, wd=1.3, lambda_edge=0.5)
    args = [torch.tensor(a, requires_grad=True) for a in [out] + aux]
    got = losses.LOSS_REGISTRY["gt_bce_dice"](args[1:], args[0], torch.from_numpy(target), cfg)
    got.backward()
    got = got.detach()

    def jax_loss(o, *a):
        return jax_losses.gt_bce_dice_loss(a, o, jnp.asarray(target), 0.7, 1.3, 0.5)

    want, grads = jax.value_and_grad(jax_loss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in [out] + aux))
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    for a, g in zip(args, grads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-7)
    assert losses.resolve_loss_name("auto", "egeunet") == "gt_bce_dice"
    for name in MODEL_REGISTRY:
        assert losses.resolve_loss_name("auto", name) == \
            jax_losses.resolve_loss_name("auto", name)


def test_families_init_from_the_jax_distributions():
    """``init_weights`` draws each family's scheme (``nn/init.py``)."""
    ege = dict(create_model(ModelConfig(name="egeunet"), device="meta")[0].named_modules())
    sd = random_state_dict(ModelConfig(name="egeunet"), seed=3)
    # kaiming-normal over fan_out / groups, zero bias: encoder6's 1x1 ldw
    # conv (48 -> 64) has std sqrt(2 / 64), its depthwise 3x3 sqrt(2 / 9)
    w = sd["encoder6.0.ldw.2.weight"]
    assert abs(w.std().item() / (2 / w.shape[0]) ** 0.5 - 1) < 0.1
    assert abs(sd["encoder6.0.ldw.0.weight"].std().item() / (2 / 9) ** 0.5 - 1) < 0.15
    assert float(sd["encoder6.0.ldw.2.bias"].abs().max()) == 0.0
    # the reference's Conv1d init: N(0, sqrt(2 / (k out))) with no groups
    assert isinstance(ege["encoder4.0.conv_zx.0"], torch.nn.Conv1d)
    assert torch.equal(sd["encoder4.0.params_xy"], torch.ones(1, 6, 8, 8))
    mal = random_state_dict(ModelConfig(name="malunet"), seed=3)
    assert torch.equal(mal["encoder4.0.linear_1.weight"],
                       mal["encoder4.0.linear_0.weight"].permute(1, 0, 2))
    bound = 1 / 24 ** 0.5  # torch_linear_init over fan_in = C
    assert 0.9 * bound < float(mal["encoder4.0.linear_0.weight"].abs().max()) <= bound
    ux = random_state_dict(ModelConfig(name="unext"), seed=3)
    fc = ux["block1.0.mlp.fc1.weight"]
    assert float(fc.abs().max()) <= 0.04 and abs(fc.std().item() - 0.0176) < 0.002
    assert float(ux["block1.0.mlp.fc1.bias"].abs().max()) == 0.0
    # a new generator state gives new weights; the same seed the same ones
    assert torch.equal(random_state_dict(ModelConfig(name="unext"), seed=3)["final.weight"],
                       ux["final.weight"])


def test_egeunet_trains_and_evaluates_and_a_unext_s_tag_serves(tmp_path, capsys):
    """cli.train for EGE-UNet with data.add_canny_edge (4 input channels, the
    aux heads and gt_bce_dice), then cli.evaluate on its best tag prints the
    training run's metrics; a UNeXt-S best tag serves through the Predictor,
    folded, as the unfolded model does."""
    tree = write_synthetic_tree(str(tmp_path / "tree"), n_train=6, n_test=3,
                                image_size=(64, 64), seed=1)
    save, logs = tmp_path / "ckpt", tmp_path / "runs"
    common = ["--device", "cpu", "--data_dir", tree, "--image_size", "64",
              "--batch_size", "2", "--seed", "0", "--save_dir", str(save),
              "--set", "data.num_workers=1"]
    ege = common + ["--model_type", "egeunet", "--set", "data.add_canny_edge=true"]
    train_cli.main(ege + ["--epochs", "2", "--log_dir", str(logs)])
    out = capsys.readouterr().out
    assert "criterion: gt_bce_dice" in out
    root = save / "egeunet"
    hist = json.loads((root / "loss_history.json").read_text())
    assert np.all(np.isfinite(hist["train_loss"]))
    m = evaluate_cli.main(ege + ["--checkpoint", str(root / "egeunet_best.npz")])
    assert m == hist["metrics"][int(np.argmin(hist["val_loss"]))]

    train_cli.main(common + ["--model_type", "unext_s", "--epochs", "1",
                             "--log_dir", str(logs)])
    tag = str(save / "unext_s" / "unext_s_best.npz")
    images = np.random.default_rng(0).integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    folded = Predictor(ModelConfig(name="unext_s"), checkpoint=tag, device="cpu")
    plain = Predictor(ModelConfig(name="unext_s"), checkpoint=tag, fold_bn=False, device="cpu")
    assert not hasattr(folded.model, "ebn1") and hasattr(plain.model, "ebn1")
    p0, p1 = plain.predict_proba(images), folded.predict_proba(images)
    assert p1.shape == (3, 64, 64, 1)
    np.testing.assert_allclose(p1, p0, atol=2e-5)
