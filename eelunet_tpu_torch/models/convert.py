"""Weight conversion into the port's ``state_dict``, for every family
(counterpart of ``eelunet_tpu/models/torch_port.py``).

Three layouts meet here:

- the JAX package's flax variables (``{"params", "batch_stats"}`` trees of
  numpy arrays): conv kernels HWIO, transposed-conv kernels HWIO and spatially
  flipped, Dense kernels (in, out), norms with ``scale``;
- the upstream torch layout that ``python -m eelunet_tpu.cli.export_torch``
  writes (``.pth`` or ``.npz``) and reference checkpoints use: torch layouts,
  upstream module names, and the decoder bridges' input channels interleaved
  ``[d0, e0, d1, e1, ...]``;
- the port's own: torch layouts, names that mirror the flax module names, and
  the bridges concatenated ``[d... | e...]`` as in the JAX forward.

For the EELUnet one rule list (``_eelunet_rules``, the same as
``torch_port.py``'s) names each tensor group in the first two layouts; the
port's name follows from the flax path by a fixed rewrite (``port_prefix``).

The other families' port modules carry the upstream names, so their port
layout *is* the upstream layout: the upstream route is an identity with a
strict key check, and only the flax route needs their rule lists (copies of
``torch_port.py:66-297``), whose second field is then both the upstream and
the port name. U-Net++ has no upstream layout (upstream's model crashes); its
rules name the port's own modules, which are its checkpoint layout.

Rule kinds (torch layout on the right): conv HWIO -> (O, I, kh, kw);
convt flipped HWIO -> (I, O, kh, kw); conv1d (k, 1, I, O) -> (O, I, k);
dense (I, O) -> (O, I); ea_dense, a flax (I, O) matrix -> the (O, I, 1)
Conv1d weight; ghpa_param NHWC -> NCHW; ln, gn, bn with ``scale`` -> weight.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

Rule = Tuple[str, str, str]  # (flax_dir, upstream_prefix, kind)
StateDict = Dict[str, torch.Tensor]


def _capmlp(fp: str, tp: str) -> List[Rule]:
    """ChannelAwarePatchedMLP (EELUnet.py:101-123)."""
    return [
        (f"{fp}/TorchConv_0/Conv_0", f"{tp}.to_patch", "conv"),
        (f"{fp}/ChannelAttention_0/TorchConv_0/Conv_0", f"{tp}.channel_attention.fc1", "conv"),
        (f"{fp}/ChannelAttention_0/TorchConv_1/Conv_0", f"{tp}.channel_attention.fc2", "conv"),
        (f"{fp}/TorchDense_0/Dense_0", f"{tp}.mlp.0", "dense"),
        (f"{fp}/TorchDense_1/Dense_0", f"{tp}.mlp.2", "dense"),
        (f"{fp}/TorchConv_1/Conv_0", f"{tp}.to_space", "conv"),
    ]


def _eel_conv_block(fp: str, tp: str, mlp: bool, interleave: bool = False) -> List[Rule]:
    """conv_block / mlp_conv_block (EELUnet.py:335-359): params at .0 .1 .3 .4."""
    rules = [
        (f"{fp}/TorchConv_0/Conv_0", f"{tp}.0", "conv_il" if interleave else "conv"),
        (f"{fp}/BatchNorm_0/BatchNorm_0", f"{tp}.1", "bn"),
        (f"{fp}/BatchNorm_1/BatchNorm_0", f"{tp}.4", "bn"),
    ]
    if mlp:
        rules += _capmlp(f"{fp}/ChannelAwarePatchedMLP_0", f"{tp}.3")
    else:
        rules.append((f"{fp}/TorchConv_1/Conv_0", f"{tp}.3", "conv"))
    return rules


def _eel_upconv(fp: str, tp: str, mlp: bool) -> List[Rule]:
    """upconv_block / mlp_upconv_block (EELUnet.py:361-374)."""
    rules = [(f"{fp}/TorchConvTranspose_0/ConvTranspose_0", f"{tp}.0", "convt")]
    if mlp:
        rules += _capmlp(f"{fp}/ChannelAwarePatchedMLP_0", f"{tp}.1")
        rules.append((f"{fp}/BatchNorm_0/BatchNorm_0", f"{tp}.2", "bn"))
    else:
        rules.append((f"{fp}/BatchNorm_0/BatchNorm_0", f"{tp}.1", "bn"))
    return rules


def _eelunet_rules() -> List[Rule]:
    r: List[Rule] = []
    r += _eel_conv_block("enc1", "enc1.0", mlp=False)
    r += _eel_conv_block("enc2", "enc2.0", mlp=False)
    r += _eel_conv_block("enc3", "enc3.0", mlp=True)
    r += _eel_conv_block("enc4", "enc4.0", mlp=True)
    r += [
        ("bottleneck_bn/BatchNorm_0", "bottleneck.0", "bn"),
        ("bottleneck_conv/Conv_0", "bottleneck.1", "conv"),
    ]
    r += _capmlp("bottleneck_mlp", "bottleneck.3")
    for i in range(1, 6):
        r.append((f"pred{i}/TorchConv_0/Conv_0", f"pred{i}.conv", "conv"))
    r += _eel_upconv("edge_up4", "edge_upconv_4.0", mlp=True)
    r += _eel_conv_block("edge_conv4", "edge_upconv_4.1", mlp=True)
    r += _eel_upconv("edge_up3", "edge_upconv_3.0", mlp=True)
    r += _eel_conv_block("edge_conv3", "edge_upconv_3.1", mlp=True)
    # edge_upconv_2/1 hold the parameter-free HighFourierTransform at index 1
    r += _eel_upconv("edge_up2", "edge_upconv_2.0", mlp=False)
    r += _eel_conv_block("edge_conv2", "edge_upconv_2.2", mlp=False)
    r += _eel_upconv("edge_up1", "edge_upconv_1.0", mlp=False)
    r += _eel_conv_block("edge_conv1", "edge_upconv_1.2", mlp=False)
    r += _eel_upconv("upconv4", "upconv4", mlp=True)
    r += _eel_upconv("upconv3", "upconv3", mlp=True)
    r += _eel_upconv("upconv2", "upconv2", mlp=False)
    r += _eel_upconv("upconv1", "upconv1", mlp=False)
    r += _eel_conv_block("dec4", "dec4", mlp=True, interleave=True)
    r += _eel_conv_block("dec3", "dec3", mlp=True, interleave=True)
    r += _eel_conv_block("dec2", "dec2", mlp=False, interleave=True)
    r += _eel_conv_block("dec1", "dec1", mlp=False, interleave=True)
    r += [
        ("final_ln/LayerNorm_0", "final.0", "ln"),
        ("final_conv/Conv_0", "final.1", "conv"),
    ]
    return r


def _unet_rules() -> List[Rule]:
    rules: List[Rule] = []
    blocks = [
        ("ConvBlock_0", "enc1"), ("ConvBlock_1", "enc2"), ("ConvBlock_2", "enc3"),
        ("ConvBlock_3", "enc4"), ("ConvBlock_4", "bottleneck"), ("ConvBlock_5", "conv4"),
        ("ConvBlock_6", "conv3"), ("ConvBlock_7", "conv2"), ("ConvBlock_8", "conv1"),
    ]
    for fb, tb in blocks:  # Unet.py:33-40: Sequential(Conv,ReLU,Conv,ReLU)
        rules.append((f"{fb}/TorchConv_0/Conv_0", f"{tb}.0", "conv"))
        rules.append((f"{fb}/TorchConv_1/Conv_0", f"{tb}.2", "conv"))
    for fu, tu in [("UpConvBlock_0", "upconv4"), ("UpConvBlock_1", "upconv3"),
                   ("UpConvBlock_2", "upconv2"), ("UpConvBlock_3", "upconv1")]:
        rules.append((f"{fu}/TorchConvTranspose_0/ConvTranspose_0", f"{tu}.0", "convt"))
    rules.append(("TorchConv_0/Conv_0", "final_conv", "conv"))
    return rules


def _unetpp_rules(depth: int = 5) -> List[Rule]:
    """The port's own names for the JAX ``UnetPlusPlus`` tree
    (``eelunet_tpu/models/unetpp.py``): ``x_i_j`` conv blocks, ``up_i_j``
    transposed convs, ``final``."""
    rules: List[Rule] = []
    nodes = [(i, 0) for i in range(depth)] + [(i, j) for j in range(1, depth)
                                              for i in range(depth - j)]
    for i, j in nodes:
        if j > 0:
            rules.append((f"up_{i}_{j}/ConvTranspose_0", f"up_{i}_{j}", "convt"))
        rules.append((f"x_{i}_{j}/TorchConv_0/Conv_0", f"x_{i}_{j}.0", "conv"))
        rules.append((f"x_{i}_{j}/TorchConv_1/Conv_0", f"x_{i}_{j}.2", "conv"))
    rules.append(("final/Conv_0", "final", "conv"))
    return rules


def _unext_rules() -> List[Rule]:
    r: List[Rule] = []
    for i in (1, 2, 3):
        r.append((f"encoder{i}/Conv_0", f"encoder{i}", "conv"))
        r.append((f"ebn{i}/BatchNorm_0", f"ebn{i}", "bn"))
    for pe in ("patch_embed3", "patch_embed4"):
        r.append((f"{pe}/proj", f"{pe}.proj", "conv"))
        r.append((f"{pe}/norm", f"{pe}.norm", "ln"))
    # blockN are single-element ModuleLists (unext.py:220-238)
    for fb, tb in [("block1", "block1.0"), ("block2", "block2.0"),
                   ("dblock1", "dblock1.0"), ("dblock2", "dblock2.0")]:
        r.append((f"{fb}/norm2", f"{tb}.norm2", "ln"))
        r.append((f"{fb}/mlp/fc1", f"{tb}.mlp.fc1", "dense"))
        r.append((f"{fb}/mlp/dwconv/Conv_0", f"{tb}.mlp.dwconv.dwconv", "conv"))
        r.append((f"{fb}/mlp/fc2", f"{tb}.mlp.fc2", "dense"))
    for n in ("norm3", "norm4", "dnorm3", "dnorm4"):
        r.append((n, n, "ln"))
    for i in (1, 2, 3, 4, 5):
        r.append((f"decoder{i}/Conv_0", f"decoder{i}", "conv"))
    for i in (1, 2, 3, 4):
        r.append((f"dbn{i}/BatchNorm_0", f"dbn{i}", "bn"))
    r.append(("final/Conv_0", "final", "conv"))
    return r


def _ghpa(fp: str, tp: str) -> List[Rule]:
    """Grouped multi-axis Hadamard Product Attention (egeunet.py:96-160)."""
    return [
        (f"{fp}/params_xy", f"{tp}.params_xy", "ghpa_param"),
        (f"{fp}/params_zx", f"{tp}.params_zx", "ghpa_param"),
        (f"{fp}/params_zy", f"{tp}.params_zy", "ghpa_param"),
        (f"{fp}/conv_xy_dw/Conv_0", f"{tp}.conv_xy.0", "conv"),
        (f"{fp}/conv_xy_pw/Conv_0", f"{tp}.conv_xy.2", "conv"),
        (f"{fp}/conv_zx_dw/Conv_0", f"{tp}.conv_zx.0", "conv1d"),
        (f"{fp}/conv_zx_pw/Conv_0", f"{tp}.conv_zx.2", "conv1d"),
        (f"{fp}/conv_zy_dw/Conv_0", f"{tp}.conv_zy.0", "conv1d"),
        (f"{fp}/conv_zy_pw/Conv_0", f"{tp}.conv_zy.2", "conv1d"),
        (f"{fp}/dw_pw/Conv_0", f"{tp}.dw.0", "conv"),
        (f"{fp}/dw_dw/Conv_0", f"{tp}.dw.2", "conv"),
        (f"{fp}/norm1/LayerNorm_0", f"{tp}.norm1", "ln"),
        (f"{fp}/norm2/LayerNorm_0", f"{tp}.norm2", "ln"),
        (f"{fp}/ldw_dw/Conv_0", f"{tp}.ldw.0", "conv"),
        (f"{fp}/ldw_pw/Conv_0", f"{tp}.ldw.2", "conv"),
    ]


def _egeunet_rules() -> List[Rule]:
    r: List[Rule] = []
    r.append(("encoder1/Conv_0", "encoder1.0", "conv"))
    r.append(("encoder2/Conv_0", "encoder2.0", "conv"))
    r.append(("encoder3_conv/Conv_0", "encoder3.0", "conv"))
    # ConvLayer (egeunet.py:163-183)
    r += [
        ("encoder3_block/conv1/Conv_0", "encoder3.1.conv1", "conv"),
        ("encoder3_block/norm1/BatchNorm_0", "encoder3.1.norm1", "bn"),
        ("encoder3_block/conv2/Conv_0", "encoder3.1.conv2", "conv"),
        ("encoder3_block/conv3/Conv_0", "encoder3.1.conv3", "conv"),
        ("encoder3_block/norm2/BatchNorm_0", "encoder3.1.norm2", "bn"),
    ]
    for f, t in [("encoder4", "encoder4.0"), ("encoder5", "encoder5.0"),
                 ("encoder6", "encoder6.0"), ("decoder1", "decoder1.0"),
                 ("decoder2", "decoder2.0"), ("decoder3", "decoder3.0")]:
        r += _ghpa(f, t)
    for i in (1, 2, 3):
        r.append((f"down{i}/bn/BatchNorm_0", f"Down{i}.bn", "bn"))
        r.append((f"down{i}/conv/Conv_0", f"Down{i}.conv", "conv"))
    for i in (1, 2, 3, 4, 5):
        r.append((f"ebn{i}/GroupNorm_0", f"ebn{i}", "gn"))
        r.append((f"dbn{i}/GroupNorm_0", f"dbn{i}", "gn"))
        r.append((f"pred{i}/conv/Conv_0", f"pred{i}.conv", "conv"))
    r.append(("decoder4/Conv_0", "decoder4.0", "conv"))
    r.append(("decoder5/Conv_0", "decoder5.0", "conv"))
    r.append(("final/Conv_0", "final", "conv"))
    return r


def _mal_dwc(fp: str, tp: str) -> List[Rule]:
    """DepthWiseConv2d (malunet.py:9-19)."""
    return [
        (f"{fp}/conv1/Conv_0", f"{tp}.conv1", "conv"),
        (f"{fp}/norm/GroupNorm_0", f"{tp}.norm_layer", "gn"),
        (f"{fp}/conv2/Conv_0", f"{tp}.conv2", "conv"),
    ]


def _mal_dga(fp: str, tp: str) -> List[Rule]:
    """DilatedGatedAttention + GAU (malunet.py:22-76). GAU w1/w2/wo are
    Sequential(DepthWiseConv2d, activation) so params live at .0."""
    r = [(f"{fp}/mda{i}/Conv_0", f"{tp}.mda{i}", "conv") for i in range(4)]
    r += [
        (f"{fp}/norm/GroupNorm_0", f"{tp}.norm_layer", "gn"),
        (f"{fp}/conv/Conv_0", f"{tp}.conv", "conv"),
        (f"{fp}/gau/cw/Conv_0", f"{tp}.gau.cw", "conv"),
    ]
    for w in ("w1", "w2", "wo"):
        r += _mal_dwc(f"{fp}/gau/{w}", f"{tp}.gau.{w}.0")
    return r


def _mal_ea(fp: str, tp: str) -> List[Rule]:
    """EAblock (malunet.py:79-111)."""
    return [
        (f"{fp}/conv1/Conv_0", f"{tp}.conv1", "conv"),
        (f"{fp}/linear_0", f"{tp}.linear_0", "ea_dense"),
        (f"{fp}/linear_1", f"{tp}.linear_1", "ea_dense"),
        (f"{fp}/conv2/Conv_0", f"{tp}.conv2", "conv"),
        (f"{fp}/norm/GroupNorm_0", f"{tp}.norm_layer", "gn"),
    ]


def _malunet_rules() -> List[Rule]:
    r: List[Rule] = []
    for i in (1, 2, 3):
        r.append((f"encoder{i}/Conv_0", f"encoder{i}.0", "conv"))
    for i in (4, 5, 6):  # Sequential(EAblock, DGA) (malunet.py:216-226)
        r += _mal_ea(f"encoder{i}_ea", f"encoder{i}.0")
        r += _mal_dga(f"encoder{i}_dga", f"encoder{i}.1")
    for i in (1, 2, 3):  # Sequential(DGA, EAblock) (malunet.py:233-243)
        r += _mal_dga(f"decoder{i}_dga", f"decoder{i}.0")
        r += _mal_ea(f"decoder{i}_ea", f"decoder{i}.1")
    r.append(("decoder4/Conv_0", "decoder4.0", "conv"))
    r.append(("decoder5/Conv_0", "decoder5.0", "conv"))
    for i in (1, 2, 3, 4, 5):
        r.append((f"ebn{i}/GroupNorm_0", f"ebn{i}", "gn"))
        r.append((f"dbn{i}/GroupNorm_0", f"dbn{i}", "gn"))
    # SC_Att_Bridge (malunet.py:114-195)
    r.append(("scab/satt/shared_conv/Conv_0", "scab.satt.shared_conv2d.0", "conv"))
    r.append(("scab/catt/get_all_att", "scab.catt.get_all_att", "conv1d"))
    for i in (1, 2, 3, 4, 5):
        r.append((f"scab/catt/att{i}", f"scab.catt.att{i}", "dense"))
    r.append(("final/Conv_0", "final", "conv"))
    return r


# The families whose port names are their upstream names (rule lists as in
# torch_port.py's RULES), and U-Net++ under the port's own names.
RULES = {
    "unet": _unet_rules,
    "unet++": _unetpp_rules,
    "unext": _unext_rules,
    "unext_s": _unext_rules,  # identical names, smaller dims (unext.py:328-462)
    "egeunet": _egeunet_rules,
    "malunet": _malunet_rules,
}


# flax leaf modules (dropped from the port's names) and the rewrite of the
# flax wrapper modules' names into the port's attribute names.
_LEAF_MODULES = {"Conv_0", "ConvTranspose_0", "Dense_0", "LayerNorm_0", "BatchNorm_0"}
_SEGMENTS = (
    (re.compile(r"TorchConv_(\d+)"), r"conv\1"),
    (re.compile(r"BatchNorm_(\d+)"), r"bn\1"),
    (re.compile(r"TorchDense_(\d+)"), r"fc\1"),
    (re.compile(r"TorchConvTranspose_0"), "convt"),
    (re.compile(r"ChannelAwarePatchedMLP_0"), "capmlp"),
    (re.compile(r"ChannelAttention_0"), "attn"),
)


def port_prefix(flax_dir: str) -> str:
    """``enc3/ChannelAwarePatchedMLP_0/TorchDense_0/Dense_0`` ->
    ``enc3.capmlp.fc0``: drop the leaf module, rewrite the wrappers."""
    parts = flax_dir.split("/")
    if parts[-1] in _LEAF_MODULES:
        parts = parts[:-1]
    out = []
    for p in parts:
        for pat, rep in _SEGMENTS:
            if pat.fullmatch(p):
                p = pat.sub(rep, p)
                break
        out.append(p)
    return ".".join(out)


_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def _t(a) -> torch.Tensor:
    # a contiguous copy: jax buffers are read-only, flipped views have
    # negative strides
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C", copy=True))


def _tracked() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64)


def _grab(tree, path: str, family: str) -> np.ndarray:
    node = tree
    for p in path.split("/"):
        if not isinstance(node, dict) or p not in node:
            raise KeyError(f"{family}: flax tree is missing '{path}'")
        node = node[p]
    return np.asarray(node, dtype=np.float32)


def _has(tree, path: str) -> bool:
    node = tree
    for p in path.split("/"):
        if not isinstance(node, dict) or p not in node:
            return False
        node = node[p]
    return True


def _family_from_flax(variables: Dict[str, Any], family: str) -> StateDict:
    """A family's flax variables -> its port ``state_dict`` under the rule
    list's torch names (``torch_port.export_state_dict``'s layout moves)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    grab = lambda tree, path: _grab(tree, path, family)  # noqa: E731
    sd: StateDict = {}
    for flax_dir, tp, kind in RULES[family]():
        if family == "malunet" and tp.startswith("scab.") and not _has(params, "scab"):
            continue  # bridge=False
        if kind == "conv":
            sd[f"{tp}.weight"] = _t(np.transpose(grab(params, f"{flax_dir}/kernel"), (3, 2, 0, 1)))
        elif kind == "convt":  # flipped HWIO -> (cin, cout, kh, kw)
            w = grab(params, f"{flax_dir}/kernel")[::-1, ::-1]
            sd[f"{tp}.weight"] = _t(np.transpose(w, (2, 3, 0, 1)))
        elif kind == "conv1d":  # (k, 1, I, O) -> (O, I, k)
            w = grab(params, f"{flax_dir}/kernel")
            sd[f"{tp}.weight"] = _t(np.transpose(w, (3, 2, 0, 1))[:, :, :, 0])
        elif kind == "dense":
            sd[f"{tp}.weight"] = _t(grab(params, f"{flax_dir}/kernel").T)
        elif kind == "ea_dense":  # (I, O) matmul operand -> (O, I, 1) Conv1d weight
            sd[f"{tp}.weight"] = _t(grab(params, flax_dir).T[:, :, None])
        elif kind == "ghpa_param":  # NHWC -> NCHW
            sd[tp] = _t(np.transpose(grab(params, flax_dir), (0, 3, 1, 2)))
        elif kind in ("ln", "gn", "bn"):
            sd[f"{tp}.weight"] = _t(grab(params, f"{flax_dir}/scale"))
        else:  # pragma: no cover
            raise ValueError(f"unknown rule kind {kind}")
        optional_bias = kind in ("conv", "conv1d")  # convs made with bias=False have none
        if kind not in ("ea_dense", "ghpa_param") and (
                not optional_bias or _has(params, f"{flax_dir}/bias")):
            sd[f"{tp}.bias"] = _t(grab(params, f"{flax_dir}/bias"))
        if kind == "bn":
            sd[f"{tp}.running_mean"] = _t(grab(stats, f"{flax_dir}/mean"))
            sd[f"{tp}.running_var"] = _t(grab(stats, f"{flax_dir}/var"))
            sd[f"{tp}.num_batches_tracked"] = _tracked()
    return sd


def from_flax_variables(variables: Dict[str, Any], model_name: str = "eelunet") -> StateDict:
    """The JAX package's variables of family ``model_name`` (numpy trees,
    unfolded) -> the port's ``state_dict``. The EELUnet's bridge order is
    the same in both, so no channel permutation is applied."""
    if model_name != "eelunet":
        return _family_from_flax(variables, _family(model_name))
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    def grab(tree, path):
        node = tree
        for p in path.split("/"):
            node = node[p]
        return np.asarray(node, dtype=np.float32)

    sd: StateDict = {}
    for flax_dir, _, kind in _eelunet_rules():
        pp = port_prefix(flax_dir)
        if kind in ("conv", "conv_il"):
            sd[f"{pp}.weight"] = _t(np.transpose(grab(params, f"{flax_dir}/kernel"), (3, 2, 0, 1)))
            sd[f"{pp}.bias"] = _t(grab(params, f"{flax_dir}/bias"))
        elif kind == "convt":  # flipped HWIO -> (cin, cout, kh, kw)
            w = grab(params, f"{flax_dir}/kernel")[::-1, ::-1]
            sd[f"{pp}.weight"] = _t(np.transpose(w, (2, 3, 0, 1)))
            sd[f"{pp}.bias"] = _t(grab(params, f"{flax_dir}/bias"))
        elif kind == "dense":
            sd[f"{pp}.weight"] = _t(grab(params, f"{flax_dir}/kernel").T)
            sd[f"{pp}.bias"] = _t(grab(params, f"{flax_dir}/bias"))
        elif kind == "ln":
            sd[f"{pp}.weight"] = _t(grab(params, f"{flax_dir}/scale"))
            sd[f"{pp}.bias"] = _t(grab(params, f"{flax_dir}/bias"))
        elif kind == "bn":
            sd[f"{pp}.weight"] = _t(grab(params, f"{flax_dir}/scale"))
            sd[f"{pp}.bias"] = _t(grab(params, f"{flax_dir}/bias"))
            sd[f"{pp}.running_mean"] = _t(grab(stats, f"{flax_dir}/mean"))
            sd[f"{pp}.running_var"] = _t(grab(stats, f"{flax_dir}/var"))
            sd[f"{pp}.num_batches_tracked"] = _tracked()
        else:  # pragma: no cover
            raise ValueError(f"unknown rule kind {kind}")
    return sd


def _interleave_to_concat(w: torch.Tensor) -> torch.Tensor:
    """Reorder (O, I, kh, kw) input channels from [d0,e0,d1,e1,..] to [d...|e...]."""
    return torch.cat([w[:, 0::2], w[:, 1::2]], dim=1)


def _concat_to_interleave(w: torch.Tensor) -> torch.Tensor:
    n = w.shape[1] // 2
    out = torch.empty_like(w)
    out[:, 0::2] = w[:, :n]
    out[:, 1::2] = w[:, n:]
    return out


def _suffixes(kind: str) -> Tuple[str, ...]:
    return _BN_KEYS + ("num_batches_tracked",) if kind == "bn" else ("weight", "bias")


def _family(model_name: str) -> str:
    if model_name not in RULES:
        raise KeyError(f"no weight mapping for model {model_name!r} "
                       f"(supported: {sorted(RULES) + ['eelunet']})")
    return model_name


def _family_keys(family: str, sd: Dict[str, Any]) -> List[str]:
    """The port (= upstream) keys of ``family``'s rule list, in rule order.
    Optional conv biases count where ``sd`` has them; MALUNet's bridge
    (``scab.*``) where ``sd`` has any of it."""
    keys: List[str] = []
    bridge = any(k.startswith("scab.") for k in sd)
    for _, tp, kind in RULES[family]():
        if family == "malunet" and tp.startswith("scab.") and not bridge:
            continue
        if kind == "ghpa_param":
            keys.append(tp)
        elif kind == "ea_dense":
            keys.append(f"{tp}.weight")
        elif kind in ("conv", "conv1d"):
            keys += [f"{tp}.weight"] + ([f"{tp}.bias"] if f"{tp}.bias" in sd else [])
        else:
            keys += [f"{tp}.{suf}" for suf in _suffixes(kind)]
    return keys


def from_upstream_state_dict(sd: Dict[str, Any], model_name: str = "eelunet") -> StateDict:
    """An upstream-layout ``state_dict`` of family ``model_name`` (names ->
    numpy arrays or tensors) -> the port's ``state_dict``. Raises on a
    missing or unmapped tensor. For every family but the EELUnet the two
    layouts are one, so this checks the keys and converts the values."""
    if model_name != "eelunet":
        family = _family(model_name)
        sd = dict(sd)
        out: StateDict = {}
        for key in _family_keys(family, sd):
            if key.endswith(".num_batches_tracked"):
                v = sd.pop(key, None)
                out[key] = _tracked() if v is None else torch.as_tensor(
                    np.asarray(v), dtype=torch.int64).reshape(())
                continue
            if key not in sd:
                raise KeyError(f"{family}: upstream state_dict is missing '{key}'")
            out[key] = torch.tensor(np.asarray(sd.pop(key), dtype=np.float32)).contiguous()
        if sd:
            raise ValueError(f"{family}: {len(sd)} upstream tensors were not mapped: "
                             f"{sorted(sd)[:8]}")
        return out
    sd = dict(sd)
    out: StateDict = {}
    for flax_dir, tp, kind in _eelunet_rules():
        pp = port_prefix(flax_dir)
        for suf in _suffixes(kind):
            key = f"{tp}.{suf}"
            if suf == "num_batches_tracked":
                v = sd.pop(key, None)
                out[f"{pp}.{suf}"] = _tracked() if v is None else torch.as_tensor(
                    np.asarray(v), dtype=torch.int64).reshape(())
                continue
            if key not in sd:
                raise KeyError(f"eelunet: upstream state_dict is missing '{key}'")
            v = torch.tensor(np.asarray(sd.pop(key), dtype=np.float32))
            if kind == "conv_il" and suf == "weight":
                v = _interleave_to_concat(v)
            out[f"{pp}.{suf}"] = v.contiguous()
    if sd:
        raise ValueError(f"eelunet: {len(sd)} upstream tensors were not mapped: "
                         f"{sorted(sd)[:8]}")
    return out


def to_upstream_state_dict(sd: StateDict, model_name: str = "eelunet") -> Dict[str, np.ndarray]:
    """Inverse of :func:`from_upstream_state_dict`: the port's unfolded
    ``state_dict`` -> upstream names (and the EELUnet's bridge order), as
    numpy arrays; U-Net++ keeps the port's names."""
    if model_name != "eelunet":
        family = _family(model_name)
        return {k: sd[k].detach().cpu().numpy() if k.endswith(".num_batches_tracked")
                else sd[k].detach().cpu().float().numpy() for k in _family_keys(family, sd)}
    out: Dict[str, np.ndarray] = {}
    for flax_dir, tp, kind in _eelunet_rules():
        pp = port_prefix(flax_dir)
        for suf in _suffixes(kind):
            v = sd[f"{pp}.{suf}"].detach().cpu()
            if kind == "conv_il" and suf == "weight":
                v = _concat_to_interleave(v)
            out[f"{tp}.{suf}"] = v.numpy() if suf == "num_batches_tracked" else v.float().numpy()
    return out


def load_upstream_checkpoint(path: str, model_name: str = "eelunet") -> StateDict:
    """Read an upstream-layout checkpoint of family ``model_name`` (``.npz``
    from ``cli.export_torch --numpy`` or the port's best tags, or a torch
    ``.pth``) and convert it to the port's ``state_dict``."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            raw = {k: f[k] for k in f.files}
    else:
        obj = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(obj, "state_dict"):
            obj = obj.state_dict()
        raw = {k: v.detach().cpu().numpy() for k, v in obj.items()}
    return from_upstream_state_dict(raw, model_name)
