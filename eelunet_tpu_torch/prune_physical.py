"""Physical structured channel removal for U-Net and EELUnet
(counterpart of ``eelunet_tpu/prune_physical.py``).

The mask path (``prune.py``) keeps the zeroed weights in the tensors, so
compute does not shrink. This module removes the pruned channels: the slim
model's convs are narrower, and its parameters drop about (1 - amount)^2 on
the conv stack.

Removing conv L's output channels slices the input axis of every consumer
of L. Each channel group below has producers (their output axis defines the
channel set), the BNs on those channels, and consumers that read the
channels on their input axis. A consumer of a concat (the U-Net skips, the
EELUnet bridges ``[dec | enc]``) sees the encoder's channels after the
decoder's: its offset is the decoder group's width before the slice.

Slicing is exact only where a pruned channel's output is exactly zero: its
bias zeroed with its weights (``compute_prune_masks(..., zero_bias=True)``),
and for the EELUnet the BN affine of the channel too, since a masked channel
still emits ``(0 - mu) / sigma * gamma + beta`` after BN
(``eelunet_prune_masks``). The slim model then reproduces the masked one.

The EELUnet graph has four couplings the U-Net does not:

- edge/main ADD fusion: ``dec_i = upconv_i(x) + edge_dec_i`` pairs channels
  by index, so the two producers share one keep-set (the ``d{i}sum``
  groups, ranked by their combined L2);
- the bridge ``concat(dec_sum, crop(enc))`` into each ``dec{i}.conv0``;
- channel-shift quarters: a group feeding a ChannelAwarePatchedMLP passes
  through ``shifted_channel``, which rolls four channel quarters in
  different directions, so it keeps equal counts per quarter;
- BatchNorm statistics, sliced with their channels.

The CAPMLP internals (token_dim chains, the SE) are not pruned; only the
block output (``capmlp.fc1`` and ``capmlp.conv1``, which share the
``features`` width) is. ``dec1`` stays 64 wide: the final LayerNorm
normalises over it, and dropping exact-zero channels changes its statistics.

The other families keep the mask path, as in the JAX package: their norms
(LayerNorm, GroupNorm) take statistics over the channel axis, so slicing a
masked channel changes the function.

Names are the port's ``state_dict`` names; a path carries its layout kind:
``conv`` (O, I, ...), ``convt`` (I, O, kh, kw) and ``dense`` (O, I).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]
Path = Tuple[str, str]                      # (module name, layout kind)
Offset = Union[int, str]                    # an int, or the group whose width it is
OUT_AXIS = {"conv": 0, "convt": 1, "dense": 0}
IN_AXIS = {"conv": 1, "convt": 0, "dense": 1}
SLIM_MODELS = ("unet", "eelunet")
_WEIGHTS = "model.pt"
_SIDECAR = "widths.json"


class Group:
    """One channel set: ``rank`` (the producers whose summed squared L2
    ranks it), ``producers`` (sliced on their output axis, with their
    biases), ``bns`` (sliced with their statistics), ``consumers`` (sliced
    on their input axis at an offset) and ``quarter`` (equal keeps per
    channel-shift quarter)."""

    __slots__ = ("name", "rank", "producers", "bns", "consumers", "quarter")

    def __init__(self, name: str, rank: List[Path], producers: List[Path], bns: List[str],
                 consumers: List[Tuple[Path, Offset]], quarter: bool = False):
        self.name, self.rank, self.producers = name, rank, producers
        self.bns, self.consumers, self.quarter = bns, consumers, quarter


def _c(name: str) -> Path:
    return (name, "conv")


def _t(name: str) -> Path:
    return (name, "convt")


def _d(name: str) -> Path:
    return (name, "dense")


# ------------------------------------------------------------------- U-Net

def unet_groups() -> List[Group]:
    """The vanilla U-Net's wiring (reference Unet.py:48-98): conv blocks at
    ``.0``/``.2``, transposed convs at ``upconv{i}.0``, and each decoder
    block reading ``[up_i | enc_i]``."""
    g: List[Group] = []

    def add(name, producer, consumers):
        g.append(Group(name, [producer], [producer], [], consumers))

    for i, blk in enumerate(("enc1", "enc2", "enc3", "enc4"), 1):
        nxt = f"enc{i + 1}.0" if i < 4 else "bottleneck.0"
        add(f"enc{i}_mid", _c(f"{blk}.0"), [(_c(f"{blk}.2"), 0)])
        add(f"enc{i}", _c(f"{blk}.2"), [(_c(f"{nxt}"), 0), (_c(f"conv{i}.0"), f"up{i}")])
    add("bot_mid", _c("bottleneck.0"), [(_c("bottleneck.2"), 0)])
    add("bot", _c("bottleneck.2"), [(_t("upconv4.0"), 0)])
    for i in (4, 3, 2, 1):
        nxt = _t(f"upconv{i - 1}.0") if i > 1 else _c("final_conv")
        add(f"up{i}", _t(f"upconv{i}.0"), [(_c(f"conv{i}.0"), 0)])
        add(f"dec{i}_mid", _c(f"conv{i}.0"), [(_c(f"conv{i}.2"), 0)])
        add(f"dec{i}", _c(f"conv{i}.2"), [(nxt, 0)])
    return g


def unet_widths(keeps: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The ``Unet`` constructor widths of a set of U-Net keep-sets."""
    n = {k: int(len(v)) for k, v in keeps.items()}
    return {
        "enc_widths": tuple((n[f"enc{i}_mid"], n[f"enc{i}"]) for i in range(1, 5)),
        "bottleneck_widths": (n["bot_mid"], n["bot"]),
        "up_widths": tuple(n[f"up{i}"] for i in (4, 3, 2, 1)),
        "dec_widths": tuple((n[f"dec{i}_mid"], n[f"dec{i}"]) for i in (4, 3, 2, 1)),
    }


# ----------------------------------------------------------------- EELUnet

def _cb(mod: str):
    """A plain ConvBlock's (conv0, bn0, conv1, bn1)."""
    return _c(f"{mod}.conv0"), f"{mod}.bn0", _c(f"{mod}.conv1"), f"{mod}.bn1"


def _capmlp(mod: str):
    """(first 1x1, fc1, final 1x1) of the ChannelAwarePatchedMLP at ``mod``."""
    return _c(f"{mod}.conv0"), _d(f"{mod}.fc1"), _c(f"{mod}.conv1")


def eelunet_groups() -> List[Group]:
    """The EELUnet's channel groups (reference EELUnet.py:228-471), in the
    JAX package's names and order (``prune_physical.eelunet_groups``)."""
    G: List[Group] = []
    for i in (1, 2):
        c0, b0, c1, b1 = _cb(f"enc{i}")
        G.append(Group(f"e{i}a", [c0], [c0], [b0], [(c1, 0)]))
        G.append(Group(f"e{i}", [c1], [c1], [b1], []))
    for i in (3, 4):
        mod = f"enc{i}"
        c0 = _c(f"{mod}.conv0")
        first, d1, fin = _capmlp(f"{mod}.capmlp")
        G.append(Group(f"e{i}a", [c0], [c0], [f"{mod}.bn0"], [(first, 0)], quarter=True))
        G.append(Group(f"e{i}", [fin], [d1, fin], [f"{mod}.bn1"], [(fin, 0)]))
    g = {x.name: x for x in G}
    g["e1"].consumers.append((_c("enc2.conv0"), 0))
    g["e2"].consumers.append((_c("enc3.conv0"), 0))
    g["e3"].consumers.append((_c("enc4.conv0"), 0))
    g["e4"].consumers.append((_c("bottleneck_conv"), 0))
    g["e4"].bns.append("bottleneck_bn")

    bfirst, bd1, bfin = _capmlp("bottleneck_mlp")
    G.append(Group("bna", [_c("bottleneck_conv")], [_c("bottleneck_conv")], [],
                   [(bfirst, 0)], quarter=True))
    G.append(Group("bot", [bfin], [bd1, bfin], [],
                   [(bfin, 0), (_c("pred5.conv0"), 0), (_t("edge_up4.convt"), 0),
                    (_t("upconv4.convt"), 0)]))

    for i, nxt_edge, pred in ((4, "edge_up3", "pred4"), (3, "edge_up2", "pred3")):
        eu, ec, up, dec = f"edge_up{i}", f"edge_conv{i}", f"upconv{i}", f"dec{i}"
        eufirst, eud1, eufin = _capmlp(f"{eu}.capmlp")
        ecfirst, ecd1, ecfin = _capmlp(f"{ec}.capmlp")
        upfirst, upd1, upfin = _capmlp(f"{up}.capmlp")
        dfirst, dd1, dfin = _capmlp(f"{dec}.capmlp")
        dec_c0, ec_c0 = _c(f"{dec}.conv0"), _c(f"{ec}.conv0")
        G.append(Group(f"eu{i}ct", [_t(f"{eu}.convt")], [_t(f"{eu}.convt")], [],
                       [(eufirst, 0)], quarter=True))
        G.append(Group(f"eu{i}", [eufin], [eud1, eufin], [f"{eu}.bn0"],
                       [(eufin, 0), (ec_c0, 0)]))
        G.append(Group(f"ec{i}a", [ec_c0], [ec_c0], [f"{ec}.bn0"], [(ecfirst, 0)],
                       quarter=True))
        G.append(Group(f"u{i}ct", [_t(f"{up}.convt")], [_t(f"{up}.convt")], [],
                       [(upfirst, 0)], quarter=True))
        # the fused edge + main block outputs (the add into dec_i)
        G.append(Group(f"d{i}sum", [ecfin, upfin], [ecd1, ecfin, upd1, upfin],
                       [f"{ec}.bn1", f"{up}.bn0"],
                       [(ecfin, 0), (upfin, 0), (_t(f"{nxt_edge}.convt"), 0)]))
        G.append(Group(f"d{i}a", [dec_c0], [dec_c0], [f"{dec}.bn0"], [(dfirst, 0)],
                       quarter=True))
        G.append(Group(f"d{i}", [dfin], [dd1, dfin], [f"{dec}.bn1"],
                       [(dfin, 0), (_c(f"{pred}.conv0"), 0), (_t(f"upconv{i - 1}.convt"), 0)]))

    # stages 2 and 1: plain conv blocks (the high-pass is channel-transparent)
    for i, nxt_edge in ((2, "edge_up1"), (1, None)):
        eu, ec, up, dec = f"edge_up{i}", f"edge_conv{i}", f"upconv{i}", f"dec{i}"
        ec0, ecb0, ec1, ecb1 = _cb(ec)
        dc0, dcb0, dc1, dcb1 = _cb(dec)
        G.append(Group(f"eu{i}", [_t(f"{eu}.convt")], [_t(f"{eu}.convt")], [f"{eu}.bn0"],
                       [(ec0, 0)]))
        G.append(Group(f"ec{i}a", [ec0], [ec0], [ecb0], [(ec1, 0)]))
        sum_cons = [] if nxt_edge is None else [(_t(f"{nxt_edge}.convt"), 0)]
        G.append(Group(f"d{i}sum", [ec1, _t(f"{up}.convt")], [ec1, _t(f"{up}.convt")],
                       [ecb1, f"{up}.bn0"], sum_cons))
        G.append(Group(f"d{i}a", [dc0], [dc0], [dcb0], [(dc1, 0)]))
        if i == 2:  # d1 (the dec1 block output) is not pruned
            G.append(Group("d2", [dc1], [dc1], [dcb1],
                           [(_c("pred2.conv0"), 0), (_t("upconv1.convt"), 0)]))
    g = {x.name: x for x in G}
    # The bridge: concat(dec_sum, crop(enc)) -> dec{i}.conv0; the encoder's
    # channels sit after d{i}sum's original width.
    for i in (4, 3, 2, 1):
        g[f"d{i}sum"].consumers.append((_c(f"dec{i}.conv0"), 0))
        g[f"e{i}"].consumers.append((_c(f"dec{i}.conv0"), f"d{i}sum"))
    return G


# ----------------------------------------------------------------- keeping

def _sq_norms(w: torch.Tensor, axis: int) -> np.ndarray:
    a = w.detach().cpu().double().numpy()
    return (np.moveaxis(a, axis, -1) ** 2).reshape(-1, a.shape[axis]).sum(axis=0)


def l2_keep_indices(weight: torch.Tensor, amount: float, round_to: int = 1,
                    axis: int = 0) -> np.ndarray:
    """Indices of the output channels (``axis``) that L2-structured pruning
    keeps, in order: drop the ``round(amount * cout)`` lowest-norm channels
    (torch ln_structured rounding, reference prune.py:251-253); ``round_to``
    rounds the kept count up to a multiple. Norms in float64, ties broken
    by a stable sort."""
    cout = weight.shape[axis]
    keep_n = cout - int(round(amount * cout))
    if round_to > 1:
        keep_n = min(cout, -(-keep_n // round_to) * round_to)
    k = cout - keep_n
    if k <= 0:
        return np.arange(cout)
    norms = np.sqrt(_sq_norms(weight, axis))
    drop = set(np.argsort(norms, kind="stable")[:k].tolist())
    return np.asarray([i for i in range(cout) if i not in drop], np.int64)


def _group_keep(norms: np.ndarray, amount: float, round_to: int, quarter: bool) -> np.ndarray:
    c = norms.shape[0]
    k = c - int(round(amount * c))
    if round_to > 1:
        k = min(c, -(-k // round_to) * round_to)
    if quarter:
        k = min(c, -(-k // 4) * 4)  # equal keeps per shift quarter
        q, kq = c // 4, k // 4
        keep = []
        for j in range(4):
            order = np.argsort(norms[j * q:(j + 1) * q], kind="stable")
            dropped = set(order[:q - kq].tolist())
            keep.extend(j * q + i for i in range(q) if i not in dropped)
        return np.asarray(keep, np.int64)
    order = np.argsort(norms, kind="stable")
    dropped = set(order[:c - k].tolist())
    return np.asarray([i for i in range(c) if i not in dropped], np.int64)


def _weight(sd: StateDict, path: Path) -> torch.Tensor:
    return sd[f"{path[0]}.weight"]


def _width(sd: StateDict, path: Path) -> int:
    return int(_weight(sd, path).shape[OUT_AXIS[path[1]]])


def keep_sets(state_dict: StateDict, groups: Sequence[Group], amount: float,
              round_to: int) -> Dict[str, np.ndarray]:
    """One keep-set per group, ranked by the summed squared L2 of the
    group's ``rank`` producers."""
    keeps = {}
    for g in groups:
        sq = sum(_sq_norms(_weight(state_dict, p), OUT_AXIS[p[1]]) for p in g.rank)
        keeps[g.name] = _group_keep(np.sqrt(sq), amount, round_to, g.quarter)
    return keeps


def eelunet_keep_sets(state_dict: StateDict, amount: float,
                      round_to: int = 64) -> Dict[str, np.ndarray]:
    """The EELUnet's keep-sets; the masked finetune and the physical slice
    both use them, so their channel sets match exactly."""
    return keep_sets(state_dict, eelunet_groups(), amount, round_to)


def _vec_along(vec: torch.Tensor, t: torch.Tensor, axis: int) -> torch.Tensor:
    shape = [1] * t.dim()
    shape[axis] = -1
    return vec.to(device=t.device, dtype=t.dtype).view(shape).expand(t.shape).clone()


def eelunet_prune_masks(state_dict: StateDict, amount: float, round_to: int = 64):
    """0/1 masks of the group keep-sets: the producers' weights (output
    axis) and biases, and the attached BNs' weight and bias, so that every
    pruned channel outputs exactly 0 through BN, ReLU and the gates, the
    precondition for slicing. Returns (masks keyed by ``state_dict`` names,
    keep-sets)."""
    keeps = eelunet_keep_sets(state_dict, amount, round_to)
    masks: Dict[str, torch.Tensor] = {}
    for g in eelunet_groups():
        vec = torch.zeros(_width(state_dict, g.rank[0]), dtype=torch.float32)
        vec[torch.as_tensor(keeps[g.name])] = 1.0
        for name, kind in g.producers:
            w = state_dict[f"{name}.weight"]
            masks[f"{name}.weight"] = _vec_along(vec, w, OUT_AXIS[kind])
            masks[f"{name}.bias"] = _vec_along(vec, state_dict[f"{name}.bias"], 0)
        for bn in g.bns:
            for suf in ("weight", "bias"):
                masks[f"{bn}.{suf}"] = _vec_along(vec, state_dict[f"{bn}.{suf}"], 0)
    return masks, keeps


def slice_state_dict(state_dict: StateDict, groups: Sequence[Group],
                     keeps: Dict[str, np.ndarray]) -> StateDict:
    """The state dict with every group's channels outside its keep-set
    removed: producers on their output axis (with biases), BNs (affine and
    statistics), then each consumer on its input axis, gathering the kept
    indices of every group that feeds it at that group's offset."""
    sd = dict(state_dict)
    idx = {k: torch.as_tensor(v, dtype=torch.long) for k, v in keeps.items()}
    width = {g.name: _width(state_dict, g.rank[0]) for g in groups}

    def take(key, axis, ix):
        sd[key] = sd[key].index_select(axis, ix.to(sd[key].device)).contiguous()

    for g in groups:
        for name, kind in g.producers:
            take(f"{name}.weight", OUT_AXIS[kind], idx[g.name])
            take(f"{name}.bias", 0, idx[g.name])
        for bn in g.bns:
            for suf in ("weight", "bias", "running_mean", "running_var"):
                take(f"{bn}.{suf}", 0, idx[g.name])
    parts: Dict[Path, List[Tuple[int, torch.Tensor]]] = {}
    for g in groups:
        for path, offset in g.consumers:
            off = width[offset] if isinstance(offset, str) else int(offset)
            parts.setdefault(path, []).append((off, idx[g.name] + off))
    for (name, kind), ps in parts.items():
        take(f"{name}.weight", IN_AXIS[kind],
             torch.cat([ix for _, ix in sorted(ps, key=lambda t: t[0])]))
    return sd


def physical_prune_unet(state_dict: StateDict, amount: float,
                        round_to: int = 1) -> Tuple[StateDict, Dict[str, Any]]:
    """Slice the lowest-L2 ``amount`` fraction of channels out of every
    prunable conv of a U-Net ``state_dict`` (``l2_keep_indices`` per
    producer). Returns (slim state dict, ``Unet`` widths). Pass the same
    ``round_to`` to ``compute_prune_masks`` so the masked finetune's channel
    sets match."""
    groups = unet_groups()
    keeps = {g.name: l2_keep_indices(_weight(state_dict, g.rank[0]), amount, round_to,
                                     OUT_AXIS[g.rank[0][1]]) for g in groups}
    return slice_state_dict(state_dict, groups, keeps), unet_widths(keeps)


def physical_prune_eelunet(state_dict: StateDict, amount: float,
                           round_to: int = 64) -> Tuple[StateDict, Dict[str, int]]:
    """Slice an EELUnet ``state_dict`` (parameters and BN statistics) along
    the group keep-sets. Returns (slim state dict, widths for
    ``EELUnet(widths=...)``)."""
    keeps = eelunet_keep_sets(state_dict, amount, round_to)
    slim = slice_state_dict(state_dict, eelunet_groups(), keeps)
    return slim, {name: int(len(k)) for name, k in keeps.items()}


# -------------------------------------------------------------- slim models

UNET_WIDTHS = ("enc_widths", "bottleneck_widths", "up_widths", "dec_widths")


def unet_kwargs(widths: Dict[str, Any]) -> Dict[str, Any]:
    """The ``Unet`` keywords of a U-Net widths dict (lists from JSON
    become tuples)."""
    if not isinstance(widths, dict) or set(widths) != set(UNET_WIDTHS):
        raise ValueError(f"U-Net widths are a dict of {UNET_WIDTHS}, got {widths!r}")

    def t2(pairs):
        return tuple(tuple(int(x) for x in pair) for pair in pairs)

    return dict(enc_widths=t2(widths["enc_widths"]),
                bottleneck_widths=tuple(int(x) for x in widths["bottleneck_widths"]),
                up_widths=tuple(int(x) for x in widths["up_widths"]),
                dec_widths=t2(widths["dec_widths"]))


def slim_unet(widths: Dict[str, Any], out_channels: int = 1, in_channels: int = 3,
              device=None, dtype=None):
    """A ``Unet`` with ``physical_prune_unet``'s widths."""
    from eelunet_tpu_torch.models.unet import Unet

    return Unet(in_channels, out_channels, **unet_kwargs(widths), device=device, dtype=dtype)


def slim_eelunet(widths: Dict[str, int], out_channels: int = 1, mask_range: int = 20,
                 highpass_impl: str = "auto", in_channels: int = 3, device=None, dtype=None):
    """An ``EELUnet`` with ``physical_prune_eelunet``'s widths."""
    from eelunet_tpu_torch.models.eelunet import EELUnet

    return EELUnet(in_channels, out_channels, mask_range,
                   widths=tuple(sorted((str(k), int(v)) for k, v in widths.items())),
                   highpass_impl=highpass_impl, device=device, dtype=dtype)


def param_count(model: torch.nn.Module) -> int:
    """Parameters of ``model`` (BN statistics are buffers, not counted)."""
    return sum(p.numel() for p in model.parameters())


# ------------------------------------------------------------- checkpoints

def _jsonable(widths):
    if isinstance(widths, dict):
        return {k: _jsonable(v) for k, v in widths.items()}
    if isinstance(widths, (list, tuple)):
        return [_jsonable(v) for v in widths]
    return int(widths)


def save_slim(path: str, state_dict: StateDict, widths: Dict[str, Any],
              model_name: str = "unet") -> str:
    """Write a slim checkpoint: ``model.pt`` (the slim model's unfolded
    ``state_dict``, parameters and BN statistics) and the JAX package's
    ``widths.json`` sidecar, ``{"model": name, "widths": ...}``."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _WEIGHTS + ".tmp")
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
    os.replace(tmp, os.path.join(path, _WEIGHTS))
    with open(os.path.join(path, _SIDECAR), "w") as f:
        json.dump({"model": model_name, "widths": _jsonable(widths)}, f, indent=2)
    return path


def is_slim_checkpoint(path: str) -> bool:
    """Slim checkpoints carry a ``widths.json`` sidecar: the CLIs and the
    Predictor detect physically pruned models behind ``--checkpoint`` by it."""
    return bool(path) and os.path.isfile(os.path.join(path, _SIDECAR))


def read_widths(path: str) -> Tuple[str, Any]:
    """(model name, widths) of a slim checkpoint; a sidecar without
    ``"model"`` is the legacy flat U-Net form."""
    with open(os.path.join(path, _SIDECAR)) as f:
        sidecar = json.load(f)
    if "model" not in sidecar:
        sidecar = {"model": "unet", "widths": sidecar}
    return sidecar["model"], sidecar["widths"]


def read_slim(path: str) -> Tuple[str, Any, StateDict]:
    """(model name, widths, state_dict) of a slim checkpoint, on the CPU."""
    name, widths = read_widths(path)
    sd = torch.load(os.path.join(path, _WEIGHTS), map_location="cpu", weights_only=True)
    return name, widths, sd


def load_slim(path: str, model_cfg=None):
    """The slim model of a checkpoint with its weights loaded (float32, CPU,
    unfolded), built by ``registry.create_model`` from the sidecar's family
    and widths; ``model_cfg`` gives the rest of the configuration (None =
    that family's defaults)."""
    from eelunet_tpu_torch.config import ModelConfig
    from eelunet_tpu_torch.registry import create_model

    name, widths, sd = read_slim(path)
    cfg = dataclasses.replace(model_cfg or ModelConfig(), name=name, slim_init="")
    model, _ = create_model(cfg, widths=widths)
    model.load_state_dict(sd, strict=True)
    return model
