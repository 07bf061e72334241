"""Model registry and uniform output contract (counterpart of
``eelunet_tpu/registry.py:16-168``): the seven families of the JAX package,
each an ``nn.Module`` whose forward takes NCHW and returns a ``ModelOutput``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch


class ModelOutput(NamedTuple):
    """Uniform forward-pass result.

    seg: (B,C,H,W) float32 segmentation map: probabilities if the model
         applies a final sigmoid (eelunet, egeunet, malunet), logits
         otherwise (unet, unet++, unext, unext_s); ``ModelMeta.seg_is_logits``
         records which.
    aux: deep-supervision maps, low->high resolution (empty for plain models).
    """

    seg: torch.Tensor
    aux: Tuple[torch.Tensor, ...] = ()


class ModelMeta(NamedTuple):
    name: str
    seg_is_logits: bool
    has_aux: bool
    reference: str           # file:line citation into the upstream repo


MODEL_REGISTRY: Dict[str, ModelMeta] = {
    "unet": ModelMeta("unet", True, False, "models/Unet.py:4-98"),
    "eelunet": ModelMeta("eelunet", False, True, "models/EELUnet.py:228-471"),
    "unet++": ModelMeta("unet++", True, False, "models/UnetPlusPlus.py:6-82 (repaired)"),
    "egeunet": ModelMeta("egeunet", False, True, "models/egeunet.py:217-391"),
    "unext": ModelMeta("unext", True, False, "models/unext.py:191-325"),
    "unext_s": ModelMeta("unext_s", True, False, "models/unext.py:328-462"),
    "malunet": ModelMeta("malunet", False, False, "models/malunet.py:198-324"),
}

# Families of the JAX package that the port does not have yet: none.
NOT_PORTED: Tuple[str, ...] = ()

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_dtype(model_cfg) -> torch.dtype:
    if model_cfg.dtype not in DTYPES:
        raise ValueError(f"unknown model dtype {model_cfg.dtype!r} (choices: {sorted(DTYPES)})")
    return DTYPES[model_cfg.dtype]


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on: None means "cuda". A CUDA
    device without a card raises; nothing falls back to the CPU unless the
    caller names it (``--device cpu``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card. Pass "
            "device='cpu' (--device cpu on the CLIs) to run on the CPU.")
    return dev


def create_model(model_cfg, bn_folded: bool = False, device=None, dtype=None,
                 widths=None) -> Tuple[Any, ModelMeta]:
    """Instantiate an ``nn.Module`` + metadata from a ModelConfig. The
    parameters are made in ``dtype`` (default float32) on ``device``; a model
    that serves in ``model_cfg.dtype`` is cast after its weights are loaded.
    Every family takes ``model_cfg.in_channels`` (4 with
    ``data.add_canny_edge``). ``bn_folded``: built without the BNs that
    ``bnfold.fold_bn_eval`` folds (eelunet, unext, unext_s; a no-op for the
    others). ``widths``: the channel widths of a narrow or physically pruned
    model (None = reference): the EELUnet's per-group widths, or the U-Net's
    ``enc_widths``/``bottleneck_widths``/``up_widths``/``dec_widths`` dict.
    ``model_cfg.slim_init`` (a ``cli.prune --physical`` output) builds the
    slim module from its ``widths.json``, as the JAX registry does."""
    name = model_cfg.name
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported to eelunet_tpu_torch yet; see ROADMAP.md")
    if name not in MODEL_REGISTRY:
        raise ValueError(f"Unsupported model type: {name!r} (choices: {sorted(MODEL_REGISTRY)})")
    slim_init = getattr(model_cfg, "slim_init", "")
    if slim_init:
        from eelunet_tpu_torch.prune_physical import SLIM_MODELS, read_widths

        if name not in SLIM_MODELS:
            raise ValueError(f"slim_init supports unet/eelunet, not {name!r}")
        _, widths = read_widths(slim_init)
    if widths is not None and name not in ("eelunet", "unet"):
        raise ValueError(f"widths= is the EELUnet's or the U-Net's; {name!r} takes none")
    kw = dict(in_channels=model_cfg.in_channels, device=device, dtype=dtype)
    if name == "eelunet":
        from eelunet_tpu_torch.models.eelunet import EELUnet

        if isinstance(widths, dict):
            widths = tuple(sorted((str(k), int(v)) for k, v in widths.items()))
        model = EELUnet(out_channels=model_cfg.out_channels, mask_range=model_cfg.fft_mask_range,
                        highpass_impl=getattr(model_cfg, "highpass_impl", "auto"),
                        widths=widths, bn_folded=bn_folded, **kw)
    elif name == "unet":
        from eelunet_tpu_torch.models.unet import Unet
        from eelunet_tpu_torch.prune_physical import unet_kwargs

        model = Unet(out_channels=model_cfg.out_channels,
                     **(unet_kwargs(widths) if widths else {}), **kw)
    elif name == "unet++":
        from eelunet_tpu_torch.models.unetpp import UnetPlusPlus

        model = UnetPlusPlus(out_channels=model_cfg.out_channels, **kw)
    elif name == "egeunet":
        from eelunet_tpu_torch.models.egeunet import EGEUNet

        model = EGEUNet(num_classes=model_cfg.out_channels, c_list=tuple(model_cfg.c_list),
                        bridge=model_cfg.bridge, gt_ds=model_cfg.gt_ds, **kw)
    elif name == "malunet":
        from eelunet_tpu_torch.models.malunet import MALUNet

        model = MALUNet(num_classes=model_cfg.out_channels, c_list=tuple(model_cfg.c_list),
                        split_att=model_cfg.split_att, bridge=model_cfg.bridge, **kw)
    else:  # unext / unext_s
        from eelunet_tpu_torch.models.unext import UNext, UNextS

        cls = UNext if name == "unext" else UNextS
        model = cls(num_classes=model_cfg.out_channels, bn_folded=bn_folded, **kw)
    return model, MODEL_REGISTRY[name]


def seg_probabilities(output: ModelOutput, meta: ModelMeta) -> torch.Tensor:
    """Segmentation probabilities regardless of the model's output
    convention: single-channel logits get a sigmoid, multi-channel logits a
    softmax over the class axis (dim 1); models with the activation built in
    return ``seg`` as it is."""
    if not meta.seg_is_logits:
        return output.seg
    if output.seg.shape[1] > 1:
        return torch.softmax(output.seg, dim=1)
    return torch.sigmoid(output.seg)


def predict_probabilities(fwd: Callable, images: torch.Tensor, tta: bool = False) -> torch.Tensor:
    """Single entry point for probability prediction with optional flip TTA.
    ``fwd``: (B,H,W,C) NHWC images -> (B,H,W,C') probabilities."""
    return tta_probabilities(fwd, images) if tta else fwd(images)


def tta_probabilities(fwd: Callable, images: torch.Tensor) -> torch.Tensor:
    """Flip test-time augmentation: the mean probability over the 4 H/W flip
    orientations, each prediction flipped back (NHWC; dims 1/2 are H/W)."""
    p = fwd(images)
    p = p + torch.flip(fwd(torch.flip(images, (1,))), (1,))
    p = p + torch.flip(fwd(torch.flip(images, (2,))), (2,))
    p = p + torch.flip(fwd(torch.flip(images, (1, 2))), (1, 2))
    return p / 4.0
