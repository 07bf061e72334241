"""L2-structured channel pruning (counterpart of ``eelunet_tpu/prune.py``).

The flow of ``cli.prune``: load pretrained -> evaluate -> per-conv
L2-structured masks (torch ``prune.ln_structured(amount, n=2, dim=0)``:
zero the ``amount`` fraction of output channels with the smallest L2 norms,
per conv) -> sparsity report -> evaluate -> masked finetune at lr/10 ->
evaluate -> comparison table.

Masks are 0/1 tensors keyed by the model's ``state_dict`` names, multiplied
into the parameters in place; the finetune multiplies them in again after
every optimizer step (torch's pruning keeps them with forward pre-hooks).

The masks cover what the JAX package's ``_is_conv_kernel`` selects there,
every rank-4 flax ``kernel``: the weights of every ``nn.Conv1d``,
``nn.Conv2d`` and ``nn.ConvTranspose2d`` (flax keeps 1-d convs as rank-4
(k, 1, I, O) kernels, and transposed ones under ``kernel`` too), except the
two ``Conv1d`` of MALUNet's external attention, which are plain (C, 4C)
matmul parameters there (``EAblock.MATMULS``). The output-channel axis is 0
for convs and 1 for transposed convs, whose weights are (I, O, kh, kw).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
from torch import nn

Masks = Dict[str, torch.Tensor]
_CONVS = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d)


def matmul_convs(model: nn.Module) -> set:
    """Names of the ``Conv1d`` modules that stand for plain matmul
    parameters in the JAX package (``EAblock.MATMULS`` of each module that
    has them)."""
    out = set()
    for name, m in model.named_modules():
        for child in getattr(m, "MATMULS", ()):
            out.add(f"{name}.{child}" if name else child)
    return out


def conv_modules(model: nn.Module) -> Dict[str, nn.Module]:
    """The conv modules whose weights the JAX package prunes, by name."""
    skip = matmul_convs(model)
    return {n: m for n, m in model.named_modules() if isinstance(m, _CONVS) and n not in skip}


def cout_axis(module: nn.Module) -> int:
    """The output-channel axis of a conv's weight: 1 for a transposed conv
    (I, O, kh, kw), else 0."""
    return 1 if isinstance(module, nn.ConvTranspose2d) else 0


def channel_norms(w: torch.Tensor, axis: int, dtype=torch.float32) -> torch.Tensor:
    """L2 norm of each output channel of ``w`` (``axis``), summed in ``dtype``."""
    dims = tuple(d for d in range(w.dim()) if d != axis)
    return torch.sqrt(torch.sum(w.detach().to(dtype) ** 2, dim=dims))


def _broadcast(keep: torch.Tensor, w: torch.Tensor, axis: int) -> torch.Tensor:
    shape = [1] * w.dim()
    shape[axis] = -1
    return keep.view(shape).expand(w.shape).clone()


def compute_prune_masks(model: nn.Module, amount: float, zero_bias: bool = False,
                        round_to: int = 1) -> Tuple[Masks, Dict[str, float]]:
    """Per-conv masks zeroing the lowest-L2 ``amount`` fraction of output
    channels: (masks, per-layer pruned fraction). Every conv weight gets a
    mask (all ones where nothing is dropped); the report names the convs
    that drop channels.

    ``zero_bias=False`` is torch ``ln_structured`` exactly (weights only: a
    pruned channel still emits its bias). ``zero_bias=True`` masks the bias
    too, so the channel's output is exactly zero, the precondition for
    physical removal (``prune_physical.py``). ``round_to`` rounds the kept
    count up to a multiple. Norms are summed in float32 and ties keep the
    lower index first (a stable sort), as ``jnp.argsort`` orders them."""
    masks: Masks = {}
    report: Dict[str, float] = {}
    for name, m in conv_modules(model).items():
        w = m.weight
        axis = cout_axis(m)
        cout = w.shape[axis]
        k = int(round(amount * cout))  # torch ln_structured rounds
        if round_to > 1:
            keep_n = min(cout, -(-(cout - k) // round_to) * round_to)
            k = cout - keep_n
        if k <= 0:
            masks[f"{name}.weight"] = torch.ones_like(w, requires_grad=False)
            continue
        order = torch.argsort(channel_norms(w, axis), stable=True)
        keep = torch.ones(cout, dtype=w.dtype, device=w.device)
        keep[order[:k]] = 0
        masks[f"{name}.weight"] = _broadcast(keep, w.detach(), axis)
        if zero_bias and m.bias is not None:
            masks[f"{name}.bias"] = keep.clone()
        report[f"{name}.weight"] = float(k) / cout
    return masks, report


@torch.no_grad()
def apply_masks(model: nn.Module, masks: Masks) -> nn.Module:
    """Multiply each masked tensor of ``model`` by its mask, in place."""
    params = dict(model.named_parameters())
    for name, mask in masks.items():
        p = params[name]
        p.mul_(mask.to(device=p.device, dtype=p.dtype))
    return model


@torch.no_grad()
def sparsity_report(model: nn.Module) -> Dict[str, float]:
    """Fraction of exactly-zero weights per conv (reference prune.py:256-259)."""
    return {f"{n}.weight": int((m.weight == 0).sum()) / m.weight.numel()
            for n, m in conv_modules(model).items()}


@torch.no_grad()
def global_sparsity(model: nn.Module) -> float:
    """Fraction of exactly-zero elements over every parameter."""
    zeros = sum(int((p == 0).sum()) for p in model.parameters())
    total = sum(p.numel() for p in model.parameters())
    return zeros / max(total, 1)


def finetune_pruned(trainer, state, masks: Masks, train_loader, val_loader, epochs: int = 5,
                    log: Callable = print):
    """Masked finetune at lr/10 (reference prune.py:276-278): a new
    optimizer and schedule over the masked parameters, and the masks
    multiplied in again after every update, under ``no_grad`` after
    ``optimizer.step()``. The Adam moments of masked channels are not
    masked, as in the JAX package: the re-mask zeroes what they move.
    ``trainer`` gives the config, the train step, the device batches and
    the val loss (``train/trainer.Trainer``). Returns ``state``, updated in
    place."""
    from eelunet_tpu_torch.train.state import build_optimizer

    cfg = trainer.cfg.optimizer
    cfg10 = dataclasses.replace(cfg, lr=cfg.lr / 10.0)
    device = next(state.model.parameters()).device
    dev_masks = {k: v.to(device) for k, v in masks.items()}  # moved once
    apply_masks(state.model, dev_masks)
    state.optimizer, state.scheduler = build_optimizer(
        cfg10, state.model.parameters(), max(len(train_loader), 1))
    step = trainer._get_step("train")
    for epoch in range(epochs):
        total = torch.zeros((), device=device)
        n = 0
        for images, labels in trainer._device_batches(train_loader):
            loss, _ok = step(state, images, labels)
            apply_masks(state.model, dev_masks)  # like torch's pruning forward hooks
            total = total + loss.detach()
            n += 1
        val_loss = trainer.val_one_epoch(state, val_loader)
        log(f"[finetune {epoch + 1}/{epochs}] train={float(total) / max(n, 1):.4f} "
            f"val={val_loss:.4f}")
    return state
