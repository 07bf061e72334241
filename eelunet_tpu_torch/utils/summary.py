"""Model summary (counterpart of ``eelunet_tpu/utils/summary.py``; the
reference's startup ``torchsummary.summary``, train.py:291): a per-layer
table of output shapes and parameter counts.

The table comes from forward hooks on a copy of the model on the ``meta``
device, so no forward runs on the card and no weight is copied, as JAX's
``tabulate`` runs none.
"""

from __future__ import annotations

import copy
from typing import List, Tuple

import torch


def param_count(model: torch.nn.Module) -> int:
    """The number of parameters (buffers such as BN statistics excluded, as
    the JAX package counts ``params`` only)."""
    return sum(p.numel() for p in model.parameters())


def _on_meta(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``model`` whose parameters and buffers are meta tensors of
    the same shapes, dtypes and ``requires_grad``; the weights are not read."""
    memo = {}
    for p in model.parameters():
        memo[id(p)] = torch.nn.Parameter(torch.empty_like(p, device="meta"),
                                         requires_grad=p.requires_grad)
    for b in model.buffers():
        memo[id(b)] = torch.empty_like(b, device="meta")
    return copy.deepcopy(model, memo)


def _shapes(out) -> str:
    if isinstance(out, torch.Tensor):
        return str(tuple(out.shape))
    if isinstance(out, (tuple, list)):
        return "[" + ", ".join(_shapes(o) for o in out) + "]"
    return type(out).__name__


def model_summary(model: torch.nn.Module, input_shape=(1, 3, 256, 256), depth: int = 2) -> str:
    """The table of every call of a module down to ``depth`` levels (1 =
    the model's children) in call order: its path, class, output shapes
    and parameter count; the total parameter count last. ``input_shape``
    is NCHW, float32."""
    meta = _on_meta(model).eval()
    rows: List[Tuple[str, str, str, str]] = []
    hooks = []
    for name, mod in meta.named_modules():
        if name and name.count(".") < depth:
            n_params = param_count(mod)

            def hook(mod, _args, out, name=name, n_params=n_params):
                rows.append((name, type(mod).__name__, _shapes(out), f"{n_params:,}"))

            hooks.append(mod.register_forward_hook(hook))
    try:
        with torch.no_grad():
            out = meta(torch.zeros(input_shape, device="meta"))
    finally:
        for h in hooks:
            h.remove()
    rows.insert(0, ("(input)", type(meta).__name__, str(tuple(input_shape)), ""))
    rows.append(("(output)", type(meta).__name__, _shapes(out), f"{param_count(meta):,}"))
    head = ("path", "module", "outputs", "params")
    widths = [max(len(r[i]) for r in rows + [head]) for i in range(4)]
    line = lambda r: "  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()  # noqa: E731
    sep = "  ".join("-" * w for w in widths)
    return "\n".join([line(head), sep] + [line(r) for r in rows]
                     + [sep, f"Total params: {param_count(meta):,}"])
