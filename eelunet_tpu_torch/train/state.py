"""Train state and optimizer (counterpart of ``eelunet_tpu/train/state.py``).

``TrainState`` holds everything a resumed run needs: the model (parameters
and BN buffers), the optimizer (Adam moments), the LR scheduler, the step
count, the seed that keys the per-step flips, and the EMA of the parameters.

``build_optimizer`` is the reference's Adam(lr, weight_decay=1e-5) + StepLR
(train.py:312,315). Torch's ``Adam(weight_decay=w)`` adds w*p to the gradient
before the moments (coupled L2), which is exactly the JAX package's
``add_decayed_weights`` followed by ``scale_by_adam``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
from torch.optim.lr_scheduler import LambdaLR


def step_lr_factor(step_size_epochs: int, gamma: float, steps_per_epoch: int) -> Callable:
    """StepLR(step_size, gamma) as a factor of the base LR, stepped per
    optimizer step on the epoch boundary: epoch = step // steps_per_epoch."""
    spe = max(steps_per_epoch, 1)
    return lambda count: gamma ** ((count // spe) // step_size_epochs)


def cosine_lr_factor(decay_steps: int) -> Callable:
    """``optax.cosine_decay_schedule(lr, decay_steps)`` as a factor."""
    d = max(decay_steps, 1)
    return lambda count: 0.5 * (1.0 + math.cos(math.pi * min(count, d) / d))


def build_optimizer(cfg, params: Iterable[torch.nn.Parameter],
                    steps_per_epoch: int) -> Tuple[torch.optim.Optimizer, LambdaLR]:
    """(optimizer, scheduler) for an OptimizerConfig. The scheduler is a
    ``LambdaLR`` stepped once per optimizer step, so the LR of update n is
    lr * factor(n), as the optax schedule gives it."""
    if cfg.lr_schedule == "step":
        factor = step_lr_factor(cfg.lr_step_size, cfg.lr_gamma, steps_per_epoch)
    elif cfg.lr_schedule == "constant":
        factor = lambda count: 1.0  # noqa: E731
    elif cfg.lr_schedule == "cosine":
        factor = cosine_lr_factor(cfg.lr_step_size * steps_per_epoch)
    else:
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    params = list(params)
    if cfg.name == "adam":
        opt = torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=cfg.weight_decay)
    elif cfg.name == "sgd":  # optax.trace(decay=0.9) after the decay
        opt = torch.optim.SGD(params, lr=cfg.lr, momentum=0.9, weight_decay=cfg.weight_decay)
    else:
        raise ValueError(f"unknown optimizer {cfg.name!r}")
    return opt, LambdaLR(opt, factor)


@torch.no_grad()
def clip_by_global_norm(params: Iterable[torch.nn.Parameter], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm``: when the global L2 norm of the
    gradients reaches ``max_norm``, scale them by max_norm / norm. Runs on
    the raw gradients, before the optimizer adds the weight decay. Returns
    the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


class TrainState:
    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 scheduler: LambdaLR, seed: int, ema_decay: float = 0.0):
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.seed = int(seed)
        self.step = 0
        self.ema_decay = float(ema_decay)
        # Exponential moving average of the parameters (optimizer.ema_decay
        # > 0), None when off.
        self.ema: Optional[Dict[str, torch.Tensor]] = (
            {n: p.detach().clone() for n, p in model.named_parameters()}
            if self.ema_decay > 0 else None)

    @torch.no_grad()
    def update_ema(self) -> None:
        """ema = d * ema + (1 - d) * params, after each applied update."""
        if self.ema is None:
            return
        d = self.ema_decay
        for n, p in self.model.named_parameters():
            e = self.ema[n]
            e.copy_(d * e + (1.0 - d) * p)

    def ema_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state_dict with the parameters replaced by the EMA
        (BN buffers are the live ones)."""
        sd = dict(self.model.state_dict())
        sd.update(self.ema)
        return sd

    def state_dict(self) -> Dict:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "step": self.step,
            "seed": self.seed,
            "ema": self.ema,
        }

    def load_state_dict(self, sd: Dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.scheduler.load_state_dict(sd["scheduler"])
        self.step = int(sd["step"])
        self.seed = int(sd["seed"])
        if self.ema is not None:
            src = sd.get("ema") or {n: p for n, p in self.model.named_parameters()}
            self.ema = {n: src[n].detach().clone().to(p.device)
                        for n, p in self.model.named_parameters()}
