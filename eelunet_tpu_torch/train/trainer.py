"""Training and evaluation (counterpart of ``eelunet_tpu/train/trainer.py``).

- ``make_train_step``: forward under bf16 autocast (``model.dtype``) on
  float32 parameters, the loss in float32, backward, Adam, LR schedule and
  EMA, with the step-keyed flips, ``remat``, ``accum_steps`` and the
  non-finite guard of the JAX step. Losses stay on the device and are read
  once per epoch.
- ``make_eval_loss_step`` and ``make_eval_step``: the val loss and the
  summable metric counts, in eval mode.
- ``Trainer``: the epoch loop with history, best tags, snapshots, ``last``,
  the ``ema`` tag and exact resume.

Unlike the JAX Trainer, which pins its train steps to the XLA low-rank
high-pass after a TPU measurement, the port's train step runs whatever
``model.highpass_impl`` says: "auto" launches the four CUDA high-pass
kernels on a CUDA tensor (``ops/fft_cuda.HighPassFunction``), "lowrank" is
the plain reference.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import time
from datetime import datetime
from functools import partial
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from eelunet_tpu_torch import losses as L
from eelunet_tpu_torch import metrics as M
from eelunet_tpu_torch.data.augment import make_input_preprocess, random_flip_batch
from eelunet_tpu_torch.data.pipeline import prefetch_to_device
from eelunet_tpu_torch.nn.layers import init_weights, nchw, nhwc
from eelunet_tpu_torch.registry import (
    ModelOutput,
    create_model,
    model_dtype,
    predict_probabilities,
    resolve_device,
    seg_probabilities,
)
from eelunet_tpu_torch.train.checkpoint import BestTracker, CheckpointManager, read_meta
from eelunet_tpu_torch.train.state import TrainState, build_optimizer, clip_by_global_norm
from eelunet_tpu_torch.utils.profiling import start_trace, stop_trace


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for the options of the JAX Trainer that
    the port does not have yet (``ROADMAP.md``)."""
    todo = []
    if cfg.mesh.data_axis not in (-1, 1) or cfg.mesh.model_axis > 1 or cfg.mesh.spatial_axis > 1:
        todo.append("multi-GPU meshes (mesh.*_axis > 1)")
    if todo:
        raise NotImplementedError("not ported to eelunet_tpu_torch yet: " + "; ".join(todo)
                                  + "; see ROADMAP.md")


# Options of the JAX Trainer that the port accepts and does not act on
# (ROADMAP.md), with what the port does instead. ``fit`` names the ones that
# are set in one line at its start.
IGNORED_OPTIONS = {
    "donate_buffers": "the eager step donates no buffers",
    "compile_cache": "nothing is compiled ahead, so there is no cache",
}


def ignored_options(cfg) -> str:
    """The line naming each option of ``IGNORED_OPTIONS`` that ``cfg`` sets,
    or "" when none is set."""
    names = [f"{k} ({why})" for k, why in IGNORED_OPTIONS.items() if getattr(cfg, k)]
    return "ignored by eelunet_tpu_torch: " + "; ".join(names) if names else ""


def make_loss_fn(loss_name: str, loss_cfg, meta) -> Callable:
    """(ModelOutput in NCHW, NHWC labels) -> float32 loss."""
    base = L.LOSS_REGISTRY[loss_name]

    def fn(output: ModelOutput, labels: torch.Tensor) -> torch.Tensor:
        probs = nhwc(seg_probabilities(output, meta))
        return base(tuple(nhwc(a) for a in output.aux), probs, labels, loss_cfg)

    return fn


def flip_generator(seed: int, step: int) -> torch.Generator:
    """The flips' generator for one step: a function of (seed, step) only,
    so a resumed run draws what the uninterrupted run drew."""
    key = int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1)[0])
    return torch.Generator().manual_seed(key)


def _bn_buffers(model: torch.nn.Module) -> List[torch.Tensor]:
    return [b for name, b in model.named_buffers()
            if name.endswith(("running_mean", "running_var", "num_batches_tracked"))]


def forward_loss(model, loss_fn, images, labels, amp_dtype=None, remat: bool = False):
    """Forward on NHWC ``images`` (autocast to ``amp_dtype`` when given) and
    the float32 loss against NHWC ``labels``. With ``remat`` the forward is
    recomputed in the backward (``torch.utils.checkpoint``)."""
    x = nchw(images)
    with torch.autocast(x.device.type, dtype=amp_dtype or torch.float32,
                        enabled=amp_dtype is not None):
        output = checkpoint(model, x, use_reentrant=False) if remat else model(x)
    return loss_fn(output, labels)


def make_train_step(loss_fn: Callable, amp_dtype=None, remat: bool = False,
                    accum_steps: int = 1, random_flip: bool = False,
                    skip_nonfinite: bool = False, grad_clip_norm: float = 0.0):
    """The train step: ``step(state, images, labels) -> (loss, ok)`` on
    preprocessed NHWC batches on the device; it updates ``state`` in place.

    ``accum_steps`` splits the batch into micro-batches run one after the
    other; the gradient and the loss are their means, and BN statistics
    update per micro-batch. ``skip_nonfinite``: a non-finite loss or
    gradient reverts the update (parameters, moments, BN statistics, EMA,
    and the schedule's count, which the JAX package keeps in the optimizer
    state) and still advances ``state.step``; it reads one flag back to the
    host per step. ``ok`` is False for a skipped step."""

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        model = state.model
        model.train()
        if random_flip:
            images, labels = random_flip_batch(flip_generator(state.seed, state.step),
                                               images, labels)
        b = images.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} not divisible by accum_steps {accum_steps}")
        mb = b // accum_steps
        buffers = _bn_buffers(model)
        before = [t.clone() for t in buffers] if skip_nonfinite else None
        state.optimizer.zero_grad(set_to_none=True)
        total = torch.zeros((), device=images.device)
        for i in range(accum_steps):
            sl = slice(i * mb, (i + 1) * mb)
            loss = forward_loss(model, loss_fn, images[sl], labels[sl], amp_dtype, remat)
            # The recompute of a remat forward updates the BN statistics a
            # second time: keep those of the first forward.
            after_fwd = [t.clone() for t in buffers] if remat else None
            loss.backward()
            if remat:
                for t, v in zip(buffers, after_fwd):
                    t.copy_(v)
            total = total + loss.detach()
        loss = total / accum_steps
        params = [p for p in model.parameters() if p.grad is not None]
        if accum_steps > 1:
            for p in params:
                p.grad.div_(accum_steps)
        ok = True
        if skip_nonfinite:
            finite = torch.isfinite(loss)
            for p in params:
                finite = finite & torch.isfinite(p.grad).all()
            ok = bool(finite)
            if not ok:
                with torch.no_grad():
                    for t, v in zip(buffers, before):
                        t.copy_(v)
        if ok:
            if grad_clip_norm > 0:
                clip_by_global_norm(params, grad_clip_norm)
            state.optimizer.step()
            state.scheduler.step()
            state.update_ema()
        state.step += 1
        return loss, ok

    return step


def make_eval_loss_step(loss_fn: Callable, amp_dtype=None):
    @torch.no_grad()
    def eval_loss_step(state: TrainState, images, labels):
        state.model.eval()
        return forward_loss(state.model, loss_fn, images, labels, amp_dtype)

    return eval_loss_step


def make_eval_step(meta, threshold: float = 0.5, tta: bool = False, amp_dtype=None):
    """The metric counts of one batch: ``MetricAccum`` for a binary model,
    and for a multi-class one (C > 1 probability channels) the argmax's
    ``MetricAccumMC``."""

    @torch.no_grad()
    def eval_step(state: TrainState, images, labels):
        model = state.model
        model.eval()

        def fwd(x):
            with torch.autocast(x.device.type, dtype=amp_dtype or torch.float32,
                                enabled=amp_dtype is not None):
                return nhwc(seg_probabilities(model(nchw(x)), meta)).float()

        probs = predict_probabilities(fwd, images, tta=tta)
        if probs.shape[-1] > 1:
            return M.update_metrics_multiclass(probs, labels)
        return M.update_metrics(probs, labels, threshold)

    return eval_step


class Trainer:
    """End-to-end training loop (reference train() train.py:87-214).

    ``device``: None = "cuda" (raises without a card); "cpu" only when asked.
    ``widths``: the EELUnet's channel widths (None = reference widths)."""

    def __init__(self, cfg, device=None, widths=None):
        check_supported(cfg)
        if cfg.data.add_canny_edge and cfg.model.in_channels == 3:
            # The edge map is a 4th input channel (AddCannyEdge.py:8-41).
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, in_channels=4))
        self.cfg = cfg
        self.device = resolve_device(device)
        self._preprocess = make_input_preprocess(cfg.data, cfg.model.out_channels)
        self.model, self.meta = create_model(cfg.model, widths=widths)
        self.amp_dtype = None if model_dtype(cfg.model) == torch.float32 else model_dtype(cfg.model)
        self.loss_name = L.resolve_loss_name(cfg.loss.name, cfg.model.name,
                                             cfg.model.out_channels)
        self.loss_fn = make_loss_fn(self.loss_name, cfg.loss, self.meta)
        self.ckpt = CheckpointManager(cfg.save_dir, cfg.model.name,
                                      async_writes=cfg.async_checkpoint)
        self._profiled = False
        self.best = BestTracker()
        self.last_skipped_steps = 0
        self._steps: Dict[str, Callable] = {}

    # -- state ---------------------------------------------------------------
    def init_state(self, steps_per_epoch: int = 1) -> TrainState:
        """Seeded PyTorch default init (on the CPU, from a generator), moved
        to the device in channels_last; fresh optimizer and schedule. With
        ``model.slim_init`` the slim module (``create_model``) takes the
        slim checkpoint's weights and BN statistics; the optimizer moments
        start fresh, like the reference's weights-only finetune
        (prune.py:276-278)."""
        cfg = self.cfg
        self.seed = cfg.seed if cfg.seed is not None else int(np.random.randint(0, 10000))
        init_weights(self.model, torch.Generator().manual_seed(self.seed))
        if cfg.model.slim_init:
            from eelunet_tpu_torch.prune_physical import read_slim

            self.model.load_state_dict(read_slim(cfg.model.slim_init)[2], strict=True)
        self.model.to(self.device, memory_format=torch.channels_last)
        opt, sched = build_optimizer(cfg.optimizer, self.model.parameters(), steps_per_epoch)
        return TrainState(self.model, opt, sched, self.seed, cfg.optimizer.ema_decay)

    def _get_step(self, name: str) -> Callable:
        if name not in self._steps:
            cfg = self.cfg
            if name == "train":
                fn = make_train_step(
                    self.loss_fn, self.amp_dtype, cfg.remat, cfg.accum_steps,
                    random_flip=cfg.data.random_flip,
                    skip_nonfinite=cfg.skip_nonfinite_updates,
                    grad_clip_norm=cfg.optimizer.grad_clip_norm)
            elif name == "eval_loss":
                fn = make_eval_loss_step(self.loss_fn, self.amp_dtype)
            elif name == "eval":
                fn = make_eval_step(self.meta, cfg.threshold, cfg.tta, self.amp_dtype)
            else:
                raise KeyError(name)
            self._steps[name] = fn
        return self._steps[name]

    # -- loops ---------------------------------------------------------------
    def _device_batches(self, loader: Iterable):
        for images, labels in prefetch_to_device(loader, self.device,
                                                 self.cfg.data.prefetch_depth):
            yield self._preprocess(images, labels)

    def train_one_epoch(self, state: TrainState, loader) -> Tuple[TrainState, float]:
        """One pass over ``loader``: (state, mean loss over the applied
        steps). Skipped steps are counted in ``last_skipped_steps``. With
        ``profile_steps > 0`` the steps [1, 1 + profile_steps) of the first
        epoch are traced into ``log_dir/<model>/profile`` (step 0 warms up)."""
        step = self._get_step("train")
        total = torch.zeros((), device=self.device)
        n = applied = 0
        want_prof = self.cfg.profile_steps if not self._profiled else 0
        prof = None
        try:
            for i, (images, labels) in enumerate(self._device_batches(loader)):
                if want_prof and i == 1:
                    prof = start_trace(os.path.join(self.cfg.log_dir, self.cfg.model.name,
                                                    "profile"))
                loss, ok = step(state, images, labels)
                if ok:
                    total = total + loss
                    applied += 1
                n += 1
                if prof is not None and i >= want_prof:
                    stop_trace(prof)
                    prof, self._profiled = None, True
        finally:
            if prof is not None:  # the epoch ended inside the window, or a step raised
                stop_trace(prof)
                self._profiled = True
        self.last_skipped_steps = n - applied
        return state, float(total) / max(applied, 1)

    def val_one_epoch(self, state: TrainState, loader) -> float:
        step = self._get_step("eval_loss")
        total = torch.zeros((), device=self.device)
        n = 0
        for images, labels in self._device_batches(loader):
            total = total + step(state, images, labels)
            n += 1
        return float(total) / max(n, 1)

    def evaluate(self, state: TrainState, loader, return_accum: bool = False):
        """Full metric evaluation (reference evaluate.py:62-124).
        ``return_accum=True`` also returns the summed accumulator
        (``MetricAccum`` or ``MetricAccumMC``), for the per-class table."""
        step = self._get_step("eval")
        acc = None
        for images, labels in self._device_batches(loader):
            batch_acc = step(state, images, labels)
            acc = batch_acc if acc is None else acc + batch_acc
        if acc is None:
            out = {k: 0.0 for k in M.METRIC_NAMES}
        else:
            final = (M.finalize_metrics_multiclass(acc) if isinstance(acc, M.MetricAccumMC)
                     else M.finalize_metrics(acc))
            out = {k: float(v) for k, v in final.items()}
        return (out, acc) if return_accum else out

    def fit(self, train_loader, val_loader, test_loader, state: Optional[TrainState] = None,
            log=print) -> Tuple[TrainState, Dict[str, Any]]:
        cfg = self.cfg
        if ignored_options(cfg):
            log(ignored_options(cfg))
        steps_per_epoch = max(len(train_loader), 1)
        if state is None:
            state = self.init_state(steps_per_epoch)
        start_epoch = 0
        if cfg.resume_from:
            target = self.ckpt.latest_path() if cfg.resume_from == "auto" else cfg.resume_from
            if target:
                self.ckpt.restore(target, state)
                meta_epoch = read_meta(target).get("epoch")
                done = int(meta_epoch) if meta_epoch is not None else state.step // steps_per_epoch
                start_epoch = min(done, cfg.epochs)
                self.best.load(self.ckpt.root)
                log(f"Resumed full train state from {target} at step {state.step} — "
                    f"continuing at epoch {start_epoch + 1}/{cfg.epochs}"
                    if start_epoch < cfg.epochs else
                    f"Resumed {target} at step {state.step}: already trained {start_epoch} "
                    f"epochs, target epochs={cfg.epochs} reached — nothing to do")
            else:
                log("resume_from=auto: no checkpoint found, starting fresh")

        from eelunet_tpu_torch.train.logging import MetricLogger

        run_dir = os.path.join(cfg.log_dir, cfg.model.name,
                               datetime.now().strftime("%Y%m%d_%H%M%S"))
        logger = MetricLogger(run_dir)
        history = {"train_loss": [], "val_loss": [], "metrics": []}
        json_path = os.path.join(self.ckpt.root, "loss_history.json")
        if start_epoch > 0 and os.path.exists(json_path):
            try:  # continue the interrupted run's history, cut to its epochs
                with open(json_path) as f:
                    prev = json.load(f)
                history = {k: list(prev.get(k, []))[:start_epoch] for k in history}
            except (OSError, ValueError):
                pass

        bg = cfg.async_checkpoint
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.time()
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)  # the batch order of epoch `epoch`
            state, train_loss = self.train_one_epoch(state, train_loader)
            if self.last_skipped_steps:
                log(f"WARNING: epoch {epoch + 1}: skipped {self.last_skipped_steps} "
                    "non-finite update(s) (skip_nonfinite_updates guard)")
            val_loss = self.val_one_epoch(state, val_loader)
            metrics = (self.evaluate(state, test_loader)
                       if (epoch + 1) % cfg.eval_every == 0 else {})
            history["train_loss"].append(train_loss)
            history["val_loss"].append(val_loss)
            history["metrics"].append(metrics)
            logger.log_epoch(epoch + 1, train_loss, val_loss, metrics)

            # With async_checkpoint the tensors are copied here and written
            # by the checkpoint worker while the next epoch runs.
            self.ckpt.save_weights_tags(self.best.update(metrics, val_loss),
                                        state.model.state_dict(), background=bg)
            if (epoch + 1) % cfg.snapshot_every == 0:
                self.ckpt.save(f"epoch_{epoch + 1}", state, epoch=epoch + 1, background=bg)
                self.ckpt.prune_snapshots(cfg.keep_snapshots, background=bg)
            log(f"Epoch [{epoch + 1}/{cfg.epochs}]\tTrain Loss: {train_loss:.4f}\t"
                f"Val Loss: {val_loss:.4f}\t"
                + "".join(f"{k}: {metrics[k]:.4f}\t"
                          for k in ("iou", "dice", "miou", "mdice", "boundary_f1")
                          if k in metrics)
                + f"({time.time() - t0:.1f}s)")
            with open(json_path, "w") as f:
                json.dump(history, f, indent=2)
            # best_meta.json must not land before its best tags (a resume
            # would then skip a tag that was never written): it queues
            # behind them, on a copy, since self.best changes next epoch.
            self.ckpt.run_after_saves(partial(copy.deepcopy(self.best).save, self.ckpt.root))

        if cfg.epochs > start_epoch and cfg.epochs % cfg.snapshot_every != 0:
            # The final full snapshot, unless the last epoch wrote epoch_N.
            self.ckpt.save("last", state, epoch=cfg.epochs, background=bg)
        if cfg.epochs > start_epoch and state.ema is not None:
            self.ckpt.save_weights_tags(["ema"], state.ema_state_dict(), background=bg)
        # Every file is on disk when fit returns; a failed background write
        # is raised here.
        self.ckpt.wait()
        log("Training complete. Best: "
            + " ".join(f"{k}={v:.4f}" for k, v in self.best.best.items()))
        logger.close()
        return state, history
