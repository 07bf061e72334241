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
- Data parallelism (``Trainer(mesh=...)`` under a process group, one rank
  per card, ``parallel/``): the model trains wrapped in
  ``DistributedDataParallel`` with global-batch BN statistics, so that a
  step over the ranks' rows is the JAX package's step over the global batch
  (``DataParallel``); losses and metric counts are reduced over the ranks.

Unlike the JAX Trainer, which pins its train steps to the XLA low-rank
high-pass after a TPU measurement, the port's train step runs whatever
``model.highpass_impl`` says: "auto" launches the four CUDA high-pass
kernels on a CUDA tensor (``ops/fft_cuda.HighPassFunction``), "lowrank" is
the plain reference.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import json
import os
import time
from contextlib import nullcontext
from datetime import datetime
from functools import partial
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from eelunet_tpu_torch import losses as L
from eelunet_tpu_torch import metrics as M
from eelunet_tpu_torch.data.augment import make_input_preprocess, random_flip_batch
from eelunet_tpu_torch.data.pipeline import prefetch_to_device, process_rows
from eelunet_tpu_torch.nn.layers import init_weights, nchw, nhwc, sync_batch_norms
from eelunet_tpu_torch.parallel.distributed import (
    all_reduce_sum_,
    data_group,
    is_primary,
    process_count,
    process_index,
)
from eelunet_tpu_torch.parallel.mesh import NOT_PORTED_AXES, create_mesh, spatial_size
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
    the port does not have yet: the ``model`` and ``spatial`` mesh axes
    (``ROADMAP.md``)."""
    if cfg.mesh.model_axis > 1 or cfg.mesh.spatial_axis > 1:
        raise NotImplementedError(NOT_PORTED_AXES)


def choose_batch_placement(local_rows: int, height: int, n_data: int,
                           n_sp: int, process_count: int,
                           loader_sharded: bool) -> str:
    """The JAX Trainer's placement of one host-side batch
    (``eelunet_tpu/train/trainer.py:51-78``): "full" (rows over 'data', H
    over 'spatial'), "rows" (rows only: H does not divide the spatial axis)
    or "replicate". A tail batch that does not divide the data axis is
    replicated (eval loaders drop no sample); a process-sharded batch never
    is (each process holds different rows), which is an error.

    The port calls it with ``process_count`` 1 for a loader that is not
    process-sharded: each rank then holds the whole global batch, as one
    JAX process over the whole mesh would."""
    global_rows = local_rows * (process_count if loader_sharded else 1)
    rows_ok = global_rows % n_data == 0 and (loader_sharded or process_count == 1)
    if rows_ok and height % n_sp == 0:
        return "full"
    if rows_ok:
        return "rows"
    if loader_sharded and process_count > 1:
        raise ValueError(
            f"process-sharded batch of {local_rows} local rows "
            f"({global_rows} global) does not divide the data axis "
            f"({n_data}) and cannot be replicated across processes"
        )
    return "replicate"


class DataParallel:
    """This rank's part in a data-parallel train step over every rank of the
    process group, one device each.

    - ``wrap``: the model in ``DistributedDataParallel`` (gradients averaged
      over the ranks), its batch norms on global-batch statistics
      (``nn/layers.sync_batch_norms``), so their running statistics are
      equal on every rank. No family leaves a
      parameter without a gradient in its train forward
      (``tests/test_torch_port_ddp.py``), so unused parameters are not
      searched for.
    - ``rows``: where this rank's rows sit in the global batch
      (``data/pipeline.process_rows``), for the step-keyed flips."""

    def __init__(self, device: torch.device):
        self.rank, self.world = process_index(), process_count()
        self.group = data_group()
        self.device = device
        self._ddp = None

    def wrap(self, model: torch.nn.Module):
        if self._ddp is None or self._ddp.module is not model:
            from torch.nn.parallel import DistributedDataParallel

            sync_batch_norms(model, self.group)
            ids = [self.device.index] if self.device.type == "cuda" else None
            self._ddp = DistributedDataParallel(model, device_ids=ids, process_group=self.group)
        return self._ddp

    def rows(self, local_batch: int, accum_steps: int) -> np.ndarray:
        return process_rows(self.rank, self.world, local_batch * self.world, accum_steps)


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
                    skip_nonfinite: bool = False, grad_clip_norm: float = 0.0,
                    dp: Optional[DataParallel] = None):
    """The train step: ``step(state, images, labels) -> (loss, ok)`` on
    preprocessed NHWC batches on the device; it updates ``state`` in place.

    ``accum_steps`` splits the batch into micro-batches run one after the
    other; the gradient and the loss are their means, and BN statistics
    update per micro-batch. ``skip_nonfinite``: a non-finite loss or
    gradient reverts the update (parameters, moments, BN statistics, EMA,
    and the schedule's count, which the JAX package keeps in the optimizer
    state) and still advances ``state.step``; it reads one flag back to the
    host per step. ``ok`` is False for a skipped step.

    ``dp``: the step of one rank of a data-parallel run. ``images`` are its
    rows of the global batch (``DataLoader(process_shard=...)``), the
    forward runs through DDP, the flips are the global batch's draw at this
    rank's rows, only the last micro-batch's backward reduces the gradients
    (``no_sync`` before it), and the guard's verdict comes from the loss
    summed over the ranks and the reduced gradients, so every rank skips
    alike. The returned loss is this rank's."""

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        model = state.model
        model.train()
        fwd = dp.wrap(model) if dp is not None else model
        b = images.shape[0]
        if random_flip:
            gen = flip_generator(state.seed, state.step)
            if dp is None:
                images, labels = random_flip_batch(gen, images, labels)
            else:
                images, labels = random_flip_batch(gen, images, labels,
                                                   rows=dp.rows(b, accum_steps),
                                                   total=b * dp.world)
        if b % accum_steps:
            raise ValueError(f"batch {b} not divisible by accum_steps {accum_steps}")
        mb = b // accum_steps
        buffers = _bn_buffers(model)
        before = [t.clone() for t in buffers] if skip_nonfinite else None
        state.optimizer.zero_grad(set_to_none=True)
        total = torch.zeros((), device=images.device)
        for i in range(accum_steps):
            sl = slice(i * mb, (i + 1) * mb)
            reduce = dp is None or i == accum_steps - 1
            with nullcontext() if reduce else fwd.no_sync():
                loss = forward_loss(fwd, loss_fn, images[sl], labels[sl], amp_dtype, remat)
                # The recompute of a remat forward updates the BN statistics
                # a second time: keep those of the first forward.
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
            finite = torch.isfinite(loss if dp is None else all_reduce_sum_(loss.clone()))
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
    ``widths``: the EELUnet's channel widths (None = reference widths).

    ``mesh`` (None: ``cfg.mesh``'s): its ``data`` axis spans the processes,
    one device each: 1 in a single process, every rank under a process
    group (``parallel/distributed.init_distributed``), where the train step
    is data-parallel (``DataParallel``), evaluation shards each batch whose
    rows divide the ranks (``choose_batch_placement``) and reduces the
    metric counts, and only the primary logs and writes."""

    def __init__(self, cfg, device=None, widths=None, mesh=None):
        check_supported(cfg)
        if cfg.data.add_canny_edge and cfg.model.in_channels == 3:
            # The edge map is a 4th input channel (AddCannyEdge.py:8-41).
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, in_channels=4))
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.mesh = mesh if mesh is not None else create_mesh(
            cfg.mesh.data_axis, cfg.mesh.model_axis, cfg.mesh.spatial_axis,
            devices=None if process_count() > 1 else [self.device])
        n_data = self.mesh.shape["data"]
        if n_data != process_count():
            raise ValueError(
                f"the Trainer's data axis spans processes, one device each: a mesh of "
                f"{self.mesh.shape} needs {n_data} processes (torchrun --nproc_per_node), "
                f"this run has {process_count()}")
        self.dp = DataParallel(self.device) if n_data > 1 else None
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
                    grad_clip_norm=cfg.optimizer.grad_clip_norm, dp=self.dp)
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
        """(images, labels) on the device, preprocessed: this rank's rows of
        each batch (``_placed_batches``)."""
        return ((images, labels) for images, labels, _ in self._placed_batches(loader))

    def _placed_batches(self, loader: Iterable):
        """(images, labels, share) on the device, preprocessed: this rank's
        rows of each batch, and the share of the batch's samples whose
        results it counts in the sum over the ranks. A process-sharded
        loader (train) yields a rank's rows already. An unsharded one (val,
        test) yields the whole batch to every rank, which keeps its 1/world
        of the rows where they divide the ranks, and otherwise runs the
        batch whole; only the primary counts it then (share 1, 0 elsewhere)."""
        sharded = getattr(loader, "process_shard", None) is not None
        world, rank = process_count(), process_index()
        shares = collections.deque()

        def place(batch):
            images, labels = batch
            choice = choose_batch_placement(images.shape[0], images.shape[1],
                                            self.mesh.shape["data"], spatial_size(self.mesh),
                                            world if sharded else 1, sharded)
            if choice == "replicate":
                shares.append(1.0 if rank == 0 else 0.0)
                return images, labels
            shares.append(1.0 / world)
            if sharded or world == 1:
                return images, labels
            k = images.shape[0] // world
            return images[rank * k:(rank + 1) * k], labels[rank * k:(rank + 1) * k]

        for images, labels in prefetch_to_device(map(place, loader), self.device,
                                                 self.cfg.data.prefetch_depth):
            yield (*self._preprocess(images, labels), shares.popleft())

    def train_one_epoch(self, state: TrainState, loader) -> Tuple[TrainState, float]:
        """One pass over ``loader``: (state, mean loss over the applied
        steps). Skipped steps are counted in ``last_skipped_steps``. With
        ``profile_steps > 0`` the steps [1, 1 + profile_steps) of the first
        epoch are traced into ``log_dir/<model>/profile`` (step 0 warms up)."""
        step = self._get_step("train")
        total = torch.zeros((), device=self.device)
        n = applied = 0
        want_prof = self.cfg.profile_steps if not self._profiled and is_primary() else 0
        prof = None
        try:
            for i, (images, labels, share) in enumerate(self._placed_batches(loader)):
                if want_prof and i == 1:
                    prof = start_trace(os.path.join(self.cfg.log_dir, self.cfg.model.name,
                                                    "profile"))
                loss, ok = step(state, images, labels)
                if ok:
                    total = total + loss * share
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
        return state, float(all_reduce_sum_(total)) / max(applied, 1)

    def val_one_epoch(self, state: TrainState, loader) -> float:
        """The mean over batches of each batch's loss (a per-sample mean, so
        the shares of the ranks' losses sum to it)."""
        step = self._get_step("eval_loss")
        total = torch.zeros((), device=self.device)
        n = 0
        for images, labels, share in self._placed_batches(loader):
            total = total + step(state, images, labels) * share
            n += 1
        return float(all_reduce_sum_(total)) / max(n, 1)

    def evaluate(self, state: TrainState, loader, return_accum: bool = False):
        """Full metric evaluation (reference evaluate.py:62-124).
        ``return_accum=True`` also returns the summed accumulator
        (``MetricAccum`` or ``MetricAccumMC``), for the per-class table."""
        step = self._get_step("eval")
        acc = None
        for images, labels, share in self._placed_batches(loader):
            batch_acc = step(state, images, labels)
            if share == 0.0:  # a replicated batch, counted on the primary
                batch_acc = type(batch_acc)(*(torch.zeros_like(t) for t in batch_acc))
            acc = batch_acc if acc is None else acc + batch_acc
        if acc is not None and self.dp is not None:
            flat = all_reduce_sum_(torch.cat([t.reshape(-1).float() for t in acc]))
            parts = flat.split([t.numel() for t in acc])
            acc = type(acc)(*(p.view(t.shape).to(t.dtype) for p, t in zip(parts, acc)))
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
        primary = is_primary()  # only the primary logs, prints and writes files
        if not primary:
            log = lambda *a, **k: None  # noqa: E731
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
        logger = MetricLogger(run_dir) if primary else None
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
            if logger is not None:
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
            if primary:
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
        if logger is not None:
            logger.close()
        return state, history
