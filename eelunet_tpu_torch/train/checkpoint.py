"""Checkpoints of the train state (counterpart of
``eelunet_tpu/train/checkpoint.py``), in a torch-native format.

Two tiers, with the JAX package's names under ``save_dir/<name>/``:

- full snapshots, ``<name>_epoch_N/`` and ``<name>_last/``: ``state.pt``
  (model parameters and BN buffers, optimizer, scheduler, step, seed, EMA)
  and the ``framework_meta.json`` epoch record the JAX package writes; exact
  resume reads them (``resume_from=auto`` takes the newest);
- weights-only tags, ``<name>_best_{iou,dice,miou,mdice,boundary_f1}.npz``,
  ``<name>_best.npz`` (min val loss) and ``<name>_ema.npz``: upstream-layout
  state dicts of the family (``models/convert.to_upstream_state_dict``), so
  ``python -m eelunet_tpu_torch.cli.serve --model_type <name> --checkpoint
  <tag>.npz`` serves a tag as it is. Tags written in the same epoch are hard links of one file.

Each file is written under a temporary name and renamed into place. With
``async_writes=True`` (``TrainConfig.async_checkpoint``, on by default),
saves called with ``background=True`` (``Trainer.fit``'s per-epoch tags and
snapshots) copy the tensors they write before they return, on the tensors'
device, and one worker thread moves the copies to the host and writes the
files, in submission order, while training goes on. The copy is what makes
this safe: ``optimizer.step()`` and the BN updates change the live tensors
in place. A failed write is raised again on the next submit or ``wait()``.
Direct calls stay synchronous, so their files can be read when they return.

Under a process group (data parallelism) every rank holds the same state and
calls the same saves; only the primary writes, as in the JAX package
(``eelunet_tpu/train/checkpoint.py:231-288, 386-388``). ``wait()`` and each
synchronous save end in a barrier, so that no rank reads a snapshot, a tag
or ``best_meta.json`` before it is on disk; ``restore`` reads on every rank,
onto its own device.
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from eelunet_tpu_torch.models.convert import to_upstream_state_dict
from eelunet_tpu_torch.parallel.distributed import barrier, is_primary

BEST_METRICS = ("iou", "dice", "miou", "mdice", "boundary_f1")

# The JAX package's sidecar marker: format 2 = concat-ordered EELUnet bridge.
FORMAT_META = {"format": 2, "eelunet_bridge": "concat"}
_META_FILE = "framework_meta.json"
_STATE_FILE = "state.pt"


def write_format_meta(path: str, ema: bool = False, epoch: Optional[int] = None) -> None:
    meta = dict(FORMAT_META)
    if ema:
        meta["ema"] = True
    if epoch is not None:
        meta["epoch"] = int(epoch)  # completed epochs at save time (exact resume)
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(meta, f)


def read_meta(path: str) -> Dict[str, Any]:
    try:
        with open(os.path.join(path, _META_FILE)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def is_full_snapshot(path: str) -> bool:
    return os.path.isfile(os.path.join(path, _STATE_FILE))


class _AsyncWriter:
    """One daemon worker that drains checkpoint writes in submission order.
    A failed write is re-raised on the next ``submit()`` or ``wait()``, and
    the writes queued after it are skipped (a later write may depend on the
    failed one's directory)."""

    def __init__(self):
        self._q: "queue.Queue[Callable[[], None]]" = queue.Queue()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="eelunet-ckpt-writer")
        self._thread.start()

    def _run(self):
        while True:
            fn = self._q.get()
            try:
                if self._exc is None:
                    fn()
            except BaseException as e:  # raised at the next submit() or wait()
                self._exc = e
            finally:
                self._q.task_done()

    def _reraise(self):
        if self._exc is not None:
            e, self._exc = self._exc, None
            raise RuntimeError("async checkpoint write failed") from e

    def submit(self, fn: Callable[[], None]) -> None:
        self._reraise()
        self._q.put(fn)

    def wait(self) -> None:
        self._q.join()
        self._reraise()


def _map_tensors(fn, tree):
    """``tree`` (nested dicts, lists and tuples) with ``fn`` applied to each
    tensor; the containers are new, the other leaves (numbers, None) kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


class _Snapshot:
    """The tensors of a save, cloned now on their devices (on a card, on the
    current stream); ``host()`` (on the writer thread) waits for the clones,
    then copies them to the host."""

    def __init__(self, tree):
        self._tree = _map_tensors(lambda t: t.detach().clone(), tree)
        self._event = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            self._event = torch.cuda.Event()
            self._event.record()

    def host(self):
        if self._event is not None:
            self._event.synchronize()
        return _map_tensors(lambda t: t.cpu(), self._tree)


class CheckpointManager:
    def __init__(self, save_dir: str, model_name: str, async_writes: bool = False):
        self.root = os.path.abspath(os.path.join(save_dir, model_name))
        os.makedirs(self.root, exist_ok=True)
        self.model_name = model_name
        self.primary = is_primary()  # the rank that writes
        # Every rank takes the same path through each save (so that their
        # barriers pair up); only the primary has a writer.
        self._background = async_writes
        self._async = _AsyncWriter() if async_writes and self.primary else None

    def wait(self) -> None:
        """Block until every pending background write has landed (a no-op
        when writes are synchronous); re-raises the first failed one. Under
        a process group every rank waits for the primary's writes."""
        if self._async is not None:
            self._async.wait()
        barrier()

    def run_after_saves(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` after every pending write (at once when synchronous):
        for a sidecar file that must not land before its checkpoint. Only
        the primary runs it."""
        if not self.primary:
            return
        if self._async is not None:
            self._async.submit(fn)
        else:
            fn()

    def _run(self, work: Callable[[], None], background: bool) -> None:
        if background and self._background:
            if self._async is not None:
                self._async.submit(work)
        else:
            self.wait()  # keep the order of any earlier background writes
            if self.primary:
                work()
            barrier()

    def tag_path(self, tag: str) -> str:
        return os.path.join(self.root, f"{self.model_name}_{tag}")

    def save(self, tag: str, state, epoch: Optional[int] = None,
             background: bool = False) -> str:
        """Full snapshot of ``state`` (a TrainState) under ``<name>_<tag>/``.
        ``background=True`` copies the state now and writes it on the
        worker."""
        return self.save_to(self.tag_path(tag), state, epoch, background)

    def save_to(self, path: str, state, epoch: Optional[int] = None,
                background: bool = False) -> str:
        """Full snapshot of ``state`` in the directory ``path``."""
        ema = state.ema is not None
        enqueue = background and self._async is not None
        snap = _Snapshot(state.state_dict()) if enqueue else None  # primary only

        def work():
            os.makedirs(path, exist_ok=True)
            tmp = os.path.join(path, _STATE_FILE + ".tmp")
            torch.save(snap.host() if enqueue else state.state_dict(), tmp)
            os.replace(tmp, os.path.join(path, _STATE_FILE))
            write_format_meta(path, ema=ema, epoch=epoch)

        self._run(work, background)
        return path

    def save_weights_tags(self, tags, state_dict: Dict[str, torch.Tensor],
                          background: bool = False) -> List[str]:
        """Write ``state_dict`` (the port's, unfolded) once as an
        upstream-layout ``.npz`` per tag; the tags after the first are hard
        links of the first file. ``background=True`` copies the tensors now
        and converts and writes them on the worker."""
        paths = [self.tag_path(t) + ".npz" for t in tags]
        if not paths:
            return []
        enqueue = background and self._async is not None
        snap = _Snapshot(state_dict) if enqueue else None

        def work():
            arrays = to_upstream_state_dict(snap.host() if enqueue else state_dict,
                                            self.model_name)
            for i, path in enumerate(paths):
                tmp = path + ".tmp"
                if i == 0:
                    with open(tmp, "wb") as f:
                        np.savez(f, **arrays)
                else:
                    if os.path.exists(tmp):
                        os.remove(tmp)
                    os.link(paths[0], tmp)
                os.replace(tmp, path)

        self._run(work, background)
        return paths

    def restore(self, path: str, state) -> Any:
        """Load a full snapshot into ``state`` (a TrainState) in place."""
        self.wait()  # never read under a pending write
        if not is_full_snapshot(path):
            raise ValueError(
                f"{path} is not a full snapshot (no {_STATE_FILE}): weights-only tags "
                "carry no optimizer state to resume from; resume from "
                f"{self.model_name}_epoch_N or {self.model_name}_last")
        device = next(state.model.parameters()).device
        sd = torch.load(os.path.join(path, _STATE_FILE), map_location=device,
                        weights_only=True)
        if state.ema is not None and sd.get("ema") is None:
            import warnings

            warnings.warn(f"{path} predates optimizer.ema_decay: initializing the EMA "
                          "from the restored params", stacklevel=2)
        state.load_state_dict(sd)
        return state

    def prune_snapshots(self, keep: int, background: bool = False) -> List[str]:
        """Delete all but the newest ``keep`` ``<name>_epoch_N`` snapshots
        (0 keeps all). Best tags and ``last`` are never pruned. With
        ``background=True`` the sweep queues behind the pending saves and
        returns no paths."""
        if keep <= 0:
            return []
        if background and self._background:
            if self._async is not None:
                self._async.submit(lambda: self._prune_snapshots(keep))
            return []
        self.wait()
        doomed = self._prune_snapshots(keep) if self.primary else []
        barrier()
        return doomed

    def _prune_snapshots(self, keep: int) -> List[str]:
        pat = re.compile(re.escape(self.model_name) + r"_epoch_(\d+)$")
        snaps = sorted((int(m.group(1)), os.path.join(self.root, d))
                       for d in os.listdir(self.root)
                       if (m := pat.match(d)) and os.path.isdir(os.path.join(self.root, d)))
        doomed = [p for _, p in snaps[:-keep]]
        for p in doomed:
            shutil.rmtree(p)
        return doomed

    def latest_path(self) -> Optional[str]:
        """The most recently written full snapshot (``resume_from=auto``)."""
        self.wait()
        candidates = [p for d in os.listdir(self.root)
                      if d.startswith(f"{self.model_name}_")
                      and is_full_snapshot(p := os.path.join(self.root, d))]
        return max(candidates, key=lambda p: os.path.getmtime(os.path.join(p, _STATE_FILE))) \
            if candidates else None


class BestTracker:
    """Best-per-metric tracking with the reference's save policy. Its marks
    round-trip through ``best_meta.json`` so a resumed run keeps the
    uninterrupted run's high-water marks."""

    def __init__(self):
        self.best = {m: 0.0 for m in BEST_METRICS}
        self.min_val_loss = float("inf")

    def save(self, root: str) -> None:
        with open(os.path.join(root, "best_meta.json"), "w") as f:
            json.dump({"best": self.best, "min_val_loss": self.min_val_loss}, f)

    def load(self, root: str) -> bool:
        try:
            with open(os.path.join(root, "best_meta.json")) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return False
        self.best.update({m: float(v) for m, v in meta.get("best", {}).items()
                          if m in self.best})
        self.min_val_loss = float(meta.get("min_val_loss", float("inf")))
        return True

    def update(self, metrics: Dict[str, float], val_loss: float) -> List[str]:
        """The checkpoint tags to save this epoch."""
        tags = []
        for m in BEST_METRICS:
            if metrics.get(m, 0.0) > self.best[m]:
                self.best[m] = float(metrics[m])
                tags.append(f"best_{m}")
        if val_loss < self.min_val_loss:
            self.min_val_loss = float(val_loss)
            tags.append("best")
        return tags
