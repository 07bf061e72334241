"""Threaded host input pipeline with prefetch to the device (counterpart of
``eelunet_tpu/data/pipeline.py``).

- ``DataLoader`` decodes samples in a thread pool and stacks them into NHWC
  numpy batches of static shape (``drop_remainder``); its shuffle is keyed
  by ``seed + epoch`` (``set_epoch``), so a resumed run replays the batch
  order of an uninterrupted one exactly. With ``process_shard`` it yields
  one rank's rows of every global batch (``process_rows``).
- ``prefetch_to_device`` keeps ``depth`` batches in flight: on a CUDA device
  each batch is copied into pinned host memory and uploaded with
  ``non_blocking=True``, so the copy overlaps the previous step's compute.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np
import torch


def process_rows(pid: int, pc: int, batch_size: int, accum_steps: int = 1) -> np.ndarray:
    """The rows of a global batch of ``batch_size`` that rank ``pid`` of
    ``pc`` holds, in its local order.

    With ``accum_steps`` = 1 these are JAX's contiguous process slice, rows
    [pid B/pc, (pid+1) B/pc). With gradient accumulation, JAX's micro-batch
    i is global rows [i mb, (i+1) mb) (``images.reshape(accum_steps, mb,
    ...)``), and its batch statistics are those rows'. So each rank holds
    its share of every micro-batch, in micro-batch order: its local
    micro-batch i is its B/(pc accum_steps) rows of JAX's micro-batch i."""
    if batch_size % (pc * accum_steps):
        raise ValueError(f"batch_size {batch_size} not divisible by {pc} processes x "
                         f"accum_steps {accum_steps}")
    mb, k = batch_size // accum_steps, batch_size // (pc * accum_steps)
    return np.concatenate([np.arange(i * mb + pid * k, i * mb + (pid + 1) * k)
                           for i in range(accum_steps)])


class DataLoader:
    """Minimal batched loader over an indexable dataset of (image, mask) pairs.

    ``process_shard=(pid, pc)``: yield only rank ``pid``'s rows of every
    global batch (``process_rows``, with ``accum_steps``). Every rank draws
    the same ``seed + epoch`` order, so the slices are disjoint and cover
    each batch. It needs ``drop_remainder`` (equal slices on every rank)
    and a batch that divides among the ranks, as in the JAX package."""

    def __init__(
        self,
        dataset,
        batch_size: int = 8,
        shuffle: bool = False,
        seed: int = 0,
        drop_remainder: bool = True,
        num_workers: int = 4,
        indices: Optional[np.ndarray] = None,
        process_shard: Optional[Tuple[int, int]] = None,
        accum_steps: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.num_workers = max(1, num_workers)
        self.indices = np.asarray(indices if indices is not None else np.arange(len(dataset)))
        self._epoch = 0
        self._rows = None
        if process_shard is not None:
            pid, pc = process_shard
            if not (0 <= pid < pc):
                raise ValueError(f"process_shard index {pid} out of range for {pc}")
            if pc > 1:
                if not drop_remainder:
                    raise ValueError("process_shard requires drop_remainder=True")
                if batch_size % pc:
                    raise ValueError(f"batch_size {batch_size} not divisible by {pc} processes")
                self._rows = process_rows(pid, pc, batch_size, accum_steps)
            else:
                process_shard = None
        self.process_shard = process_shard

    def __len__(self) -> int:
        n = len(self.indices)
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle key of the NEXT pass to ``epoch`` (exact resume)."""
        self._epoch = int(epoch)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = self.indices
        if self.shuffle:
            order = np.random.default_rng(self.seed + self._epoch).permutation(order)
        self._epoch += 1
        nb = len(self)
        if nb == 0:
            return
        bs = self.batch_size
        if self._rows is not None:  # only this rank's rows are decoded
            order = np.concatenate([order[b * bs + self._rows] for b in range(nb)])
            bs = len(self._rows)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            futures = [pool.submit(self.dataset.__getitem__, int(i))
                       for i in order[: nb * bs if self.drop_remainder else None]]
            for b in range(nb):
                samples = [f.result() for f in futures[b * bs:(b + 1) * bs]]
                yield (np.stack([s[0] for s in samples]), np.stack([s[1] for s in samples]))


def to_device(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):  # already on the device (data/device_cache.py)
        return a.to(device)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def prefetch_to_device(iterator, device, depth: int = 2):
    """Yield the batches of ``iterator`` as tensors on ``device``, with up to
    ``depth`` uploads in flight ahead of the consumer."""
    device = torch.device(device)
    queue = collections.deque()
    it = iter(iterator)

    def put():
        try:
            batch = next(it)
        except StopIteration:
            return
        queue.append(tuple(to_device(a, device) for a in batch))

    for _ in range(max(depth, 1)):
        put()
    while queue:
        batch = queue.popleft()
        put()
        yield batch
