"""Threaded host input pipeline with prefetch to the device (counterpart of
``eelunet_tpu/data/pipeline.py``).

- ``DataLoader`` decodes samples in a thread pool and stacks them into NHWC
  numpy batches of static shape (``drop_remainder``); its shuffle is keyed
  by ``seed + epoch`` (``set_epoch``), so a resumed run replays the batch
  order of an uninterrupted one exactly.
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


class DataLoader:
    """Minimal batched loader over an indexable dataset of (image, mask) pairs."""

    def __init__(
        self,
        dataset,
        batch_size: int = 8,
        shuffle: bool = False,
        seed: int = 0,
        drop_remainder: bool = True,
        num_workers: int = 4,
        indices: Optional[np.ndarray] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.num_workers = max(1, num_workers)
        self.indices = np.asarray(indices if indices is not None else np.arange(len(dataset)))
        self._epoch = 0

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
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            futures = [pool.submit(self.dataset.__getitem__, int(i))
                       for i in order[: nb * bs if self.drop_remainder else None]]
            for b in range(nb):
                samples = [f.result() for f in futures[b * bs:(b + 1) * bs]]
                yield (np.stack([s[0] for s in samples]), np.stack([s[1] for s in samples]))


def _to_device(a, device: torch.device) -> torch.Tensor:
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
        queue.append(tuple(_to_device(a, device) for a in batch))

    for _ in range(max(depth, 1)):
        put()
    while queue:
        batch = queue.popleft()
        put()
        yield batch
