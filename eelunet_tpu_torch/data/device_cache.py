"""The whole split on the card: batches are gathers on the device
(counterpart of ``eelunet_tpu/data/device_cache.py``).

A segmentation set at the reference's scale is small (the tooth set is about
1.2 GB as uint8 at 512^2), so it can be uploaded once and indexed on the
device: each epoch then moves only the batch indices from the host, and the
loader's decode threads and uploads go away. ``data.device_cache`` turns it
on; ``data.device_cache_max_gb`` bounds it.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch


class DeviceCache:
    """Uploads an indexable (image, mask) dataset as two tensors on
    ``device`` on first use: one decode pass and one upload for all
    epochs."""

    def __init__(self, dataset, max_gb: float = 4.0, device="cuda"):
        self.dataset = dataset
        self.max_gb = float(max_gb)
        self.device = torch.device(device)
        self._tensors: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def tensors(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._tensors is None:
            n = len(self.dataset)
            if n == 0:
                raise ValueError("cannot device-cache an empty dataset")
            x0, y0 = self.dataset[0]
            bytes_est = n * (np.asarray(x0).nbytes + np.asarray(y0).nbytes)
            if bytes_est > self.max_gb * 1e9:
                raise ValueError(
                    f"device_cache: dataset is ~{bytes_est / 1e9:.2f} GB "
                    f"(> data.device_cache_max_gb={self.max_gb}); disable "
                    "data.device_cache or raise the limit")
            xs = np.empty((n, *x0.shape), x0.dtype)
            ys = np.empty((n, *y0.shape), y0.dtype)
            xs[0], ys[0] = x0, y0
            for i in range(1, n):
                xs[i], ys[i] = self.dataset[i]
            self._tensors = (torch.from_numpy(xs).to(self.device),
                             torch.from_numpy(ys).to(self.device))
        return self._tensors


class DeviceCachedLoader:
    """``data.pipeline.DataLoader`` over a ``DeviceCache``: the same length,
    tail and shuffle (``seed + epoch``-keyed permutation), so the batches are
    the streamed loader's, byte for byte; each is an ``index_select`` on the
    device."""

    def __init__(
        self,
        cache: DeviceCache,
        batch_size: int = 8,
        shuffle: bool = False,
        seed: int = 0,
        drop_remainder: bool = True,
        indices: Optional[np.ndarray] = None,
    ):
        self.cache = cache
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.indices = np.asarray(
            indices if indices is not None else np.arange(len(cache.dataset)))
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.indices)
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle key of the NEXT pass to ``epoch`` (exact resume)."""
        self._epoch = int(epoch)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        images, masks = self.cache.tensors()
        order = self.indices
        if self.shuffle:
            order = np.random.default_rng(self.seed + self._epoch).permutation(order)
        self._epoch += 1
        nb = len(self)
        bs = self.batch_size
        end = nb * bs if self.drop_remainder else len(order)
        # All of the epoch's indices in one upload; each batch is a slice.
        order_dev = torch.from_numpy(np.asarray(order[:end], np.int64)).to(images.device)
        for b in range(nb):
            idx = order_dev[b * bs:min((b + 1) * bs, end)]
            yield images.index_select(0, idx), masks.index_select(0, idx)
