"""Packed dataset: decode once, serve from memmaps (a copy of
``eelunet_tpu/data/packed.py``; numpy and PIL only).

PIL decodes every PNG again on every epoch (ToothDataset.py:47-49). Packing
writes a whole split once as uint8 numpy arrays; epochs then read batches
from memmaps with no decode.

Layout, the JAX package's, so either package reads what the other packs:
``{out_dir}/{split}_images.npy`` (N,H,W,3) uint8,
``{out_dir}/{split}_masks.npy`` (N,H,W,1) uint8, ``{out_dir}/meta.json``.
"""

from __future__ import annotations

import json
import os
from typing import Sequence, Tuple

import numpy as np

from eelunet_tpu_torch.data.dataset import IMAGE_EXTS


def pack_dataset(
    data_dir: str,
    out_dir: str,
    split: str = "train",
    image_size: Tuple[int, int] = (256, 256),
    multiclass: bool = False,
) -> str:
    """Decode a ToothDataset-style split once into uint8 memmaps."""
    from PIL import Image

    img_dir = os.path.join(data_dir, split, "images")
    mask_dir = os.path.join(data_dir, split, "masks")
    files = sorted(f for f in os.listdir(img_dir) if f.lower().endswith(IMAGE_EXTS))
    mask_files = sorted(f for f in os.listdir(mask_dir) if f.lower().endswith(IMAGE_EXTS))
    assert len(files) == len(mask_files), "Image and mask counts do not match!"

    os.makedirs(out_dir, exist_ok=True)
    h, w = image_size
    n = len(files)
    images = np.lib.format.open_memmap(
        os.path.join(out_dir, f"{split}_images.npy"), mode="w+", dtype=np.uint8,
        shape=(n, h, w, 3))
    masks = np.lib.format.open_memmap(
        os.path.join(out_dir, f"{split}_masks.npy"), mode="w+", dtype=np.uint8,
        shape=(n, h, w, 1))
    for i, (f, mf) in enumerate(zip(files, mask_files)):
        img = Image.open(os.path.join(img_dir, f)).convert("RGB").resize((w, h), Image.BILINEAR)
        # multi-class masks hold class ids: NEAREST keeps them (bilinear
        # would blend ids into classes that do not exist)
        mask = Image.open(os.path.join(mask_dir, mf)).convert("L").resize(
            (w, h), Image.NEAREST if multiclass else Image.BILINEAR)
        images[i] = np.asarray(img, np.uint8)
        masks[i, :, :, 0] = np.asarray(mask, np.uint8)
    images.flush()
    masks.flush()

    meta_path = os.path.join(out_dir, "meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            meta = json.load(fh)
    meta[split] = {"n": n, "image_size": [h, w], "files": files,
                   "multiclass": bool(multiclass)}
    with open(meta_path, "w") as fh:
        json.dump(meta, fh)
    return out_dir


class PackedDataset:
    """Indexable (image, mask) pairs over the packed memmaps, with
    ``SegmentationFolderDataset``'s contract: float32 NHWC, an
    ImageNet-normalised image and a [0, 1] mask, or with ``as_uint8`` the
    stored bytes as they are (the device preprocess scales them, and the
    device-side Canny chain can run, since they are not normalised)."""

    def __init__(
        self,
        packed_dir: str,
        split: str = "train",
        normalize_mean: Sequence[float] = (0.485, 0.456, 0.406),
        normalize_std: Sequence[float] = (0.229, 0.224, 0.225),
        as_uint8: bool = False,
    ):
        self.images = np.load(os.path.join(packed_dir, f"{split}_images.npy"), mmap_mode="r")
        self.masks = np.load(os.path.join(packed_dir, f"{split}_masks.npy"), mmap_mode="r")
        self.mean = np.asarray(normalize_mean, np.float32) * 255.0
        self.std = np.asarray(normalize_std, np.float32) * 255.0
        self.as_uint8 = as_uint8

    def __len__(self) -> int:
        return self.images.shape[0]

    def __getitem__(self, idx: int):
        if self.as_uint8:
            return np.array(self.images[idx]), np.array(self.masks[idx])
        x = (self.images[idx].astype(np.float32) - self.mean) / self.std
        y = self.masks[idx].astype(np.float32) / 255.0
        return x, y
