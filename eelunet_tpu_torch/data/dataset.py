"""Host-side dataset: ToothDataset-compatible directory layout (copied from
``eelunet_tpu/data/dataset.py``; numpy and PIL only).

Reference data/ToothDataset.py:10-63: ``{data_dir}/{split}/{images,masks}``
with sorted file pairing and a count assert; images decoded RGB, masks L;
both resized (bilinear) to the target size; image normalized with ImageNet
mean/std, mask left in [0,1] (anti-aliased resize can make it non-binary —
same as the reference's Resize+ToTensor path).

Returns NHWC numpy arrays (float32, or uint8 for the device-side feed).
Decoding uses PIL; normalisation at scale belongs on the device.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

try:
    from PIL import Image

    _HAS_PIL = True
except ImportError:  # pragma: no cover
    _HAS_PIL = False

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp")


class SegmentationFolderDataset:
    """Image/mask pair dataset over a ``{split}/{images,masks}`` tree."""

    def __init__(
        self,
        data_dir: str,
        split: str = "train",
        image_size: Optional[Tuple[int, int]] = (256, 256),
        normalize_mean: Sequence[float] = (0.485, 0.456, 0.406),
        normalize_std: Sequence[float] = (0.229, 0.224, 0.225),
        normalize: bool = True,
        as_uint8: bool = False,
        multiclass: bool = False,
    ):
        if not _HAS_PIL:
            raise RuntimeError("PIL is required for SegmentationFolderDataset")
        self.image_dir = os.path.join(data_dir, split, "images")
        self.mask_dir = os.path.join(data_dir, split, "masks")
        self.image_files = sorted(
            f for f in os.listdir(self.image_dir) if f.lower().endswith(IMAGE_EXTS)
        )
        self.mask_files = sorted(
            f for f in os.listdir(self.mask_dir) if f.lower().endswith(IMAGE_EXTS)
        )
        # ToothDataset.py:31
        assert len(self.image_files) == len(self.mask_files), "Image and mask counts do not match!"
        # image_size=None keeps each sample at its NATIVE resolution (no
        # resize) — used by tiled inference (cli.predict --tile); such
        # datasets yield ragged shapes, so batch them one sample at a time.
        self.image_size = tuple(image_size) if image_size is not None else None
        self.mean = np.asarray(normalize_mean, np.float32)
        self.std = np.asarray(normalize_std, np.float32)
        # normalize=False defers ImageNet normalization to the device — the
        # Canny augmentations operate on raw [0,1] RGB first, matching the
        # reference's transform order (ToothDataset.py:52-61: augment, then
        # normalize). data/augment.make_augment_fn normalizes afterwards.
        self.normalize = normalize
        # as_uint8=True yields raw uint8 (H,W,3)/(H,W,1) samples; the device
        # preprocess (data/augment.make_input_preprocess) does u8/255 and
        # normalization after the 4x-smaller host->device copy.
        self.as_uint8 = as_uint8
        # multiclass=True (model.out_channels > 1): mask pixels are CLASS IDS
        # in [0, C). They resize with NEAREST (bilinear would blend ids into
        # nonexistent classes) and are returned unscaled (no /255).
        self.multiclass = multiclass

    def __len__(self) -> int:
        return len(self.image_files)

    def name(self, idx: int) -> str:
        return self.image_files[idx]

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        img = Image.open(os.path.join(self.image_dir, self.image_files[idx])).convert("RGB")
        mask = Image.open(os.path.join(self.mask_dir, self.mask_files[idx])).convert("L")
        if self.image_size is not None:
            h, w = self.image_size
            img = img.resize((w, h), Image.BILINEAR)
            mask = mask.resize((w, h), Image.NEAREST if self.multiclass else Image.BILINEAR)
        if self.as_uint8:
            return np.asarray(img, np.uint8), np.asarray(mask, np.uint8)[..., None]
        x = np.asarray(img, np.float32) / 255.0            # (H, W, 3)
        if self.normalize:
            x = (x - self.mean) / self.std                 # ToothDataset.py:60
        y = np.asarray(mask, np.float32)[..., None]        # (H, W, 1)
        if not self.multiclass:
            y = y / 255.0                                  # binary 0/255 -> [0,1]
        return x, y


def train_val_split(
    n: int, val_fraction: float = 0.1, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Random 90/10 index split (reference random_split, train.py:256-259)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_train = int(n * (1.0 - val_fraction))
    return perm[:n_train], perm[n_train:]
