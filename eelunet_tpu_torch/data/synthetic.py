"""Synthetic segmentation data — test fixture and benchmark feed (copied from
``eelunet_tpu/data/synthetic.py``; numpy and PIL only).

The reference has no test data strategy at all (SURVEY.md §4); this module
provides (a) an in-memory dataset of random soft blobs with exact masks, and
(b) a writer that materializes the same data as a ToothDataset-style
``{split}/{images,masks}`` PNG tree so the folder loader and CLI paths can be
exercised end-to-end.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np


def make_blob_sample(rng: np.random.Generator, h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """One (image, mask) pair: 1-3 ellipses on textured background."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    mask = np.zeros((h, w), np.float32)
    for _ in range(rng.integers(1, 4)):
        cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
        ry, rx = rng.uniform(0.08, 0.3) * h, rng.uniform(0.08, 0.3) * w
        mask = np.maximum(mask, (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0).astype(np.float32))
    img = rng.normal(0.35, 0.1, (h, w, 3)).astype(np.float32)
    img += mask[..., None] * rng.uniform(0.25, 0.45)
    img = np.clip(img + rng.normal(0, 0.03, (h, w, 3)), 0, 1).astype(np.float32)
    return img, mask[..., None]


def _smooth_noise(rng: np.random.Generator, h: int, w: int, scale: int) -> np.ndarray:
    """Band-limited noise: low-res gaussian field bilinearly upsampled."""
    gh, gw = max(2, h // scale), max(2, w // scale)
    g = rng.normal(0.0, 1.0, (gh, gw)).astype(np.float32)
    ys = np.linspace(0, gh - 1, h, dtype=np.float32)
    xs = np.linspace(0, gw - 1, w, dtype=np.float32)
    y0 = np.clip(ys.astype(np.int32), 0, gh - 2)
    x0 = np.clip(xs.astype(np.int32), 0, gw - 2)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    a = g[y0][:, x0]
    b = g[y0][:, x0 + 1]
    c = g[y0 + 1][:, x0]
    d = g[y0 + 1][:, x0 + 1]
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx + c * fy * (1 - fx) + d * fy * fx)


def make_hard_sample(rng: np.random.Generator, h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """One HARD (image, mask) pair — the non-saturating accuracy benchmark.

    Designed so a converged EELUnet lands meaningfully below dice 1.0 (the
    reference's real task sits at mIoU ~0.956-0.961, train.py:240-242, and the
    round-1 blob fixture saturated at 0.999 — useless for regression
    detection). Ingredients:
    - multi-scale textured background whose intensity range overlaps the
      foreground (low contrast),
    - thin curved protrusions (1-2 px) attached to each body — boundary-F1
      punishes losing them,
    - distractor blobs with foreground-like intensity that are NOT labeled,
    - label noise: the stored mask is randomly locally dilated/eroded, so the
      supervision itself has an error floor.
    """
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    # --- true foreground: 1-2 elongated bodies with thin protrusions
    mask = np.zeros((h, w), np.float32)
    for _ in range(rng.integers(1, 3)):
        cy, cx = rng.uniform(0.25, 0.75) * h, rng.uniform(0.25, 0.75) * w
        ry, rx = rng.uniform(0.10, 0.22) * h, rng.uniform(0.05, 0.12) * w
        th = rng.uniform(0, np.pi)
        yr = (yy - cy) * np.cos(th) + (xx - cx) * np.sin(th)
        xr = -(yy - cy) * np.sin(th) + (xx - cx) * np.cos(th)
        body = ((yr / ry) ** 2 + (xr / rx) ** 2) < 1.0
        mask = np.maximum(mask, body.astype(np.float32))
        # thin protrusions: parametric curves from the body outward
        for _ in range(rng.integers(1, 4)):
            ang = rng.uniform(0, 2 * np.pi)
            curv = rng.uniform(-0.02, 0.02)
            length = rng.uniform(0.1, 0.25) * min(h, w)
            t = np.arange(0, length, 0.5, dtype=np.float32)
            py = cy + (ry * 0.8 + t) * np.sin(ang + curv * t)
            px = cx + (rx * 0.8 + t) * np.cos(ang + curv * t)
            ok = (py >= 0) & (py < h) & (px >= 0) & (px < w)
            mask[py[ok].astype(np.int32), px[ok].astype(np.int32)] = 1.0

    # --- image: textured background + low-contrast foreground + distractors
    tex = (
        0.5 * _smooth_noise(rng, h, w, 4)
        + 0.3 * _smooth_noise(rng, h, w, 8)
        + 0.2 * _smooth_noise(rng, h, w, 16)
    )
    img = 0.42 + 0.12 * tex[..., None].repeat(3, axis=-1)
    contrast = rng.uniform(0.08, 0.16)
    img += mask[..., None] * contrast * rng.uniform(0.8, 1.2, (1, 1, 3))
    for _ in range(rng.integers(2, 5)):  # unlabeled distractors
        cy, cx = rng.uniform(0.1, 0.9) * h, rng.uniform(0.1, 0.9) * w
        r = rng.uniform(0.03, 0.08) * min(h, w)
        blob = (((yy - cy) ** 2 + (xx - cx) ** 2) < r * r).astype(np.float32)
        blob *= 1.0 - mask  # distractors never overlap true foreground
        img += blob[..., None] * contrast * rng.uniform(0.6, 1.0)
    img = np.clip(img + rng.normal(0, 0.04, (h, w, 3)), 0, 1).astype(np.float32)

    # --- label noise: boundary-local push. A 5x5 box blur softens the mask;
    # noise re-thresholds only inside the soft boundary band, so labels
    # wobble by 1-2 px along contours (an annotator-style error floor)
    # without far-field speckles that would sink dice to ~0.85.
    k = 5
    pad = np.pad(mask, k // 2, mode="edge")
    c = pad.cumsum(0).cumsum(1)
    c = np.pad(c, ((1, 0), (1, 0)))
    blurred = (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) / (k * k)
    band = (blurred > 0.02) & (blurred < 0.98)
    noisy = np.where(band, (blurred + 0.25 * _smooth_noise(rng, h, w, 4)) > 0.5, mask)
    return img, noisy.astype(np.float32)[..., None]


def make_multiclass_sample(
    rng: np.random.Generator, h: int, w: int, num_classes: int
) -> Tuple[np.ndarray, np.ndarray]:
    """One multi-class (image, mask) pair: each foreground class 1..C-1 is an
    ellipse with a class-specific color shift; the mask holds CLASS IDS
    (H,W,1) float. Later classes paint over earlier ones (no ambiguity)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ids = np.zeros((h, w), np.int32)
    img = rng.normal(0.35, 0.08, (h, w, 3)).astype(np.float32)
    for c in range(1, num_classes):
        cy, cx = rng.uniform(0.15, 0.85) * h, rng.uniform(0.15, 0.85) * w
        ry, rx = rng.uniform(0.10, 0.25) * h, rng.uniform(0.10, 0.25) * w
        blob = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) < 1.0
        ids[blob] = c
        # distinct, deterministic per-class color so classes are separable
        shift = np.array([
            0.35 * np.cos(2.1 * c), 0.35 * np.sin(1.3 * c), 0.3 * np.cos(0.7 * c + 1)
        ], np.float32)
        img[blob] += 0.25 + shift
    img = np.clip(img + rng.normal(0, 0.03, (h, w, 3)), 0, 1).astype(np.float32)
    return img, ids.astype(np.float32)[..., None]


SAMPLE_MAKERS = {"easy": make_blob_sample, "hard": make_hard_sample}


class SyntheticDataset:
    """In-memory indexable dataset matching SegmentationFolderDataset's contract."""

    def __init__(
        self,
        n: int = 8,
        image_size: Tuple[int, int] = (64, 64),
        seed: int = 0,
        normalize_mean: Sequence[float] = (0.485, 0.456, 0.406),
        normalize_std: Sequence[float] = (0.229, 0.224, 0.225),
        difficulty: str = "easy",
        num_classes: int = 1,
    ):
        rng = np.random.default_rng(seed)
        h, w = image_size
        if num_classes > 1:
            make = lambda r, hh, ww: make_multiclass_sample(r, hh, ww, num_classes)
        else:
            make = SAMPLE_MAKERS[difficulty]
        self.samples = []
        mean = np.asarray(normalize_mean, np.float32)
        std = np.asarray(normalize_std, np.float32)
        for _ in range(n):
            img, mask = make(rng, h, w)
            self.samples.append(((img - mean) / std, mask))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        return self.samples[idx]


def write_synthetic_tree(
    root: str,
    n_train: int = 8,
    n_test: int = 4,
    image_size: Tuple[int, int] = (64, 64),
    seed: int = 0,
    difficulty: str = "easy",
    num_classes: int = 1,
) -> str:
    """Materialize a ToothDataset-style PNG tree for folder-loader/CLI tests.

    ``num_classes > 1``: masks store raw class ids (the multiclass folder
    convention — SegmentationFolderDataset(multiclass=True))."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = image_size
    if num_classes > 1:
        make = lambda r, hh, ww: make_multiclass_sample(r, hh, ww, num_classes)
        mask_scale = 1.0
    else:
        make = SAMPLE_MAKERS[difficulty]
        mask_scale = 255.0
    for split, n in (("train", n_train), ("test", n_test)):
        img_dir = os.path.join(root, split, "images")
        mask_dir = os.path.join(root, split, "masks")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(mask_dir, exist_ok=True)
        for i in range(n):
            img, mask = make(rng, h, w)
            Image.fromarray((img * 255).astype(np.uint8)).save(os.path.join(img_dir, f"{i:04d}.png"))
            Image.fromarray((mask[..., 0] * mask_scale).astype(np.uint8), mode="L").save(
                os.path.join(mask_dir, f"{i:04d}.png")
            )
    return root
