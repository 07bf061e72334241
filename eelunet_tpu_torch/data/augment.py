"""Device-side input preprocessing and augmentation (counterpart of
``eelunet_tpu/data/augment.py:59-161``).

``make_input_preprocess`` turns the uint8 feed into model input on the
device; ``random_flip_batch`` flips (image, mask) pairs per sample. The Canny
augmentations need the fused Canny kernel (TPU kernel 5, not ported yet) and
raise ``NotImplementedError`` (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Sequence

import torch


def normalize_imagenet(
    images: torch.Tensor,
    mean: Sequence[float] = (0.485, 0.456, 0.406),
    std: Sequence[float] = (0.229, 0.224, 0.225),
) -> torch.Tensor:
    """ImageNet normalisation of NHWC images in [0, 1] (ToothDataset.py:60)."""
    m = torch.tensor(mean, dtype=images.dtype, device=images.device).view(1, 1, 1, -1)
    s = torch.tensor(std, dtype=images.dtype, device=images.device).view(1, 1, 1, -1)
    return (images - m) / s


def _canny_not_ported():
    raise NotImplementedError("the Canny augmentations (data.add_canny_edge, "
                              "data.canny_enhance) need the fused Canny kernel, not ported "
                              "yet; see ROADMAP.md")


def add_canny_edge(images: torch.Tensor) -> torch.Tensor:
    _canny_not_ported()


def canny_enhance(images: torch.Tensor, alpha: float = 0.2) -> torch.Tensor:
    _canny_not_ported()


def random_flip_batch(generator: torch.Generator, images: torch.Tensor, labels: torch.Tensor):
    """Per-sample random vertical (H) then horizontal (W) flips of NHWC images
    and masks together, each with probability 1/2, drawn from ``generator``
    (a CPU generator; the draw is moved to the images' device). Shapes stay
    static: both orientations are computed and selected per sample."""
    b = images.shape[0]
    flags = torch.rand((2, b), generator=generator) < 0.5
    fh, fw = (f.to(images.device).view(b, 1, 1, 1) for f in flags)
    images = torch.where(fh, torch.flip(images, (1,)), images)
    labels = torch.where(fh, torch.flip(labels, (1,)), labels)
    images = torch.where(fw, torch.flip(images, (2,)), images)
    labels = torch.where(fw, torch.flip(labels, (2,)), labels)
    return images, labels


def make_input_preprocess(data_cfg, num_classes: int = 1):
    """The device-side (images, labels) preprocess for a DataConfig
    (``augment.py:114-161`` in the JAX package):

    - uint8 images (``data.uint8_feed``): u8 -> f32 / 255 -> ImageNet
      normalisation; uint8 masks -> f32 / 255 (binary 0/255 -> {0, 1});
    - float images: already normalised on the host; passed through."""
    if data_cfg.add_canny_edge or data_cfg.canny_enhance:
        _canny_not_ported()
    if num_classes > 1:
        raise NotImplementedError("multi-class masks (model.out_channels > 1) are not ported "
                                  "yet; see ROADMAP.md")
    mean = tuple(data_cfg.normalize_mean)
    std = tuple(data_cfg.normalize_std)

    def preprocess(images: torch.Tensor, labels: torch.Tensor):
        if labels.dtype == torch.uint8:
            labels = labels.float() / 255.0
        if images.dtype == torch.uint8:
            images = normalize_imagenet(images.float() / 255.0, mean, std)
        return images, labels

    return preprocess
