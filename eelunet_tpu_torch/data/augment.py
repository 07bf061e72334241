"""Device-side input preprocessing and augmentation (counterpart of
``eelunet_tpu/data/augment.py``; reference augmentation/AddCannyEdge.py:8-41,
augmentation/CannyEnhance.py:7-44).

``make_input_preprocess`` turns the uint8 feed into model input on the
device; ``random_flip_batch`` flips (image, mask) pairs per sample. The two
Canny augmentations, ``canny_enhance`` and ``add_canny_edge``, run the
improved Canny (``ops/edge.canny_edge_improve``) on the whole batch: on a
CUDA tensor its blur, Sobel and non-max suppression run in kernel 5. They
work on unnormalised [0, 1] RGB, so when either is on the datasets yield raw
images (``cli/common.wants_raw_images``) and ``make_augment_fn`` normalises
after them.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from eelunet_tpu_torch.ops.edge import canny_edge_improve, rgb_to_grayscale

# cv2.Canny(100, 200) thresholds on a 0-255 scale -> [0,1] scale.
_CV2_LOW = 100.0 / 255.0
_CV2_HIGH = 200.0 / 255.0


def normalize_imagenet(
    images: torch.Tensor,
    mean: Sequence[float] = (0.485, 0.456, 0.406),
    std: Sequence[float] = (0.229, 0.224, 0.225),
) -> torch.Tensor:
    """ImageNet normalisation of NHWC images in [0, 1] (ToothDataset.py:60)."""
    m = _constant(tuple(mean), images.dtype, images.device).view(1, 1, 1, -1)
    s = _constant(tuple(std), images.dtype, images.device).view(1, 1, 1, -1)
    return (images - m) / s


@functools.lru_cache(maxsize=32)
def _constant(values: Tuple[float, ...], dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``values`` as a tensor on ``device``, uploaded once per dtype and
    device: an upload per batch would make the host wait for the card and
    drain the queue the chain keeps ahead of it. Read only; made outside
    inference mode, so autograd may use it later."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def add_canny_edge(images: torch.Tensor) -> torch.Tensor:
    """Append the Canny edge map of the grayscale image as a 4th channel
    (AddCannyEdge.py:8-41): (N,H,W,3) in [0,1] -> (N,H,W,4)."""
    edges = canny_edge_improve(rgb_to_grayscale(images), _CV2_LOW, _CV2_HIGH)
    return torch.cat([images, edges], dim=-1)


def canny_enhance(images: torch.Tensor, alpha: float = 0.2,
                  edge_color: Sequence[float] = (1.0, 1.0, 1.0)) -> torch.Tensor:
    """Blend a coloured edge overlay into the image (CannyEnhance.py:7-44):
    clip(image + alpha * edges * edge_color, 0, 1), cv2.addWeighted's
    semantics."""
    edges = canny_edge_improve(rgb_to_grayscale(images), _CV2_LOW, _CV2_HIGH)
    color = _constant(tuple(edge_color), images.dtype, images.device).view(1, 1, 1, 3)
    return torch.clamp(images + alpha * (edges * color), 0.0, 1.0)


def random_flip_batch(generator: torch.Generator, images: torch.Tensor, labels: torch.Tensor,
                      rows=None, total: Optional[int] = None):
    """Per-sample random vertical (H) then horizontal (W) flips of NHWC images
    and masks together, each with probability 1/2, drawn from ``generator``
    (a CPU generator; the draw is moved to the images' device). Shapes stay
    static: both orientations are computed and selected per sample.

    ``rows``/``total``: ``images`` are the rows ``rows`` of a batch of
    ``total`` (one rank's share of a data-parallel batch); the flips are
    drawn for the whole batch and those rows' are applied."""
    b = images.shape[0]
    flags = torch.rand((2, b if rows is None else total), generator=generator) < 0.5
    if rows is not None:
        flags = flags[:, torch.as_tensor(rows)]
    fh, fw = (f.to(images.device).view(b, 1, 1, 1) for f in flags)
    images = torch.where(fh, torch.flip(images, (1,)), images)
    labels = torch.where(fh, torch.flip(labels, (1,)), labels)
    images = torch.where(fw, torch.flip(images, (2,)), images)
    labels = torch.where(fw, torch.flip(labels, (2,)), labels)
    return images, labels


def make_augment_fn(data_cfg):
    """The device-side input chain of a DataConfig, or None when both Canny
    flags are off: (N,H,W,3) raw [0,1] RGB -> model input. The
    ``canny_enhance`` blend, then the ``add_canny_edge`` 4th channel, then
    ImageNet normalisation of the RGB channels only: the edge channel is a
    {0,1} map and stays as it is (the reference's 3-channel statistics
    never covered a 4th channel)."""
    enhance = bool(data_cfg.canny_enhance)
    add_edge = bool(data_cfg.add_canny_edge)
    if not (enhance or add_edge):
        return None
    alpha = float(data_cfg.canny_enhance_alpha)
    mean = tuple(data_cfg.normalize_mean)
    std = tuple(data_cfg.normalize_std)

    def augment(images: torch.Tensor) -> torch.Tensor:
        if enhance:
            images = canny_enhance(images, alpha)
        if add_edge:
            images = add_canny_edge(images)
        rgb = normalize_imagenet(images[..., :3], mean, std)
        return torch.cat([rgb, images[..., 3:]], dim=-1) if add_edge else rgb

    return augment


def make_input_preprocess(data_cfg, num_classes: int = 1):
    """The device-side (images, labels) preprocess for a DataConfig
    (``augment.py:125-161`` in the JAX package):

    - uint8 images (``data.uint8_feed``): u8 -> f32 / 255, then the augment
      chain, or ImageNet normalisation when it is off; uint8 masks -> f32 /
      255 (binary 0/255 -> {0, 1});
    - float images with the augment chain on: raw [0,1] RGB -> the chain;
    - float images, chain off: already normalised on the host; passed
      through.

    With ``num_classes > 1`` uint8 labels are class ids: cast to float32
    without the /255."""
    augment = make_augment_fn(data_cfg)
    mean = tuple(data_cfg.normalize_mean)
    std = tuple(data_cfg.normalize_std)

    def preprocess(images: torch.Tensor, labels: torch.Tensor):
        if labels.dtype == torch.uint8:
            labels = labels.float()
            if num_classes == 1:
                labels = labels / 255.0
        if images.dtype == torch.uint8:
            images = images.float() / 255.0
            images = augment(images) if augment is not None else normalize_imagenet(
                images, mean, std)
        elif augment is not None:
            images = augment(images)
        return images, labels

    return preprocess
