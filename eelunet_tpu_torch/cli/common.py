"""Shared CLI plumbing: argparse -> TrainConfig with dotted overrides, and
the datasets and loaders of a config (counterpart of
``eelunet_tpu/cli/common.py``). ``--device`` is the port's counterpart of
``JAX_PLATFORMS``: the CLIs run on the CUDA card unless it says "cpu"."""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict

from eelunet_tpu_torch.config import TrainConfig, apply_overrides, config_from_json
from eelunet_tpu_torch.data.dataset import SegmentationFolderDataset, train_val_split
from eelunet_tpu_torch.data.pipeline import DataLoader


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", type=str, default="", help="JSON config file")
    p.add_argument("--model_type", type=str, default=None,
                   choices=["unet", "eelunet", "unet++", "unetpp", "egeunet",
                            "unext", "unext_s", "malunet"])
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--save_dir", type=str, default=None,
                   help="checkpoint root; used by every CLI that saves or "
                   "resolves tagged checkpoints")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="dotted config override, e.g. --set model.dtype=bfloat16")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where to run: the CUDA card (default; raises without one) "
                   "or, only when asked, the CPU")
    return p


def load_config(args) -> TrainConfig:
    if args.config:
        with open(args.config) as f:
            cfg = config_from_json(f.read())
    else:
        cfg = TrainConfig()
    ov = list(args.set)
    if args.model_type is not None:
        ov.append(f"model.name={args.model_type}")
    if args.data_dir is not None:
        ov.append(f"data.data_dir={args.data_dir}")
    if args.batch_size is not None:
        ov.append(f"data.batch_size={args.batch_size}")
    if args.image_size is not None:
        ov.append(f"data.image_size=[{args.image_size},{args.image_size}]")
    if args.seed is not None:
        ov.append(f"seed={args.seed}")
    if getattr(args, "save_dir", None) is not None:
        ov.append(f"save_dir={args.save_dir}")
    return apply_overrides(cfg, ov)


def wants_raw_images(d) -> bool:
    """True when a Canny augmentation is on: the datasets then yield raw
    [0,1] RGB and normalisation moves into the device-side chain
    (``data/augment.make_augment_fn``)."""
    return bool(d.add_canny_edge or d.canny_enhance)


def make_folder_dataset(d, split: str, num_classes: int = 1) -> SegmentationFolderDataset:
    """Dataset for one split, honouring the augmentations' raw images, the
    uint8 device feed and multi-class id masks. Every CLI builds its datasets
    here, so the flags act alike in each."""
    return SegmentationFolderDataset(
        d.data_dir, split, d.image_size, d.normalize_mean, d.normalize_std,
        normalize=not wants_raw_images(d), as_uint8=bool(d.uint8_feed),
        multiclass=num_classes > 1)


def build_loaders(cfg: TrainConfig, device=None):
    """train/val/test loaders: the reference's 90/10 split of the train dir
    and a separate test dir (train.py:255-265). Only the shuffled train
    loader drops its remainder; val and test cover every sample.

    ``data.packed``: ``data_dir`` is a ``cli.pack`` output (memmaps).
    ``data.device_cache``: the splits are uploaded once to ``device`` (None =
    "cuda") and each batch is a gather there (``data/device_cache.py``).

    Under a process group the train loader yields this rank's rows of each
    global batch (``process_shard``, with ``accum_steps``; the seed must be
    the same on every rank, ``sync_seed``), and val and test stay whole on
    every rank, as in the JAX package (``eelunet_tpu/cli/common.py:113-142``).
    The device cache is single-process only: a group streams."""
    d = cfg.data
    num_classes = cfg.model.out_channels
    if d.packed:
        if num_classes > 1 and not d.uint8_feed:
            raise ValueError(
                "multi-class packed datasets need data.uint8_feed (default): "
                "the packed float path applies the binary /255 mask scale, "
                "while uint8 masks pass class ids through to the device "
                "preprocess unscaled")
        if wants_raw_images(d) and not d.uint8_feed:
            raise ValueError(
                "add_canny_edge/canny_enhance need raw images; the packed "
                "float path serves normalized tensors. Enable data.uint8_feed "
                "(default): packed memmaps are uint8 before normalisation, so "
                "the device augment chain applies; or use the PNG tree "
                "(data.packed=false).")
        from eelunet_tpu_torch.data.packed import PackedDataset

        full, test = (PackedDataset(d.data_dir, split, d.normalize_mean, d.normalize_std,
                                    as_uint8=d.uint8_feed) for split in ("train", "test"))
    else:
        full = make_folder_dataset(d, "train", num_classes)
        test = make_folder_dataset(d, "test", num_classes)
    seed = cfg.seed if cfg.seed is not None else 0
    tr_idx, va_idx = train_val_split(len(full), d.val_fraction, seed)
    from eelunet_tpu_torch.parallel.distributed import process_shard_spec

    shard = process_shard_spec()
    if d.device_cache and shard is None:
        from eelunet_tpu_torch.data.device_cache import DeviceCache, DeviceCachedLoader
        from eelunet_tpu_torch.registry import resolve_device

        dev = resolve_device(device)
        full_c, test_c = (DeviceCache(ds, d.device_cache_max_gb, dev) for ds in (full, test))

        def mkc(cache, idx, shuffle):
            return DeviceCachedLoader(cache, d.batch_size, shuffle=shuffle, seed=seed,
                                      drop_remainder=d.drop_remainder and shuffle, indices=idx)

        return mkc(full_c, tr_idx, True), mkc(full_c, va_idx, False), mkc(test_c, None, False)

    def mk(ds, idx, shuffle):
        return DataLoader(ds, d.batch_size, shuffle=shuffle, seed=seed,
                          drop_remainder=(d.drop_remainder or shard is not None) and shuffle,
                          num_workers=d.num_workers, indices=idx,
                          process_shard=shard if shuffle else None,
                          accum_steps=cfg.accum_steps if shuffle else 1)

    return mk(full, tr_idx, True), mk(full, va_idx, False), mk(test, None, False)


def slim_config(cfg: TrainConfig, checkpoint: str, path_name: str) -> TrainConfig:
    """The config for a slim (physically pruned) ``checkpoint``: its model
    is the one its ``widths.json`` names, built from it
    (``model.slim_init``). The Canny flags are refused, as in the JAX
    package: they add a 4th input channel, and slim checkpoints hold
    3-channel models. ``path_name`` names the CLI path in the message."""
    from eelunet_tpu_torch.prune_physical import read_widths

    if wants_raw_images(cfg.data):
        raise ValueError(
            f"add_canny_edge/canny_enhance are not supported on the slim "
            f"(physically pruned) {path_name} path; {path_name} with the dense model.")
    name, _ = read_widths(checkpoint)
    model = dataclasses.replace(cfg.model, name=name, slim_init=checkpoint)
    return dataclasses.replace(cfg, model=model)


def serving_mesh(cfg, device):
    """The mesh a single-process entry point serves on (counterpart of
    ``eelunet_tpu/cli/serve.py:118-128``): every card of the process along
    ``data`` when more than one is present, or the ``mesh.data_axis`` asked
    for; None for one device. Refuses the ``model`` and ``spatial`` axes."""
    import torch

    from eelunet_tpu_torch.parallel.mesh import NOT_PORTED_AXES, create_mesh

    if cfg.mesh.model_axis > 1 or cfg.mesh.spatial_axis > 1:
        raise NotImplementedError(NOT_PORTED_AXES)
    cards = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
    if cards > 1 or cfg.mesh.data_axis > 1:
        devices = None if torch.device(device).type == "cuda" else [device]
        return create_mesh(cfg.mesh.data_axis, 1, devices=devices)
    return None


def kernel_launches() -> Dict[str, int]:
    """Launches of every hand-written kernel in this process since its last
    reset; all 0 on the CPU, where the plain twins run."""
    from eelunet_tpu_torch.ops import conv_cuda, edge_cuda, fft_cuda

    return {**fft_cuda.LAUNCHES, **edge_cuda.LAUNCHES, **conv_cuda.LAUNCHES}
