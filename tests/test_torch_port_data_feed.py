"""The port's data feed against the JAX package's on the CPU: packed memmaps
(byte for byte, and each package reads the other's), the device-resident
loader against the streamed one, the guards of ``build_loaders``, and
``cli.train`` on packed, device-cached data with a traced window."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from eelunet_tpu.data.packed import PackedDataset as JaxPackedDataset
from eelunet_tpu.data.packed import pack_dataset as jax_pack_dataset
from eelunet_tpu_torch.cli import pack as pack_cli
from eelunet_tpu_torch.cli import train as train_cli
from eelunet_tpu_torch.cli.common import build_loaders
from eelunet_tpu_torch.config import TrainConfig, apply_overrides
from eelunet_tpu_torch.data.dataset import SegmentationFolderDataset
from eelunet_tpu_torch.data.device_cache import DeviceCache, DeviceCachedLoader
from eelunet_tpu_torch.data.packed import PackedDataset, pack_dataset
from eelunet_tpu_torch.data.pipeline import DataLoader
from eelunet_tpu_torch.data.synthetic import write_synthetic_tree


@pytest.fixture(scope="module", params=[1, 3], ids=["binary", "3class"])
def tree(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"feed{request.param}")
    return request.param, write_synthetic_tree(str(root / "tree"), n_train=10, n_test=3,
                                               image_size=(40, 36), seed=request.param,
                                               num_classes=request.param)


def test_packed_files_equal_jax_and_read_across(tree, tmp_path):
    """The port's ``pack_dataset`` and ``cli.pack`` write JAX's files byte
    for byte; each package's PackedDataset reads the other's files alike,
    as uint8 and as normalised float."""
    from eelunet_tpu.cli import pack as jax_pack_cli

    classes, root = tree
    out = {k: str(tmp_path / k) for k in ("jax", "port", "jax_cli", "port_cli")}
    for split in ("train", "test"):  # non-square, as a config may ask
        jax_pack_dataset(root, out["jax"], split, (32, 24), multiclass=classes > 1)
        pack_dataset(root, out["port"], split, (32, 24), multiclass=classes > 1)
    flags = ["--data_dir", root, "--image_size", "32"] + (["--multiclass"] if classes > 1 else [])
    jax_pack_cli.main(flags + ["--out", out["jax_cli"]])
    pack_cli.main(flags + ["--out", out["port_cli"]])
    for a, b in (("jax", "port"), ("jax_cli", "port_cli")):
        for f in ("train_images.npy", "train_masks.npy", "test_images.npy", "test_masks.npy",
                  "meta.json"):
            with open(os.path.join(out[a], f), "rb") as fa, \
                    open(os.path.join(out[b], f), "rb") as fb:
                assert fa.read() == fb.read(), (b, f)
    masks = np.load(os.path.join(out["port"], "test_masks.npy"))
    assert set(np.unique(masks)) <= ({0, 1, 2} if classes > 1 else set(range(256)))
    for as_uint8 in (True, False):
        for split, n in (("train", 10), ("test", 3)):
            a = PackedDataset(out["jax"], split, as_uint8=as_uint8)
            b = JaxPackedDataset(out["port"], split, as_uint8=as_uint8)
            assert len(a) == len(b) == n
            for i in (0, n - 1):
                for x, y in zip(a[i], b[i]):
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)


def test_device_cached_batches_equal_the_streamed_loader(tree):
    """Same length, shuffle (seed + epoch) and tail as ``DataLoader``, over
    two epochs; every batch byte-equal."""
    classes, root = tree
    ds = SegmentationFolderDataset(root, "train", (32, 32), as_uint8=True,
                                   multiclass=classes > 1)
    cache = DeviceCache(ds, device="cpu")
    idx = np.array([7, 2, 9, 0, 4, 5, 1])
    for kw in (dict(shuffle=True, drop_remainder=True, indices=idx),
               dict(shuffle=False, drop_remainder=False, indices=None)):
        dev = DeviceCachedLoader(cache, batch_size=3, seed=3, **kw)
        host = DataLoader(ds, batch_size=3, seed=3, num_workers=1, **kw)
        assert len(dev) == len(host) == (2 if kw["drop_remainder"] else 4)
        for epoch in range(2):
            dev.set_epoch(epoch)
            host.set_epoch(epoch)
            pairs = list(zip(dev, host))
            assert len(pairs) == len(host)
            for (dx, dy), (hx, hy) in pairs:
                assert dx.dtype == torch.uint8 and dx.device.type == "cpu"
                np.testing.assert_array_equal(dx.numpy(), hx)
                np.testing.assert_array_equal(dy.numpy(), hy)
    assert [x.shape[0] for x, _ in DeviceCachedLoader(cache, 4, drop_remainder=False)] == \
        [4, 4, 2]


def test_build_loaders_guards(tree, tmp_path):
    """JAX's guards on packed data (multi-class and the Canny chain need the
    uint8 feed), the device cache's size bound, and no card unless the CPU
    is asked for."""
    classes, root = tree
    out = str(tmp_path / "packed")
    for split in ("train", "test"):
        pack_dataset(root, out, split, (32, 32), multiclass=classes > 1)
    base = [f"data.data_dir={out}", "data.packed=true", "data.image_size=32",
            "data.batch_size=4", f"model.out_channels={classes}"]
    float_feed = apply_overrides(TrainConfig(), base + ["data.uint8_feed=false"])
    if classes > 1:
        with pytest.raises(ValueError, match="multi-class packed"):
            build_loaders(float_feed)
    else:
        x, y = next(iter(build_loaders(float_feed)[2]))
        assert x.dtype == y.dtype == np.float32
    for flag in ("data.canny_enhance=true", "data.add_canny_edge=true"):
        with pytest.raises(ValueError, match="multi-class packed" if classes > 1
                           else "raw images"):
            build_loaders(apply_overrides(TrainConfig(), base + ["data.uint8_feed=false",
                                                                 flag]))
    cached = apply_overrides(TrainConfig(), base + ["data.device_cache=true"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            build_loaders(cached)
    tr, va, te = build_loaders(cached, device="cpu")
    assert isinstance(tr, DeviceCachedLoader) and len(tr) == 9 // 4
    assert next(iter(te))[0].shape == (3, 32, 32, 3)
    tight = apply_overrides(TrainConfig(), base + ["data.device_cache=true",
                                                   "data.device_cache_max_gb=1e-6"])
    with pytest.raises(ValueError, match="device_cache"):
        next(iter(build_loaders(tight, device="cpu")[0]))


def test_cli_train_on_packed_cached_data_equals_the_png_feed(tree, tmp_path):
    """``cli.train`` twice with one seed, on the PNG tree and on its pack
    with ``data.device_cache`` and ``profile_steps=2``: the same losses and
    metrics, a trace in ``log_dir/<model>/profile``, and the background
    writer's files (async checkpoints, the default) in place."""
    classes, root = tree
    packed = str(tmp_path / "packed")
    pack_cli.main(["--data_dir", root, "--out", packed, "--image_size", "32"]
                  + (["--multiclass"] if classes > 1 else []))
    common = ["--device", "cpu", "--model_type", "unext_s", "--image_size", "32",
              "--batch_size", "3", "--epochs", "2", "--seed", "0",
              "--set", f"model.out_channels={classes}", "--set", "data.num_workers=1"]
    hist = {}
    for name, extra in (("png", ["--data_dir", root]),
                        ("packed", ["--data_dir", packed, "--set", "data.packed=true",
                                    "--set", "data.device_cache=true",
                                    "--set", "profile_steps=2"])):
        save, logs = tmp_path / f"ck_{name}", tmp_path / f"runs_{name}"
        train_cli.main(common + extra + ["--save_dir", str(save), "--log_dir", str(logs)])
        hist[name] = json.loads((save / "unext_s" / "loss_history.json").read_text())
        assert (save / "unext_s" / "unext_s_best.npz").is_file()
        assert (save / "unext_s" / "unext_s_last" / "state.pt").is_file()
        assert json.loads((save / "unext_s" / "best_meta.json").read_text())["best"]
    assert hist["png"] == hist["packed"]
    traces = os.listdir(tmp_path / "runs_packed" / "unext_s" / "profile")
    assert any(t.endswith(".pt.trace.json") for t in traces), traces
    assert not (tmp_path / "runs_png" / "unext_s" / "profile").exists()


def test_trace_context_and_step_timer(tmp_path):
    """``trace_context`` writes one Chrome trace into its directory, also when
    the region raises, and is a no-op without a directory; ``StepTimer``
    smooths its step times."""
    from eelunet_tpu_torch.utils.profiling import StepTimer, trace_context

    with trace_context(str(tmp_path / "a")):
        torch.ones(64).sum()
    with pytest.raises(ValueError):
        with trace_context(str(tmp_path / "b")):
            raise ValueError("inside the traced region")
    with trace_context(""):
        pass
    for d in ("a", "b"):
        traces = [f for f in os.listdir(tmp_path / d) if f.endswith(".pt.trace.json")]
        assert len(traces) == 1, traces
        with open(tmp_path / d / traces[0]) as f:
            assert "traceEvents" in json.load(f)
    timer = StepTimer(alpha=0.5)
    timer.start()
    first = timer.stop(torch.ones(3))
    timer.start()
    second = timer.stop((torch.ones(2), {"x": torch.zeros(1)}))
    assert timer.ewma == pytest.approx(0.5 * first + 0.5 * second)
    assert timer.images_per_sec(8) == pytest.approx(8 / timer.ewma)
