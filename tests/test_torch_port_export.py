"""The port's deployment artifacts (``eelunet_tpu_torch/export.py``,
``cli.export``, ``cli.serve --artifact``) against the live Predictor and the
JAX package's artifact layout: a program exported on the CPU and loaded in a
fresh process, with no model code imported, equals the Predictor pinned to
the low-rank high-pass; buckets, refusals and ``meta.json`` as in
``eelunet_tpu/export.py``; the weights are baked in; an int8 artifact; and
``cli.serve --artifact`` answering a request. The model is the narrow
EELUnet behind a slim checkpoint (tests/torch_port_helpers.py)."""

from __future__ import annotations

import dataclasses
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from eelunet_tpu_torch.cli import export as export_cli
from eelunet_tpu_torch.export import ExportedModel, export_model
from eelunet_tpu_torch.inference import Predictor
from eelunet_tpu_torch.prune_physical import save_slim
from torch_port_helpers import CFG, MASK_RANGE, NARROW, narrow_flax_variables

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 32
LOWRANK = dataclasses.replace(CFG, highpass_impl="lowrank")


def _slim_checkpoint(path, seed=0):
    """The narrow EELUnet (random BN statistics) as a slim checkpoint."""
    from eelunet_tpu_torch.models.convert import from_flax_variables

    return save_slim(str(path), from_flax_variables(narrow_flax_variables(seed)), dict(NARROW),
                     "eelunet")


def _u8(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, HW, HW, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """``cli.export`` of the slim checkpoint at buckets 2 and 4 on the CPU,
    the lowrank Predictor's answers on the same weights, then the checkpoint
    deleted: the artifact has to carry its weights."""
    root = tmp_path_factory.mktemp("export")
    ckpt = _slim_checkpoint(root / "slim")
    out = str(root / "art")
    export_cli.main(["--device", "cpu", "--model_type", "eelunet", "--checkpoint", ckpt,
                     "--image_size", str(HW), "--set", f"model.fft_mask_range={MASK_RANGE}",
                     "--batch_sizes", "4,2", "--output", out])
    pred = Predictor(LOWRANK, checkpoint=ckpt, bucket_batches=False, device="cpu")
    want = {n: pred.predict_proba(_u8(n)) for n in (2, 3)}
    shutil.rmtree(ckpt)
    return out, want


def test_fresh_process_matches_lowrank_predictor(artifact, tmp_path):
    out, want = artifact
    np.save(tmp_path / "in.npy", _u8(2))
    probe = (
        "import sys, numpy as np\n"
        "from eelunet_tpu_torch.export import ExportedModel\n"
        f"m = ExportedModel({out!r})\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, m.predict_proba(np.load({str(tmp_path / 'in.npy')!r})))\n"
        "bad = sorted(k for k in sys.modules if k.startswith(('eelunet_tpu_torch.models', "
        "'eelunet_tpu_torch.ops', 'eelunet_tpu_torch.prune', 'jax', 'eelunet_tpu.')))\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=_REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = np.load(tmp_path / "out.npy")
    assert got.shape == (2, HW, HW, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, want[2], atol=1e-5, rtol=0)
    assert want[2].std() > 1e-4


def test_ragged_batches_pad_and_refusals(artifact):
    out, want = artifact
    m = ExportedModel(out)
    u8 = _u8(3)
    got = m.predict_proba(u8)  # pads to the 4 bucket
    assert got.shape == (3, HW, HW, 1)
    np.testing.assert_allclose(got, want[3], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got, m.predict_proba(np.concatenate(
        [u8, np.zeros((1, HW, HW, 3), np.uint8)]))[:3])
    with pytest.raises(ValueError, match="largest exported bucket"):
        m.predict_proba(_u8(5))
    with pytest.raises(ValueError, match="exported artifacts take uint8 images"):
        m.predict_proba(u8.astype(np.float32))


def test_meta_keys_match_jax(artifact, tmp_path):
    """``meta.json`` carries the JAX package's keys; ``platforms`` names the
    device the programs were exported for."""
    from eelunet_tpu.config import ModelConfig as JaxModelConfig
    from eelunet_tpu.export import export_model as jax_export_model

    out, _ = artifact
    jout = jax_export_model(JaxModelConfig(name="unext_s"), None, (HW, HW), (1,),
                            str(tmp_path / "jax"), platforms=("cpu",))
    with open(os.path.join(jout, "meta.json")) as f:
        jmeta = json.load(f)
    meta = ExportedModel(out).meta
    assert sorted(meta) == sorted(jmeta)
    assert meta["model"] == "eelunet" and meta["image_size"] == [HW, HW]
    assert meta["batch_sizes"] == [2, 4] and meta["platforms"] == ["cpu"]
    assert meta["input"] == jmeta["input"] and meta["output"] == jmeta["output"]
    assert meta["quantize"] is None
    assert sorted(os.listdir(out)) == ["b2.pt2", "b4.pt2", "meta.json"]


def test_weights_are_baked_in(artifact, tmp_path):
    """Another checkpoint exports another function: the programs carry their
    weights, not an init convention."""
    out, want = artifact
    other = export_model(CFG, _slim_checkpoint(tmp_path / "slim1", seed=1), (HW, HW), (2,),
                         str(tmp_path / "art1"), device="cpu")
    assert not np.allclose(ExportedModel(other).predict_proba(_u8(2)), want[2], atol=1e-3)


def test_int8_artifact(tmp_path):
    """``quantize="int8"`` bakes the W8A8 model in: the artifact equals the
    int8 Predictor on the low-rank high-pass."""
    ckpt = _slim_checkpoint(tmp_path / "slim")
    out = export_model(CFG, ckpt, (HW, HW), (2,), str(tmp_path / "q"), quantize="int8",
                       device="cpu")
    pred = Predictor(LOWRANK, checkpoint=ckpt, bucket_batches=False, quantize="int8",
                     device="cpu")
    got = ExportedModel(out).predict_proba(_u8(2))
    np.testing.assert_allclose(got, pred.predict_proba(_u8(2)), atol=1e-5, rtol=0)
    assert ExportedModel(out).meta["quantize"] == "int8"
    assert pred.quant_stats["quantized_convs"] > 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serve_artifact_answers(artifact, tmp_path):
    """``python -m eelunet_tpu_torch.cli.serve --artifact DIR --device cpu``
    answers one .npy request with the artifact's probabilities; ``--quantize``
    with an artifact is refused, as in the JAX CLI."""
    out, want = artifact
    port = _free_port()
    log = open(tmp_path / "serve.log", "w")
    proc = subprocess.Popen([sys.executable, "-m", "eelunet_tpu_torch.cli.serve", "--artifact",
                             out, "--device", "cpu", "--port", str(port), "--window_ms", "1"],
                            cwd=_REPO, stdout=log, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        t0 = time.monotonic()
        while True:
            assert proc.poll() is None, open(tmp_path / "serve.log").read()
            try:
                with urllib.request.urlopen(base + "/v1/healthz", timeout=5) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                assert time.monotonic() - t0 < 120, "server did not come up"
                time.sleep(0.5)
        assert health["image_size"] == [HW, HW]
        buf = io.BytesIO()
        np.save(buf, _u8(2)[:1])
        req = urllib.request.Request(base + "/v1/predict", data=buf.getvalue(),
                                     headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=120) as r:
            got = np.load(io.BytesIO(r.read()))
        np.testing.assert_allclose(got, want[2][:1], atol=1e-5, rtol=0)
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        log.close()
    bad = subprocess.run([sys.executable, "-m", "eelunet_tpu_torch.cli.serve", "--artifact",
                          out, "--device", "cpu", "--quantize", "int8"], cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert bad.returncode == 2 and "--quantize applies when a model is built" in bad.stderr


def test_cli_serve_artifact_runs_only_on_the_asked_device(artifact, tmp_path, capsys):
    """``cli.serve --artifact`` serves on the device its ``--device`` asks
    for, never on another one the artifact names: an artifact exported for
    the card is refused under ``--device cpu``, naming both devices, and one
    exported for the CPU is not served under the default ``--device cuda``."""
    import torch

    from eelunet_tpu_torch.cli import serve as serve_cli

    out, _ = artifact
    forged = str(tmp_path / "art_cuda")
    shutil.copytree(out, forged)
    meta = json.load(open(os.path.join(forged, "meta.json")))
    meta["platforms"] = ["cuda"]
    json.dump(meta, open(os.path.join(forged, "meta.json"), "w"))
    with pytest.raises(SystemExit) as e:
        serve_cli.main(["--artifact", forged, "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "exported for 'cuda'" in err and "--device 'cpu'" in err
    if torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            serve_cli.main(["--artifact", out])
        assert "exported for 'cpu'" in capsys.readouterr().err
    else:
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            serve_cli.main(["--artifact", out])
