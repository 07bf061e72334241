"""The port never imports JAX: a fresh interpreter imports every module of
``eelunet_tpu_torch`` and finds no jax, flax, orbax or eelunet_tpu module
loaded."""

from __future__ import annotations

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import eelunet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(eelunet_tpu_torch.__path__, "eelunet_tpu_torch.")]
for n in names:
    importlib.import_module(n)
banned = ("jax", "jaxlib", "flax", "orbax", "eelunet_tpu")
bad = sorted(m for m in sys.modules if m.split(".")[0] in banned)
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=_REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    # every module of the serving, training and Canny slices, the families,
    # cli.predict, cli.pack, the packed and device-cached feeds, the
    # profiler, prune, prune_physical, quantize, export, cli.prune and
    # cli.export, parallel/ (the package, distributed and mesh), and
    # utils/summary, utils/flops, utils/visualize, cli.visualize and
    # cli.export_torch
    assert n_modules >= 63, proc.stdout
