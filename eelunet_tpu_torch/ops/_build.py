"""Build the CUDA sources under ``csrc/`` with ``nvcc`` at first use and load
them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles into its own
shared library, ``build/lib<name>-<hash>.so`` inside this package (listed in
``.gitignore``). The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header builds anew
and an unchanged one loads what is there. Any build or
load error raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path(name: str) -> Path:
    src = SRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(SRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists. Returns
    (library path, seconds spent compiling, nvcc's output with ptxas'
    register and spill report; empty when nothing was compiled)."""
    out = library_path(name)
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a private name, then rename: another process building the
    # same source never sees a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) for {name}.cu:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, time.perf_counter() - t0, proc.stdout + proc.stderr


def build_all(names: Sequence[str]) -> Dict[str, Tuple[Path, float, str]]:
    """``build`` for several sources at once: one nvcc per source, all
    started together. Returns each name's ``build`` result; raises the first
    failure after every compile has ended."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = {n: pool.submit(build, n) for n in names}
        return {n: f.result() for n, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _libs:
            path, _, _ = build(name)
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


def configured_on(name: str, device: int) -> int:
    """How many kernels of ``csrc/<name>.cu`` have had their dynamic
    shared-memory attribute set on card ``device`` in this process (the
    attribute belongs to the card; ``csrc/device_once.cuh``)."""
    fn = getattr(load(name), f"eelunet_{name}_configured")
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return int(fn(device))
