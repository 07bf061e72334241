"""The Canny stencil through the hand-written CUDA kernel
(counterpart of ``eelunet_tpu/ops/edge_pallas.py``; TPU kernel 5).

``csrc/canny.cu`` computes, per pixel of an (N,H,W,1) float32 image, in
shared memory and in float32: the separable 5-tap Gaussian blur (zero
padding), the Sobel gradients, and direction-quantised non-max suppression.
Two modes:

- ``zero``: ``_canny_kernel`` exactly, the fused form of ``ops/edge.canny_edge``.
  Sobel on the zero-padded blur, directions from |gy| against tan 22.5 and
  tan 67.5 times |gx| with the sign of gx*gy, comparisons on mag^2; the
  output is ``keep & (mag^2 >= low^2)`` as {0, 1}.
- ``improve``: the stencil stage of ``ops/edge.canny_edge_improve``. Sobel on
  the blur reflect-padded by one pixel, mag = sqrt(gx^2 + gy^2), the
  direction from atan2(gy, gx + 1e-6) in degrees, bucketed as
  ``non_max_suppression`` does; the output is the NMS magnitude
  ``mag * keep``.

The hysteresis behind mode ``improve`` runs in a second kernel of the same
source, ``hysteresis``: the double threshold of the NMS magnitude and the
fixpoint ``strong |= dilate(strong) & weak`` in one cooperative launch that
loops on a device flag (the counterpart of the JAX package's
``lax.while_loop``), writing the {0, 1} map in the caller's dtype. No host
read: the round count stays on the card.

``fused_canny`` and ``hysteresis`` launch their kernels on a CUDA tensor and
count each launch in ``LAUNCHES``; on a CPU tensor they run the plain twins
``fused_canny_reference``, which follows the kernel step by step with torch
ops (zero-fill shifts, no convolutions), and ``hysteresis_reference``, the
loop to the fixpoint. A CUDA tensor never takes a twin.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

MODES = {"zero": 0, "improve": 1}
# float32 images of up to 2**31 elements; the kernel indexes with int32.
_MAX_ELEMENTS = 2**31 - 1
_TAN22 = float(np.tan(np.deg2rad(22.5)))
_TAN67 = float(np.tan(np.deg2rad(67.5)))
ANGLE_EPS = 1e-6  # canny_edge_improve's atan2 stabiliser (ops/edge.py)

# Kernel launches since the last reset (twin calls are not launches).
LAUNCHES: Dict[str, int] = {"fused_canny": 0, "hysteresis": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def gaussian_kernel(kernel_size: int = 5, sigma: float = 1.0) -> np.ndarray:
    """Dense normalised 2D Gaussian as a numpy constant (reference
    tools.py:231-241; a copy of ``eelunet_tpu/ops/edge.gaussian_kernel``)."""
    ax = np.arange(kernel_size, dtype=np.float32) - (kernel_size - 1) / 2.0
    xx, yy = np.meshgrid(ax, ax, indexing="ij")
    k = np.exp(-(xx**2 + yy**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def g5(sigma: float) -> np.ndarray:
    """The 1D factor of the normalised 5x5 Gaussian, K = g g^T
    (``edge_pallas._g5``): g = K[2, :] / sqrt(K[2, 2])."""
    k2 = gaussian_kernel(5, sigma)
    return (k2[2, :] / np.sqrt(k2[2, 2])).astype(np.float32)


@functools.lru_cache(maxsize=64)
def taps(sigma: float) -> Tuple[float, ...]:
    """``g5(sigma)`` as Python floats, computed once per sigma: the kernel's
    arguments, so a launch does no numpy work."""
    return tuple(float(v) for v in g5(sigma))


# ------------------------------------------------------------ plain twin

def _shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[:, i, j] = a[:, i + dy, j + dx] with zero fill, |dy|, |dx| <= 2."""
    h, w = a.shape[1:]
    p = F.pad(a, (2, 2, 2, 2))
    return p[:, 2 + dy:2 + dy + h, 2 + dx:2 + dx + w]


def _blur(x: torch.Tensor, g) -> torch.Tensor:
    """Separable 5-tap blur, rows then columns, each a left-to-right sum of
    products with zero fill (``edge_pallas.py:90-91``)."""
    tmp = g[0] * _shift(x, -2, 0)
    for d in range(-1, 3):
        tmp = tmp + g[d + 2] * _shift(x, d, 0)
    blur = g[0] * _shift(tmp, 0, -2)
    for d in range(-1, 3):
        blur = blur + g[d + 2] * _shift(tmp, 0, d)
    return blur


def _sobel(blur: torch.Tensor, reflect: bool):
    """(gx, gy) of the blur padded by one pixel, with zeros (``zero``) or by
    reflection (``improve``): dx = b[j+1] - b[j-1], gx = dx[i-1] + 2 dx[i] +
    dx[i+1], and gy likewise across the other axis."""
    p = F.pad(blur[:, None], (1, 1, 1, 1), mode="reflect" if reflect else "constant")[:, 0]
    dx = p[:, :, 2:] - p[:, :, :-2]          # (N, H+2, W)
    dy = p[:, 2:, :] - p[:, :-2, :]          # (N, H, W+2)
    gx = dx[:, :-2] + 2.0 * dx[:, 1:-1] + dx[:, 2:]
    gy = dy[:, :, :-2] + 2.0 * dy[:, :, 1:-1] + dy[:, :, 2:]
    return gx, gy


def _nms_keep(m: torch.Tensor, b0, b45, b90, b135) -> torch.Tensor:
    """Non-max suppression on ``m`` (mag or mag^2), >= both neighbours along
    the bucketed direction, neighbours outside the image 0."""
    s = _shift
    return ((b0 & (m >= s(m, 0, -1)) & (m >= s(m, 0, 1)))
            | (b45 & (m >= s(m, -1, 1)) & (m >= s(m, 1, -1)))
            | (b90 & (m >= s(m, -1, 0)) & (m >= s(m, 1, 0)))
            | (b135 & (m >= s(m, -1, -1)) & (m >= s(m, 1, 1))))


def fused_canny_reference(x: torch.Tensor, low: float = 0.2, high: float = 0.8,
                          sigma: float = 1.0, mode: str = "zero") -> torch.Tensor:
    """The kernel's math with torch ops: (N,H,W,1) float -> (N,H,W,1) float32
    ({0, 1} in mode ``zero``, the NMS magnitude in mode ``improve``). ``high``
    is unused: ``canny_edge`` keeps weak edges, and ``improve`` thresholds
    outside."""
    _check_mode(mode)
    img = x[..., 0].float()
    g = taps(float(sigma))
    blur = _blur(img, g)
    gx, gy = _sobel(blur, reflect=mode == "improve")
    if mode == "zero":
        mag2 = gx * gx + gy * gy
        ax, ay = gx.abs(), gy.abs()
        b0 = ay < _TAN22 * ax
        b90 = ay >= _TAN67 * ax
        mid = ~b0 & ~b90
        same = gx * gy > 0.0
        keep = _nms_keep(mag2, b0, mid & same, b90, mid & ~same)
        return (keep & (mag2 >= float(low) ** 2)).float()[..., None]
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gy, gx + ANGLE_EPS) * (180.0 / np.pi)
    ang = torch.where(ang < 0, ang + 180.0, ang)
    # non_max_suppression takes the angle mod 180 first; that maps only
    # [180, 360) into bucket 0, which ang >= 157.5 already selects.
    b0 = (ang < 22.5) | (ang >= 157.5)
    b45 = (ang >= 22.5) & (ang < 67.5)
    b90 = (ang >= 67.5) & (ang < 112.5)
    b135 = (ang >= 112.5) & (ang < 157.5)
    return (mag * _nms_keep(mag, b0, b45, b90, b135).float())[..., None]


def _dilate(s: torch.Tensor) -> torch.Tensor:
    """3x3 binary dilation of an NHWC bool map, zero outside the image."""
    x = s.permute(0, 3, 1, 2).to(torch.float32)
    return F.max_pool2d(x, 3, stride=1, padding=1).permute(0, 2, 3, 1) > 0


def hysteresis_fixpoint(strong: torch.Tensor, weak: torch.Tensor, max_iters: int = 0):
    """``strong |= dilate(strong) & weak`` on NHWC bool maps until nothing
    changes, or for at most ``max_iters`` steps when that is > 0. Returns
    (the grown bool map, the number of steps applied). Each step reads one
    flag back to the host."""
    s, it = strong, 0
    while max_iters <= 0 or it < max_iters:
        nxt = s | (_dilate(s) & weak)
        if torch.equal(nxt, s):
            break
        s, it = nxt, it + 1
    return s, it


def _thresholds(nms: torch.Tensor, low: float, high: float):
    """(strong, weak) = (nms >= high, low <= nms < high)."""
    return nms >= high, (nms >= low) & (nms < high)


def hysteresis_reference(nms: torch.Tensor, low: float, high: float,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The hysteresis kernel's math with torch ops on an NHWC NMS magnitude:
    strong = nms >= high, weak = low <= nms < high, grown to the fixpoint;
    {0, 1} in ``dtype``."""
    return hysteresis_fixpoint(*_thresholds(nms, low, high))[0].to(dtype)


# ----------------------------------------------------------------- wrapper

def _check_mode(mode: str) -> int:
    if mode not in MODES:
        raise ValueError(f"fused_canny: mode {mode!r} not in {sorted(MODES)}")
    return MODES[mode]


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURE = [_I, _P, _P, _I, _I, _I] + [_F] * 6 + [_P]
_HYST_SIGNATURE = [_I, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P]
SOURCES = ("canny",)  # the csrc/<name>.cu files this wrapper launches
# The dtypes the hysteresis kernel writes; others are written as float32
# and converted.
_EDGE_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _lib():
    from eelunet_tpu_torch.ops._build import load

    lib = load("canny")
    if not getattr(lib, "_eelunet_typed", False):
        lib.eelunet_fused_canny.argtypes = _SIGNATURE
        lib.eelunet_fused_canny.restype = _I
        lib.eelunet_hysteresis.argtypes = _HYST_SIGNATURE
        lib.eelunet_hysteresis.restype = _I
        lib._eelunet_typed = True
    return lib


def fused_canny(x: torch.Tensor, low: float = 0.2, high: float = 0.8, sigma: float = 1.0,
                mode: str = "zero") -> torch.Tensor:
    """Kernel 5 on (N,H,W,1) float32 ``x``: returns (N,H,W,1) float32, the
    {0, 1} edges (``zero``) or the NMS magnitude (``improve``). A CPU tensor
    runs ``fused_canny_reference``."""
    code = _check_mode(mode)
    if x.dim() != 4 or x.shape[-1] != 1:
        raise ValueError(f"fused_canny: x must be (N,H,W,1), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_canny_reference(x, low, high, sigma, mode)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"fused_canny: x must be contiguous float32, got {x.dtype} "
                         f"strides {x.stride()}")
    n, h, w, _ = x.shape
    if x.numel() > _MAX_ELEMENTS:
        raise ValueError(f"fused_canny: {x.numel()} elements exceed the kernel's int32 extents")
    if mode == "improve" and min(h, w) < 2:
        raise ValueError(f"fused_canny: mode 'improve' reflects one pixel and needs H, W >= 2, "
                         f"got {h}x{w}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):  # launch on the operand's card
        err = _lib().eelunet_fused_canny(
            code, x.data_ptr(), out.data_ptr(), n, h, w, *taps(float(sigma)),
            float(low) ** 2, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_canny: CUDA launch failed with cudaError_t {err}")
    LAUNCHES["fused_canny"] += 1
    return out


def hysteresis(nms: torch.Tensor, low: float, high: float,
               dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hysteresis kernel on an (N,H,W,1) float32 NMS magnitude: strong =
    nms >= high, weak = low <= nms < high, grown to the fixpoint. Returns
    ((N,H,W,1) {0, 1} in ``dtype``, a device int32 scalar tensor holding the
    rounds the kernel ran; nothing is read back). A CPU tensor runs
    ``hysteresis_reference`` and returns the plain loop's step count. A
    cooperative launch the card refuses raises."""
    if nms.dim() != 4 or nms.shape[-1] != 1:
        raise ValueError(f"hysteresis: nms must be (N,H,W,1), got {tuple(nms.shape)}")
    if nms.device.type == "cpu":
        grown, steps = hysteresis_fixpoint(*_thresholds(nms, low, high))
        return grown.to(dtype), torch.tensor(steps, dtype=torch.int32)
    if nms.dtype != torch.float32 or not nms.is_contiguous():
        raise ValueError(f"hysteresis: nms must be contiguous float32, got {nms.dtype} "
                         f"strides {nms.stride()}")
    if nms.numel() > _MAX_ELEMENTS:
        raise ValueError(f"hysteresis: {nms.numel()} elements exceed the kernel's int32 extents")
    n, h, w, _ = nms.shape
    code = _EDGE_DTYPE.get(dtype, 0)
    out = torch.empty(nms.shape, dtype=dtype if dtype in _EDGE_DTYPE else torch.float32,
                      device=nms.device)
    flags = torch.empty(4, dtype=torch.int32, device=nms.device)
    if nms.numel() == 0:
        return out.to(dtype), flags[3].zero_()
    state = torch.empty(nms.shape, dtype=torch.uint8, device=nms.device)
    with torch.cuda.device(nms.device):  # launch on the operand's card
        err = _lib().eelunet_hysteresis(
            code, nms.data_ptr(), state.data_ptr(), out.data_ptr(), flags.data_ptr(), n, h, w,
            float(low), float(high), torch.cuda.current_stream(nms.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hysteresis: CUDA launch failed with cudaError_t {err}")
    LAUNCHES["hysteresis"] += 1
    return out.to(dtype), flags[3]
