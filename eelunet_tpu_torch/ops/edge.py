"""Canny/Sobel edge toolbox on NHWC batches (counterpart of
``eelunet_tpu/ops/edge.py``; reference utils/tools.py:126-419).

On a CPU tensor every function is the plain counterpart of the JAX
package's XLA function: depthwise convolutions with the same padding,
neighbour tensors by zero pad and slice, and hysteresis as a loop to a
fixpoint. On a CUDA tensor ``canny_edge`` launches TPU kernel 5
(``ops/edge_cuda.fused_canny``, mode ``zero``) for its whole chain, and
``canny_edge_improve`` launches it in mode ``improve`` for the blur, Sobel
and non-max-suppression stage, then the hysteresis kernel
(``ops/edge_cuda.hysteresis``) for the double threshold and the fixpoint,
with no read back to the host, as the JAX package keeps its
``lax.while_loop`` on the device.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from eelunet_tpu_torch.ops import edge_cuda
from eelunet_tpu_torch.ops.edge_cuda import (ANGLE_EPS, _dilate, gaussian_kernel,
                                             hysteresis_fixpoint)

def rgb_to_grayscale(batch: torch.Tensor) -> torch.Tensor:
    """0.299 R + 0.587 G + 0.114 B; (N,H,W,3) -> (N,H,W,1) (tools.py:212-228)."""
    r, g, b = batch[..., 0:1], batch[..., 1:2], batch[..., 2:3]
    return 0.299 * r + 0.587 * g + 0.114 * b


def _depthwise_conv(img: torch.Tensor, kernel2d: np.ndarray, pad: int) -> torch.Tensor:
    """Depthwise correlation of NHWC ``img`` with one shared 2D kernel."""
    c = img.shape[-1]
    k = torch.as_tensor(kernel2d, dtype=img.dtype, device=img.device)
    weight = k[None, None].expand(c, 1, *k.shape)
    out = F.conv2d(img.permute(0, 3, 1, 2), weight, padding=pad, groups=c)
    return out.permute(0, 2, 3, 1)


def gaussian_blur(img: torch.Tensor, kernel_size: int = 5, sigma: float = 1.0) -> torch.Tensor:
    """Gaussian smoothing, zero padding (tools.py:244-253)."""
    return _depthwise_conv(img, gaussian_kernel(kernel_size, sigma), kernel_size // 2)


_SOBEL_X = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], np.float32)
_SOBEL_Y = np.array([[-1.0, -2.0, -1.0], [0.0, 0.0, 0.0], [1.0, 2.0, 1.0]], np.float32)


def sobel_gradients(img: torch.Tensor, reflect_pad: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sobel x/y gradients (tools.py:256-268). ``reflect_pad`` matches the
    improved variant's border handling (tools.py:379)."""
    pad = 1
    if reflect_pad:
        img = F.pad(img.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1)
        pad = 0
    return _depthwise_conv(img, _SOBEL_X, pad), _depthwise_conv(img, _SOBEL_Y, pad)


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Neighbour tensor by zero pad + slice (tools.py:294-301):
    out[:, i, j] = x[:, i - dy, j - dx]."""
    h, w = x.shape[1], x.shape[2]
    p = F.pad(x, (0, 0, max(dx, 0), max(-dx, 0), max(dy, 0), max(-dy, 0)))
    y0, x0 = max(-dy, 0), max(-dx, 0)
    return p[:, y0:y0 + h, x0:x0 + w, :]


def non_max_suppression(grad_magnitude: torch.Tensor, grad_angle: torch.Tensor) -> torch.Tensor:
    """Directional non-max suppression (tools.py:271-316): angles in degrees
    quantised to {0, 45, 90, 135}; a pixel survives iff it is >= both
    neighbours along its direction, neighbours outside the image 0."""
    angle = torch.remainder(grad_angle, 180.0)
    mag = grad_magnitude
    mask0 = (angle < 22.5) | (angle >= 157.5)
    mask45 = (angle >= 22.5) & (angle < 67.5)
    mask90 = (angle >= 67.5) & (angle < 112.5)
    mask135 = (angle >= 112.5) & (angle < 157.5)
    cond = ((mask0 & (mag >= _shift(mag, 0, 1)) & (mag >= _shift(mag, 0, -1)))
            | (mask45 & (mag >= _shift(mag, 1, -1)) & (mag >= _shift(mag, -1, 1)))
            | (mask90 & (mag >= _shift(mag, 1, 0)) & (mag >= _shift(mag, -1, 0)))
            | (mask135 & (mag >= _shift(mag, 1, 1)) & (mag >= _shift(mag, -1, -1))))
    return mag * cond.to(mag.dtype)


def _grad_mag_angle(img: torch.Tensor, reflect_pad: bool, angle_eps: float):
    gx, gy = sobel_gradients(img, reflect_pad=reflect_pad)
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gy, gx + angle_eps) * (180.0 / math.pi)
    return mag, torch.where(ang < 0, ang + 180.0, ang)


def _check_kernel_size(fn: str, x: torch.Tensor, gaussian_kernel_size: int) -> None:
    if x.device.type != "cpu" and gaussian_kernel_size != 5:
        raise ValueError(f"{fn}: the Canny kernel blurs with 5 taps; "
                         f"gaussian_kernel_size={gaussian_kernel_size} is not supported on "
                         f"{x.device}")


def _planes(x: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor as contiguous float32 (N*C, H, W, 1) planes: the
    channels ride the batch axis of the kernels."""
    n, h, w, c = x.shape
    return x.float().permute(0, 3, 1, 2).reshape(n * c, h, w, 1).contiguous()


def _nhwc(planes: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(N*C, H, W, 1) planes back to the NHWC layout of ``like``."""
    n, h, w, c = like.shape
    return planes.view(n, c, h, w).permute(0, 2, 3, 1)


def _fused(x: torch.Tensor, **kw) -> torch.Tensor:
    """Kernel 5 on every channel of an NHWC tensor, float32 out."""
    return _nhwc(edge_cuda.fused_canny(_planes(x), **kw), x)


def canny_edge(binary_mask: torch.Tensor, low_threshold: float = 0.2,
               high_threshold: float = 0.8, gaussian_kernel_size: int = 5,
               gaussian_sigma: float = 1.0) -> torch.Tensor:
    """Canny without hysteresis, weak edges kept (canny_edge_torch,
    tools.py:319-355): (N,H,W,1) -> {0, 1} in the input's dtype. A CUDA
    tensor runs kernel 5 in mode ``zero``."""
    if binary_mask.device.type != "cpu":
        _check_kernel_size("canny_edge", binary_mask, gaussian_kernel_size)
        edges = _fused(binary_mask, low=low_threshold, high=high_threshold,
                       sigma=gaussian_sigma, mode="zero")
        return edges.to(binary_mask.dtype)
    blurred = gaussian_blur(binary_mask, gaussian_kernel_size, gaussian_sigma)
    nms = non_max_suppression(*_grad_mag_angle(blurred, reflect_pad=False, angle_eps=0.0))
    return (nms >= low_threshold).to(binary_mask.dtype)


def hysteresis_thresholding(strong: torch.Tensor, weak: torch.Tensor,
                            max_iters: int = 0) -> torch.Tensor:
    """Connect weak edges 8-connected to strong ones, to a fixpoint
    (the textbook recurrence the JAX package runs as a ``while_loop``;
    tools.py:402-419 floods instead, see ``eelunet_tpu/ops/edge.py``).
    ``max_iters`` > 0 caps the steps. Returns the strong map's dtype.

    On a CUDA tensor nothing is read back to the host: to the fixpoint, the
    hysteresis kernel runs on the map 2 strong + (weak and not strong)
    thresholded at 1 and 2 (the same recurrence, since a strong pixel is
    already grown); with a cap, exactly ``max_iters`` plain steps run, as a
    step at the fixpoint changes nothing."""
    s, wk = strong > 0.5, weak > 0.5
    if strong.device.type == "cpu":
        return hysteresis_fixpoint(s, wk, max_iters)[0].to(strong.dtype)
    if max_iters > 0:
        for _ in range(max_iters):
            s = s | (_dilate(s) & wk)
        return s.to(strong.dtype)
    levels = 2.0 * s.float() + (wk & ~s).float()
    edges, _ = edge_cuda.hysteresis(_planes(levels), 1.0, 2.0, strong.dtype)
    return _nhwc(edges, strong)


def _improve_nms(binary_mask: torch.Tensor, gaussian_kernel_size: int,
                 gaussian_sigma: float) -> torch.Tensor:
    """The NMS magnitude of ``canny_edge_improve``'s plain chain (the
    counterpart of kernel 5 in mode ``improve``)."""
    blurred = gaussian_blur(binary_mask, gaussian_kernel_size, gaussian_sigma)
    return non_max_suppression(*_grad_mag_angle(blurred, reflect_pad=True,
                                                angle_eps=ANGLE_EPS))


def canny_edge_improve(binary_mask: torch.Tensor, low_threshold: float = 0.2,
                       high_threshold: float = 0.7, gaussian_kernel_size: int = 5,
                       gaussian_sigma: float = 1.0) -> torch.Tensor:
    """Canny with reflect padding, a stabilised atan2 and hysteresis
    (canny_edge_torch_improve, tools.py:358-399): (N,H,W,1) -> {0, 1} in
    the input's dtype. A CUDA tensor runs kernel 5 (mode ``improve``), then
    the hysteresis kernel, and reads nothing back to the host."""
    if binary_mask.device.type != "cpu":
        _check_kernel_size("canny_edge_improve", binary_mask, gaussian_kernel_size)
        nms = edge_cuda.fused_canny(_planes(binary_mask), sigma=gaussian_sigma, mode="improve")
        edges, _ = edge_cuda.hysteresis(nms, low_threshold, high_threshold, binary_mask.dtype)
        return _nhwc(edges, binary_mask)
    nms = _improve_nms(binary_mask, gaussian_kernel_size, gaussian_sigma)
    return edge_cuda.hysteresis_reference(nms, low_threshold, high_threshold, binary_mask.dtype)


def generate_edge_label(gt: torch.Tensor) -> torch.Tensor:
    """Edge labels from binary masks on the device (tools.py:126-155): the
    improved Canny at cv2's 100/200 thresholds on a 0-255 scale."""
    return canny_edge_improve(gt.float(), 100.0 / 255.0, 200.0 / 255.0)
