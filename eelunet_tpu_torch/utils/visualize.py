"""Offline feature-map and image visualization (counterpart of
``eelunet_tpu/utils/visualize.py``; reference utils/tools.py:12-123).

The reference writes PNGs from inside ``EELUnet.forward`` on every pass
(EELUnet.py:389-462). Here they are written offline, from module outputs
captured with forward hooks (``cli/visualize.py``), at no cost in the hot
loop:

    save_feature_grid(captured["enc1"][0], "enc1.png")

Feature maps are the port's (B,C,H,W) or (C,H,W) tensors or arrays, tiled
channel by channel. matplotlib is used when present, else PIL.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def _to_numpy(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a)


def _to_grid(fm, num_cols: int = 8, max_maps: int = 64) -> np.ndarray:
    """(C,H,W) or (1,C,H,W) feature maps -> tiled grayscale grid, each
    channel scaled to [0, 1] on its own."""
    fm = _to_numpy(fm)
    if fm.ndim == 4:
        fm = fm[0]
    c, h, w = fm.shape
    c = min(c, max_maps)
    rows = math.ceil(c / num_cols)
    grid = np.zeros((rows * h, num_cols * w), np.float32)
    for i in range(c):
        ch = fm[i]
        lo, hi = ch.min(), ch.max()
        ch = (ch - lo) / (hi - lo + 1e-8)
        r, col = divmod(i, num_cols)
        grid[r * h : (r + 1) * h, col * w : (col + 1) * w] = ch
    return grid


def save_feature_grid(fm, save_path: str, num_cols: int = 8, title: Optional[str] = None):
    """Save a channel grid PNG of a feature map (tools.py:12-75 equivalent)."""
    grid = _to_grid(fm, num_cols)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(10, 10 * grid.shape[0] / max(grid.shape[1], 1)))
        plt.imshow(grid, cmap="viridis")
        if title:
            plt.title(title)
        plt.axis("off")
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    except ImportError:
        from PIL import Image

        Image.fromarray((grid * 255).astype(np.uint8), mode="L").save(save_path)


def save_image(img, save_path: str):
    """Save an (H,W,C) or (H,W) image in [0,1] (or uint8) as PNG
    (tools.py:158-209)."""
    from PIL import Image

    arr = _to_numpy(img)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if np.issubdtype(arr.dtype, np.floating):
        if arr.max() > 1.0:
            arr = arr / 255.0
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    mode = "L" if arr.ndim == 2 else "RGB"
    Image.fromarray(arr, mode=mode).save(save_path)


def edge_seg_contribution(seg_out, edge_out) -> dict:
    """Diagnostic: which branch wins max(seg, edge) per pixel
    (calculate_contribution, tools.py:422-470); percentages, so the layout
    of the two same-shaped arrays does not matter."""
    seg_out = _to_numpy(seg_out)
    edge_out = _to_numpy(edge_out)
    if seg_out.shape != edge_out.shape:
        raise ValueError(f"shape mismatch: {seg_out.shape} vs {edge_out.shape}")
    mx = np.maximum(seg_out, edge_out)
    total = seg_out.size
    seg_n = float((seg_out == mx).sum())
    edge_n = float((edge_out == mx).sum())
    eq_n = float((seg_out == edge_out).sum())
    overlap = max(seg_n + edge_n - total, 0.0)
    seg_n -= overlap / 2
    edge_n -= overlap / 2
    return {
        "seg_out_contribution": 100.0 * seg_n / total,
        "edge_out_contribution": 100.0 * edge_n / total,
        "equal_elements": 100.0 * eq_n / total,
    }
