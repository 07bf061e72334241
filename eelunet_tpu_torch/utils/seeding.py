"""Seeding (counterpart of ``eelunet_tpu/utils/seeding.py``; reference
set_seed, train.py:24-33).

The port draws its randomness from explicit ``torch.Generator``s (weight
init, the step-keyed flips); this seeds the host's numpy RNG and torch's
global generator for anything else, and returns the seed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def set_seed(seed: Optional[int] = None) -> int:
    if seed is None:
        seed = int(np.random.randint(0, 10000))
        print(f"Using seed: {seed}")
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed
