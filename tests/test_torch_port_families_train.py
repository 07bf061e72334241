"""Paired train steps, the JAX package's and the port's, from the same
weights on the same batches, for U-Net, U-Net++, UNeXt and UNeXt-S, each on
its ``auto`` loss (``bce_dice`` on the sigmoid of the logits), float32 on
the CPU, 64x64, batch 2, Adam at 1e-4 (tests/torch_port_families.py).

The bounds are those of tests/test_step_parity.py:84-116 for the small
families: the first loss within 1e-5, the trajectory within 1e-3 relative,
every parameter within 8 lr steps, the BN statistics within 1e-3. EGE-UNet
and MALUNet are in tests/test_torch_port_families_train_attn.py, so that
the two files run side by side."""

from __future__ import annotations

import numpy as np
import pytest

from eelunet_tpu_torch.models.convert import from_flax_variables
from torch_port_families import LR, family_input, family_labels, family_variables, paired_family_steps

# Six steps for the published-width families; fewer for the narrow U-Nets,
# whose JAX steps take longer to compile.
CASES = [("unext", 6), ("unext_s", 6), ("unet", 3), ("unet++", 3)]


def check_paired_steps(name: str, steps: int) -> None:
    batches = [(family_input(seed=i), family_labels(seed=i)) for i in range(steps)]
    variables = family_variables(name)
    start = from_flax_variables(variables, name)
    loss_j, loss_t, want, got = paired_family_steps(name, variables, batches)
    d = np.abs(loss_j - loss_t)
    assert np.all(np.isfinite(loss_t)) and d[0] < 1e-5, (loss_j, loss_t)
    assert float((d / np.abs(loss_j)).max()) < 1e-3, (loss_j, loss_t)
    assert want.keys() == got.keys()
    params = [k for k in want if not k.endswith(("running_mean", "running_var",
                                                 "num_batches_tracked"))]
    worst = max(float((want[k] - got[k]).abs().max()) for k in params)
    assert worst < 8 * LR * steps, worst
    # and the parameters did move: a skipped update would stand still
    moved = max(float((got[k] - start[k]).abs().max()) for k in params)
    assert moved > LR / 2, moved
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    if stats:
        worst_bs = max(float((want[k] - got[k]).abs().max()) for k in stats)
        assert worst_bs < 1e-3, worst_bs


@pytest.mark.parametrize("name,steps", CASES)
def test_paired_train_steps(name, steps):
    check_paired_steps(name, steps)
