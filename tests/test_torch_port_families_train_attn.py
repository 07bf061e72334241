"""Paired train steps, the JAX package's and the port's, for EGE-UNet
(``gt_bce_dice`` over its five full-resolution aux maps, live BN in
``Down`` and ``ConvLayer``, GHPA's resized parameter maps) and MALUNet
(``bce_dice``, external attention and the attention bridge): six steps
each, with the bounds of tests/test_step_parity.py:84-116 (see
tests/test_torch_port_families_train.py)."""

from __future__ import annotations

import pytest

from test_torch_port_families_train import check_paired_steps


@pytest.mark.parametrize("name", ["egeunet", "malunet"])
def test_paired_train_steps(name):
    check_paired_steps(name, 6)
