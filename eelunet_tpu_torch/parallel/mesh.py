"""The device mesh (counterpart of ``eelunet_tpu/parallel/mesh.py``).

A ``Mesh`` lays devices out as (data, model, spatial), with JAX's axis
arithmetic and errors. It is a plain record, not a
``torch.distributed.DeviceMesh``, which needs a process group that the
single-process Predictor does not have:

- in one process, the ``data`` axis spans that process's devices: the
  multi-device Predictor runs one replica on each (``inference.py``);
- under a process group (``distributed.init_distributed``), it spans the
  ranks, one device each, and the grid holds rank numbers: the Trainer
  runs DDP over them (``train/trainer.py``).

Only the ``data`` axis is ported. ``model`` (tensor parallelism) and
``spatial`` (H-sharding) raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

AXES = ("data", "model", "spatial")
NOT_PORTED_AXES = ("mesh.model_axis > 1 (tensor parallelism) and mesh.spatial_axis > 1 "
                   "(H-sharding) are not ported to eelunet_tpu_torch yet: they are the next "
                   "slice of the port (ROADMAP.md §1, 'The model and spatial mesh axes')")


class Mesh:
    """``devices``: an object array of shape (data, model, spatial) holding
    torch devices (one process) or rank numbers (a process group)."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.axis_names = AXES
        self.shape: Dict[str, int] = dict(zip(AXES, devices.shape))

    @property
    def data_devices(self) -> List[torch.device]:
        """The devices of the data axis, in order (one process)."""
        return [torch.device(d) for d in self.devices[:, 0, 0]]


def default_devices() -> list:
    """Every rank under a process group, else every card of this process,
    else the CPU."""
    import torch.distributed as dist

    if dist.is_initialized():
        return list(range(dist.get_world_size()))
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def create_mesh(data_axis: int = -1, model_axis: int = 1, spatial_axis: int = 1,
                devices=None) -> Mesh:
    """A (data, model, spatial) mesh; ``data_axis=-1`` takes every device
    left. ``devices``: torch devices (or device strings), one per slot; a
    device may be listed more than once. Raises JAX's ``ValueError`` when
    the axes do not fit the devices, and ``NotImplementedError`` for a
    ``model`` or ``spatial`` axis above 1."""
    devices = list(devices) if devices is not None else default_devices()
    n = len(devices)
    model_axis = max(model_axis, 1)
    spatial_axis = max(spatial_axis, 1)
    per_replica = model_axis * spatial_axis
    if data_axis == -1:
        if n % per_replica != 0:
            raise ValueError(
                f"{n} devices not divisible by model_axis*spatial_axis={per_replica}")
        data_axis = n // per_replica
    if data_axis * per_replica > n:
        raise ValueError(f"mesh {data_axis}x{model_axis}x{spatial_axis} needs more than {n} "
                         "devices")
    if per_replica > 1:
        raise NotImplementedError(NOT_PORTED_AXES)
    grid = np.empty(data_axis, dtype=object)
    grid[:] = [d if isinstance(d, int) else torch.device(d) for d in devices[:data_axis]]
    return Mesh(grid.reshape(data_axis, 1, 1))


def spatial_size(mesh: Mesh) -> int:
    return mesh.shape["spatial"] if "spatial" in mesh.axis_names else 1
